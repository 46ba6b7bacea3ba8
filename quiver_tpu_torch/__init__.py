"""quiver_tpu_torch: the PyTorch and CUDA port of ``quiver_tpu``.

A package of its own beside the JAX one, laid out like it (``ops/``,
``ops/kernels/``, ``models/``, ``parallel/``, ``utils/``, ``pyg/``,
``serving.py``). It imports neither JAX nor ``quiver_tpu``. Entry points
put their tensors on the card unless the caller passes ``device="cpu"``;
the TPU kernels, which the serve and train steps run through the fused
walk, are CUDA kernels for Hopper (``csrc/``), built at first use. The
train steps are in ``parallel`` (``build_train_step``). ``Feature`` is
the tiered store: its hot tier on the card, its cold tier in pinned host
memory that the card's row gather reads; ``ShardTensor`` is the
reference's row store over a device group and a pinned host group.
``GraphSageSampler`` samples k-hop neighbourhoods with the topology on
the card (HBM mode), pinned in host memory (HOST mode), read by the
card's gathers, or on the host by the native C++ engine (CPU mode,
``native/``); ``MixedGraphSageSampler`` shares a job's batches between
the card and the engine. ``pipeline`` stages work on a worker thread
(``Feature.prefetch``, ``async_sampler.sample_ahead``); ``inference``,
``checkpoint`` and ``datasets`` are the evaluation, resume and data
helpers. ``HeteroCSRTopo``, ``HeteroGraphSageSampler`` and
``HeteroFeature`` are the typed-graph path (one topology, sampler draw
and tiered store per relation or node type), which ``models.RGCN`` and
``models.MAG240MGNN`` consume. ``metrics`` holds the device counters the metered steps,
lookups and samplers return (``collect_metrics=True``) and their host
side (``StepStats``, ``MetricsSink``, ``SloBudget``). ``MicroBatchServer``
is the request path over a ``ServeEngine`` (admission, coalescing,
quality and load shedding, tenancy, health), and ``rpc`` its socket
front end (``RpcServer``) and client (``RpcClient``). Across ranks of a
``torch.distributed`` process group (``comm.init_distributed``),
``DistFeature`` partitions the table by a ``PartitionInfo``
(``partition.py``'s partitioners and artifacts) and looks rows up by the
``all_to_all`` exchange of ``comm.py`` (``TorchComm``);
``ShardedServeEngine`` serves over it, and ``parallel`` holds the
multi-host (``build_dist_train_step``) and data-parallel
(``build_e2e_train_step``) train steps. In one process over several
cards, ``Feature(cache_policy="p2p_clique_replicate", mesh=...)``
row-shards its hot tier over a clique (``parallel.make_mesh``;
``Topo``/``init_p2p`` find the cliques and enable peer access) and reads
it with one gather kernel; ``ShardTensor`` spans cards and pinned host
memory the same way; ``multiprocessing`` sends stores to
``torch.multiprocessing`` workers by CUDA IPC and shared memory; and
``parallel.build_gspmd_train_step`` is the data x model (DTensor)
step. Around the request path runs the fleet's control plane:
``traffic`` replays seeded multi-tenant scenarios against a server or a
client, ``TelemetryHub`` watches the counters and series (``telemetry``),
``TailSampler`` keeps the traces that matter (``tailsampling``),
``fleet`` aggregates replica processes' sinks behind a ``HealthRouter``
under a ``ReplicaSupervisor``, ``Actuator`` swaps knobs and rotates the
hot set (``actuator``), and ``capacity`` predicts what a fleet sustains.
``analysis`` verifies the performance contract of every registered
entry point (``python -m quiver_tpu_torch.analysis``), ``profile``
attributes each stage's time against the machine's probed rates
(``StageProfiler``, ``machine_probe``; ``python -m
quiver_tpu_torch.profile``) and ``profiling`` holds the scopes, the
trace and the ``hot_path`` marker.
"""

__version__ = "0.1.0"

import importlib

# each exported name and the submodule that defines it: imported on
# first use (PEP 562), so that a light entry point such as
# ``python -m quiver_tpu_torch.scripts.qt_top`` loads neither torch nor
# the kernels
_EXPORTS = {
    "actuator": ("Actuator", "FleetAutoscaler", "Knob"),
    "async_sampler": ("AsyncCudaNeighborSampler", "AsyncNeighborSampler",
                      "sample_ahead"),
    "comm": ("HostRankTable", "TorchComm", "get_comm_id",
             "init_distributed"),
    "datasets": ("GraphDataset", "from_numpy_dir", "generate_drifting_trace",
                 "generate_synthetic_cold_dataset",
                 "load_synthetic_cold_dataset"),
    "debug": ("show_tensor_info",),
    "faults": ("FaultPlan", "FaultRule"),
    "feature": ("DeviceConfig", "DistFeature", "ExchangeCapPlan", "Feature",
                "PartitionInfo"),
    "fleet": ("FleetAggregator", "FleetExporter", "HealthRouter",
              "ReplicaSupervisor", "health_score"),
    "hetero": ("HeteroCSRTopo", "HeteroGraphSageSampler"),
    "hetero_feature": ("HeteroFeature",),
    "inference": ("layerwise_inference",),
    "io": ("ExtentReader", "StorageModel", "plan_extents"),
    "metrics": ("Collector", "MetricsSink", "SloBudget", "StepStats",
                "pmerge_counters"),
    "models": ("GAT", "GraphSAGE"),
    "ops.quant": ("QuantizedTensor", "plan_hot_capacity", "quantize"),
    "parallel": ("build_dist_train_step", "build_e2e_train_step"),
    "partition": ("load_disk_tier", "load_disk_tier_store",
                  "load_partition_info", "load_quantized_feature_partition",
                  "load_quiver_feature_partition",
                  "partition_feature_without_replication",
                  "quiver_partition_feature", "save_disk_tier",
                  "save_partition_info", "save_quantized_feature_partition"),
    "pipeline": ("Pipeline", "pipelined"),
    "prefetch": ("ColdPrefetcher", "StagingRing"),
    "profile": ("StageProfiler", "machine_probe"),
    "pyg": ("GraphSageSampler", "MixedGraphSageSampler", "SampleJob"),
    "rpc": ("DeadlineExceeded", "RpcClient", "RpcError", "RpcServer",
            "ServerClosed"),
    "serving": ("MicroBatchServer", "OverloadError", "ServeConfig",
                "ServeEngine", "ShardedServeEngine", "TenantClass",
                "build_serve_step", "build_sharded_serve_step",
                "default_tenant_classes"),
    "shard_tensor": ("ShardTensor", "ShardTensorConfig"),
    "tailsampling": ("TailSampler", "TraceStore"),
    "telemetry": ("FlightRecorder", "PlanContext", "TelemetryHub"),
    "traffic": ("generate_scenario", "replay"),
    "utils": ("CSRTopo", "parse_size", "reindex_by_config",
              "reindex_feature"),
    "utils.topo": ("Topo", "init_p2p", "p2pCliqueTopo"),
}
# torch-quiver's names (the reference __init__.py exports these); the
# JAX package's TpuComm is this port's TorchComm
_ALIASES = {"NcclComm": ("comm", "TorchComm"),
            "getNcclId": ("comm", "get_comm_id")}
_WHERE = dict(_ALIASES, **{name: (mod, name)
                           for mod, names in _EXPORTS.items()
                           for name in names})


def __getattr__(name):
    """An exported name, or a submodule, imported on first use."""
    if name in _WHERE:
        mod, attr = _WHERE[name]
        value = getattr(importlib.import_module(f".{mod}", __name__), attr)
    elif name.startswith("__"):
        raise AttributeError(name)
    else:
        try:
            value = importlib.import_module(f".{name}", __name__)
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))


__all__ = ["Actuator", "AsyncCudaNeighborSampler", "AsyncNeighborSampler",
           "CSRTopo", "ColdPrefetcher", "Collector", "DeadlineExceeded",
           "DeviceConfig", "DistFeature", "ExchangeCapPlan", "ExtentReader",
           "FaultPlan", "FaultRule", "Feature", "FleetAggregator",
           "FleetAutoscaler", "FleetExporter", "FlightRecorder", "GAT",
           "GraphDataset", "GraphSAGE", "GraphSageSampler", "HealthRouter",
           "HeteroCSRTopo", "HeteroFeature", "HeteroGraphSageSampler",
           "HostRankTable", "Knob", "MetricsSink", "MicroBatchServer",
           "MixedGraphSageSampler", "NcclComm", "OverloadError",
           "PartitionInfo", "Pipeline", "PlanContext", "QuantizedTensor",
           "ReplicaSupervisor", "RpcClient", "RpcError", "RpcServer",
           "SampleJob", "ServeConfig", "ServeEngine", "ServerClosed",
           "ShardTensor", "ShardTensorConfig", "ShardedServeEngine",
           "SloBudget", "StageProfiler", "StagingRing", "StepStats",
           "StorageModel", "TailSampler", "TelemetryHub", "TenantClass",
           "Topo", "TorchComm", "TraceStore", "actuator", "analysis",
           "build_dist_train_step", "build_e2e_train_step", "build_serve_step",
           "build_sharded_serve_step", "capacity", "comm",
           "default_tenant_classes", "fleet", "from_numpy_dir",
           "generate_drifting_trace", "generate_scenario",
           "generate_synthetic_cold_dataset", "getNcclId", "get_comm_id",
           "health_score", "init_distributed", "init_p2p",
           "layerwise_inference", "load_disk_tier", "load_disk_tier_store",
           "load_partition_info", "load_quantized_feature_partition",
           "load_quiver_feature_partition", "load_synthetic_cold_dataset",
           "machine_probe", "p2pCliqueTopo", "parse_size",
           "partition_feature_without_replication", "pipelined",
           "plan_extents", "plan_hot_capacity", "pmerge_counters", "profile",
           "profiling", "quantize", "quiver_partition_feature",
           "reindex_by_config", "reindex_feature", "replay", "rpc",
           "sample_ahead", "save_disk_tier", "save_partition_info",
           "save_quantized_feature_partition", "serving", "show_tensor_info",
           "tailsampling", "telemetry", "traffic"]
