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
"""

__version__ = "0.1.0"

from .actuator import Actuator, FleetAutoscaler, Knob
from .comm import HostRankTable, TorchComm, get_comm_id, init_distributed
from .faults import FaultPlan, FaultRule
from .feature import (DeviceConfig, DistFeature, ExchangeCapPlan, Feature,
                      PartitionInfo)
from .fleet import (FleetAggregator, FleetExporter, HealthRouter,
                    ReplicaSupervisor, health_score)
from .hetero import HeteroCSRTopo, HeteroGraphSageSampler
from .hetero_feature import HeteroFeature
from .metrics import (Collector, MetricsSink, SloBudget, StepStats,
                      pmerge_counters)
from .models import GAT, GraphSAGE
from .ops.quant import quantize
from .parallel import build_dist_train_step, build_e2e_train_step
from .partition import (load_partition_info,
                        load_quantized_feature_partition,
                        load_quiver_feature_partition,
                        partition_feature_without_replication,
                        quiver_partition_feature, save_partition_info,
                        save_quantized_feature_partition)
from .pyg import GraphSageSampler, MixedGraphSageSampler, SampleJob
from .rpc import (DeadlineExceeded, RpcClient, RpcError, RpcServer,
                  ServerClosed)
from .serving import (MicroBatchServer, OverloadError, ServeConfig,
                      ServeEngine, ShardedServeEngine, TenantClass,
                      build_serve_step, build_sharded_serve_step,
                      default_tenant_classes)
from .shard_tensor import ShardTensor, ShardTensorConfig
from .tailsampling import TailSampler, TraceStore
from .telemetry import FlightRecorder, PlanContext, TelemetryHub
from .traffic import generate_scenario, replay
from .utils import CSRTopo, parse_size
from .utils.topo import Topo, init_p2p, p2pCliqueTopo

from . import (actuator, capacity, comm, fleet, rpc, serving, tailsampling,
               telemetry, traffic)

__all__ = ["Actuator", "CSRTopo", "Collector", "DeadlineExceeded",
           "DeviceConfig", "DistFeature", "ExchangeCapPlan", "FaultPlan",
           "FaultRule", "Feature", "FleetAggregator", "FleetAutoscaler",
           "FleetExporter", "FlightRecorder", "GAT", "GraphSAGE",
           "GraphSageSampler", "HealthRouter", "HeteroCSRTopo",
           "HeteroFeature", "HeteroGraphSageSampler", "HostRankTable",
           "Knob", "MetricsSink", "MicroBatchServer",
           "MixedGraphSageSampler", "OverloadError", "PartitionInfo",
           "PlanContext", "ReplicaSupervisor", "RpcClient", "RpcError",
           "RpcServer", "SampleJob", "ServeConfig", "ServeEngine",
           "ServerClosed", "ShardTensor", "ShardTensorConfig",
           "ShardedServeEngine", "SloBudget", "StepStats", "TailSampler",
           "TelemetryHub", "TenantClass", "Topo", "TorchComm", "TraceStore",
           "actuator", "build_dist_train_step", "build_e2e_train_step",
           "build_serve_step", "build_sharded_serve_step", "capacity",
           "comm", "default_tenant_classes", "fleet", "generate_scenario",
           "get_comm_id", "health_score", "init_distributed", "init_p2p",
           "load_partition_info", "load_quantized_feature_partition",
           "load_quiver_feature_partition", "p2pCliqueTopo", "parse_size",
           "partition_feature_without_replication", "pmerge_counters",
           "quantize", "quiver_partition_feature", "replay", "rpc",
           "save_partition_info", "save_quantized_feature_partition",
           "serving", "tailsampling", "telemetry", "traffic"]
