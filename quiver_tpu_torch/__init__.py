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
front end (``RpcServer``) and client (``RpcClient``).
"""

__version__ = "0.1.0"

from .feature import DeviceConfig, Feature
from .hetero import HeteroCSRTopo, HeteroGraphSageSampler
from .hetero_feature import HeteroFeature
from .metrics import Collector, MetricsSink, SloBudget, StepStats
from .models import GAT, GraphSAGE
from .ops.quant import quantize
from .pyg import GraphSageSampler, MixedGraphSageSampler, SampleJob
from .rpc import (DeadlineExceeded, RpcClient, RpcError, RpcServer,
                  ServerClosed)
from .serving import (MicroBatchServer, OverloadError, ServeConfig,
                      ServeEngine, TenantClass, build_serve_step,
                      default_tenant_classes)
from .shard_tensor import ShardTensor, ShardTensorConfig
from .utils import CSRTopo, parse_size

from . import rpc, serving

__all__ = ["CSRTopo", "Collector", "DeadlineExceeded", "DeviceConfig",
           "Feature", "GAT", "GraphSAGE", "GraphSageSampler",
           "HeteroCSRTopo", "HeteroFeature", "HeteroGraphSageSampler",
           "MetricsSink", "MicroBatchServer", "MixedGraphSageSampler",
           "OverloadError", "RpcClient", "RpcError", "RpcServer",
           "SampleJob", "ServeConfig", "ServeEngine", "ServerClosed",
           "ShardTensor", "ShardTensorConfig", "SloBudget", "StepStats",
           "TenantClass", "build_serve_step", "default_tenant_classes",
           "parse_size", "quantize", "rpc", "serving"]
