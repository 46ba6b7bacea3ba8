"""quiver_tpu_torch: the PyTorch and CUDA port of ``quiver_tpu``.

A package of its own beside the JAX one, laid out like it (``ops/``,
``ops/kernels/``, ``models/``, ``parallel/``, ``utils/``, ``pyg/``,
``serving.py``). It imports neither JAX nor ``quiver_tpu``. Entry points
put their tensors on the card unless the caller passes ``device="cpu"``;
the TPU kernels, which the serve and train steps run through the fused
walk, are CUDA kernels for Hopper (``csrc/``), built at first use. The
train steps are in ``parallel`` (``build_train_step``). ``Feature`` is
the tiered store: its hot tier on the card, its cold tier in pinned host
memory that the card's row gather reads. ``GraphSageSampler`` samples
k-hop neighbourhoods with the topology on the card (HBM mode) or pinned
in host memory (HOST mode), read by the card's gathers.
"""

__version__ = "0.1.0"

from .feature import DeviceConfig, Feature
from .models import GAT, GraphSAGE
from .ops.quant import quantize
from .pyg import GraphSageSampler, SampleJob
from .serving import ServeEngine, build_serve_step
from .utils import CSRTopo, parse_size

__all__ = ["CSRTopo", "DeviceConfig", "Feature", "GAT", "GraphSAGE",
           "GraphSageSampler", "SampleJob", "ServeEngine",
           "build_serve_step", "parse_size", "quantize"]
