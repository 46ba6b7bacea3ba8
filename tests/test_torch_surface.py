"""The port's public surface against the JAX package's: every name the
JAX package's top level, ``ops`` and ``utils`` export, the port exports
too, with one declared rename (``TpuComm``, the TPU communicator, is
``TorchComm`` here; ``NcclComm`` aliases it as JAX's aliases
``TpuComm``); the modules JAX's top level carries are attributes of the
port's; ``show_tensor_info`` describes a tensor and a numpy array; and
no module of the port imports JAX or the JAX package."""

import pathlib
import re

import numpy as np
import pytest
import torch

import quiver_tpu_torch as qt
from quiver_tpu_torch import ops as qt_ops
from quiver_tpu_torch import utils as qt_utils

ROOT = pathlib.Path(__file__).resolve().parents[1]
RENAMES = {"TpuComm": "TorchComm"}


def _port_name(name):
    return RENAMES.get(name, name)


@pytest.mark.parametrize("jax_mod,port_mod", [
    ("quiver_tpu", qt), ("quiver_tpu.ops", qt_ops),
    ("quiver_tpu.utils", qt_utils)])
def test_all_covers_the_jax_package(jax_mod, port_mod):
    import importlib
    want = importlib.import_module(jax_mod).__all__
    missing = [n for n in want if _port_name(n) not in port_mod.__all__]
    assert missing == []
    assert all(hasattr(port_mod, n) for n in port_mod.__all__)


def test_the_one_rename():
    import quiver_tpu
    assert "TpuComm" in quiver_tpu.__all__ and "TpuComm" not in qt.__all__
    assert qt.NcclComm is qt.TorchComm
    assert quiver_tpu.NcclComm is quiver_tpu.TpuComm
    assert qt.getNcclId is qt.get_comm_id


def test_top_level_modules():
    import quiver_tpu
    for name in ("actuator", "analysis", "capacity", "comm", "profiling",
                 "checkpoint", "datasets", "debug", "faults", "fleet",
                 "metrics", "profile", "rpc", "serving", "tailsampling",
                 "telemetry", "tracing", "traffic"):
        assert hasattr(quiver_tpu, name)
        assert getattr(qt, name).__name__ == f"quiver_tpu_torch.{name}"
    assert qt.StageProfiler is qt.profile.StageProfiler
    assert qt.machine_probe is qt.profile.machine_probe


def test_show_tensor_info_on_a_tensor(capsys):
    info = qt.show_tensor_info(torch.ones(3, 4, dtype=torch.float16))
    assert info == ("torch.Tensor shape=(3, 4) dtype=torch.float16 "
                    "device=cpu nbytes=24")
    assert capsys.readouterr().out.strip() == info


def test_show_tensor_info_on_numpy_as_jax(capsys):
    from quiver_tpu.debug import show_tensor_info as jax_show
    arr = np.ones((2, 5), np.int8)
    assert qt.show_tensor_info(arr) == jax_show(arr) == \
        "numpy shape=(2, 5) dtype=int8 nbytes=10"


_IMPORT = re.compile(r"^\s*(import\s+(jax|flax|optax|quiver_tpu|examples)\b|"
                     r"from\s+(jax|flax|optax|quiver_tpu|examples)\b[\w.]*"
                     r"\s+import)", re.M)
EXAMPLES = ("dist_feature_demo", "dist_train_demo", "gat_weighted",
            "graph_sage_unsup", "hetero_rgcn", "serve_sage",
            "train_products_synthetic")


def test_no_module_of_the_port_imports_jax():
    """No module of the port (its examples included) imports JAX, the
    JAX package or the JAX package's ``examples/``."""
    sources = sorted((ROOT / "quiver_tpu_torch").rglob("*.py"))
    assert {p.stem for p in sources
            if p.parent.name == "examples"} >= set(EXAMPLES)
    sources += [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"]
    bad = [str(p.relative_to(ROOT)) for p in sources
           if _IMPORT.search(p.read_text())]
    assert bad == []
