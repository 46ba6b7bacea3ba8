"""The check that a run loaded neither JAX nor the JAX package."""

import subprocess
import sys

from qbench import guard


def test_top_level_names_are_compared_whole():
    names = ["quiver_tpu_torch", "quiver_tpu_torch.ops", "torch",
             "jaxtyping", "flaxen", "optaxes"]
    assert guard.forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
           "quiver_tpu", "quiver_tpu.ops.sample"]
    assert guard.forbidden_modules(names + bad) == sorted(bad)


def test_the_port_does_not_trip_it():
    code = ("import qbench.run, qbench.guard as g; "
            "import quiver_tpu_torch; "
            "from quiver_tpu_torch import CSRTopo, Feature, "
            "GraphSAGE, GraphSageSampler, ServeEngine; "
            "from quiver_tpu_torch.parallel import build_split_train_step; "
            "import qbench.drivers.train_split, qbench.drivers.serve; "
            "print(g.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_jax_package_trips_it():
    code = ("import sys, types; sys.modules['quiver_tpu'] = "
            "types.ModuleType('quiver_tpu'); import qbench.guard as g; "
            "print(g.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "['quiver_tpu']"
