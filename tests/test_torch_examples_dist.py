"""The port's multi-rank examples (``dist_feature_demo``,
``dist_train_demo`` and ``train_products_synthetic --data-parallel``)
against the JAX package's, on the CPU: two gloo ranks spawned by the
example itself (``examples/_ranks.py``), each a process of its own, so
every run is a subprocess whose output the test reads.

The demos' arrays must equal the JAX scripts' bit for bit (read from
``main``'s frame, stopped at ``sample_prob``, the first library call
after the data). The JAX demos run on the 8 virtual devices of the
test harness; the port's on 2 ranks, so their step counts differ and
the band is stated at the test.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from quiver_tpu_torch.examples import (dist_feature_demo, dist_train_demo,
                                       train_products_synthetic)

from test_torch_examples import jax_locals, run_jax, surface

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
EPOCH_DIST = r"^epoch \d+: loss (\d+\.\d{4})  \d+\.\d+s  \(\d+ dist steps\)$"
EPOCH_TRAIN = r"^epoch \d+: loss (\d+\.\d{4})  \d+\.\d{2}s  \(\d+ seeds/s\)$"


def run_module(name, *argv):
    """``python -m quiver_tpu_torch.examples.<name> --device cpu``: its
    stdout, after checking it exited 0."""
    proc = subprocess.run(
        [sys.executable, "-m", f"quiver_tpu_torch.examples.{name}", *CPU,
         *argv], cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def floats(pattern, text):
    return [float(x) for x in re.findall(pattern, text, re.M)]


@pytest.mark.parametrize("mod,names", [
    (dist_feature_demo, ("n", "dim", "indptr", "indices", "feat",
                         "train_idx")),
    (dist_train_demo, ("n", "dim", "classes", "labels", "indptr", "indices",
                       "feat", "train_idx")),
], ids=["dist_feature_demo", "dist_train_demo"])
def test_demo_data_equals_jax(monkeypatch, mod, names):
    import quiver_tpu.ops
    name = mod.__name__.rsplit(".", 1)[1]
    loc = jax_locals(name, [], monkeypatch, quiver_tpu.ops, "sample_prob")
    rng = np.random.default_rng(0)
    for key, arr in zip(names, mod.make_data(rng), strict=True):
        assert np.array_equal(arr, loc[key]), key
        if isinstance(arr, np.ndarray):
            assert arr.dtype == loc[key].dtype, key
    assert rng.bit_generator.state == loc["rng"].bit_generator.state


@pytest.mark.parametrize("mod", [dist_feature_demo, dist_train_demo],
                         ids=["dist_feature_demo", "dist_train_demo"])
def test_demo_cli_is_device_alone(mod):
    """The JAX demos take no flags; the port's take ``--device``."""
    got = surface(mod.build_parser())
    assert set(got) == {"help", "device"}
    assert got["device"][:3] == (("--device",), "cuda", ["cuda", "cpu"])


@pytest.mark.parametrize("main", [
    dist_feature_demo.main, dist_train_demo.main,
    lambda argv: train_products_synthetic.main(["--data-parallel", *argv])],
    ids=["dist_feature_demo", "dist_train_demo", "data_parallel"])
def test_cuda_without_a_card_raises(main):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--device", "cuda"])


def test_dist_feature_demo_on_two_ranks():
    out = run_module("dist_feature_demo")
    assert out.splitlines()[0] == "mesh: 2 hosts (cpu)"
    m = re.search(r"^looked up (\d+) rows across 2 hosts in \d+\.\d ms "
                  r"\(\d+\.\d{2} GB/s\) — all verified, padding returned "
                  r"zeros$", out, re.M)
    assert m and int(m[1]) > 0
    assert len(out.splitlines()) == 2            # rank 0 alone prints


def test_dist_train_demo_on_two_ranks_against_jax(capsys, monkeypatch):
    """JAX's demo on the harness's 8 virtual devices (4 steps of 1,024
    an epoch) printed losses 1.9191 -> 1.1161 -> 0.5893; the port's 2
    ranks take 18 steps of 256 an epoch. Band: the port's loss falls
    every epoch and ends below JAX's last."""
    jl = floats(EPOCH_DIST, run_jax("dist_train_demo", [], capsys,
                                    monkeypatch))
    out = run_module("dist_train_demo")
    lines = out.splitlines()
    assert lines[0] == "mesh: 2 hosts (cpu)"
    assert re.fullmatch(r"features partitioned: \[\d+, \d+\] rows per host",
                        lines[1])
    pl = floats(EPOCH_DIST, out)
    assert len(pl) == len(jl) == 3
    assert pl[0] > pl[1] > pl[2] and pl[2] < jl[2]
    assert "(18 dist steps)" in lines[2]
    assert lines[-1] == "feature exchange verified against ground truth"


def test_data_parallel_on_two_ranks():
    """Fully cached: rank 0 alone prints, the loss falls. Tiered: the
    NOTE, then rank 0 trains the full batch alone."""
    argv = ["--data-parallel", "--nodes", "8000", "--batch", "128",
            "--epochs", "2", "--sizes", "5", "3", "--eval-batches", "1"]
    out = run_module("train_products_synthetic", *argv)
    losses = floats(EPOCH_TRAIN, out)
    assert len(losses) == 2 and losses[1] < 0.8 * losses[0]
    assert out.count("feature store: 8000/8000 rows cached in HBM") == 1
    assert re.search(r"^test accuracy: \d\.\d{4} \(128 labeled test nodes, "
                     r"1 batches\)$", out, re.M)
    out = run_module("train_products_synthetic", *argv, "--cache", "64KB",
                     "--epochs", "1")
    assert out.count("NOTE: --data-parallel applies to the fused "
                     "fully-cached path; the tiered-store path runs "
                     "single-program (full batch)") == 1
    assert len(floats(EPOCH_TRAIN, out)) == 1
