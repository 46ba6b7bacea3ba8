"""The port's examples (``quiver_tpu_torch.examples``) against the JAX
package's ``examples/`` scripts, on the CPU: the five single-process
examples (train_products_synthetic, graph_sage_unsup, gat_weighted,
hetero_rgcn, serve_sage).

Each JAX script is loaded by path. Its parser is read by stopping
``parse_args`` (its flags are built before it imports JAX); the arrays
it builds inline are read from ``main``'s frame, stopped at the first
library call after its data (``CSRTopo``, or the hetero sampler). The
data generators must equal JAX's bit for bit, the CLI surfaces must be
JAX's plus ``--device``, the unsupervised loss is held to JAX's body
within 1e-5 on one block with converted weights, and the AUC and
accuracy counts must be equal. End to end, each example runs with
``--device cpu`` at a small size; where the run learns, the JAX script
runs at the same size and the band between the two is stated at the
test (the random streams differ by design).
"""

import argparse
import functools
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from quiver_tpu_torch.examples import (gat_weighted, graph_sage_unsup,
                                       hetero_rgcn, serve_sage,
                                       train_products_synthetic)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"train_products_synthetic": train_products_synthetic,
        "graph_sage_unsup": graph_sage_unsup, "gat_weighted": gat_weighted,
        "hetero_rgcn": hetero_rgcn, "serve_sage": serve_sage}
CPU = ["--device", "cpu"]


class _Stop(Exception):
    """Raised where a JAX script's run is stopped."""


def _stop(*_args, **_kw):
    raise _Stop


@functools.lru_cache(maxsize=None)
def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_main(name, argv, monkeypatch):
    """Run the JAX script's ``main`` with ``argv`` as its command line."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return jax_example(name).main()


def jax_parser(name, monkeypatch):
    """The JAX script's parser, taken at its ``parse_args``."""
    seen = {}

    def grab(self, *_args, **_kw):
        seen["parser"] = self
        raise _Stop
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Stop):
            jax_main(name, [], m)
    return seen["parser"]


def jax_locals(name, argv, monkeypatch, owner, attr) -> dict:
    """``main``'s locals of the JAX script, stopped where it calls
    ``owner.attr`` (its first library call after the data)."""
    with monkeypatch.context() as m:
        m.setattr(owner, attr, _stop)
        with pytest.raises(_Stop) as info:
            jax_main(name, argv, m)
    tb, frame = info.tb, None
    while tb is not None:
        code = tb.tb_frame.f_code
        if code.co_name == "main" and code.co_filename.endswith(
                os.path.join("examples", f"{name}.py")):
            frame = tb.tb_frame
        tb = tb.tb_next
    return dict(frame.f_locals)


def surface(parser) -> dict:
    """Each option's strings, default, choices, help, nargs, const, type
    and action. A help text that names a module of the JAX package
    (``quiver_tpu.tracing``) names the port's (``quiver_tpu_torch.``)
    in the port's parser: compared after that one rename."""
    return {a.dest: (tuple(a.option_strings), a.default,
                     None if a.choices is None else list(a.choices),
                     a.help and a.help.replace("quiver_tpu_torch.",
                                               "quiver_tpu."),
                     a.nargs, a.const, a.type, type(a).__name__)
            for a in parser._actions}


def run_port(name, argv, capsys):
    rc = PORT[name].main([*argv, *CPU])
    out = capsys.readouterr().out
    assert rc == 0, out
    return out


def run_jax(name, argv, capsys, monkeypatch):
    jax_main(name, argv, monkeypatch)
    return capsys.readouterr().out


def floats(pattern, text):
    return [float(x) for x in re.findall(pattern, text, re.M)]


# -- the JAX scripts' printed lines, as regexes of their f-strings --------
EPOCH_TRAIN = r"^epoch \d+: loss (\d+\.\d{4})  \d+\.\d{2}s  \(\d+ seeds/s\)$"
EPOCH_UNSUP = r"^epoch \d+: loss \d+\.\d{4}  link-AUC (\d\.\d{3})  \d+\.\d{2}s$"
EPOCH_PLAIN = r"^epoch \d+: loss (\d+\.\d{4})  \d+\.\d{2}s$"
ACCURACY = (r"^test accuracy: (\d\.\d{4}) \(\d+ labeled test nodes, \d+ "
            r"batches\)$")
STORE = r"^feature store: \d+/\d+ rows cached in HBM$"


# -- data, bit for bit -----------------------------------------------------

def test_synthetic_equals_jax():
    want = jax_example("train_products_synthetic").synthetic(3000, 7, 12, 5)
    got = train_products_synthetic.synthetic(3000, 7, 12, 5)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_community_graph_equals_jax():
    want = jax_example("graph_sage_unsup").make_community_graph(
        np.random.default_rng(0), 1200)
    got = graph_sage_unsup.make_community_graph(
        np.random.default_rng(0), 1200)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rel_topo_equals_jax():
    import quiver_tpu as qv
    want = jax_example("hetero_rgcn").rel_topo(
        np.random.default_rng(0), 500, 300, 4, qv)
    got = hetero_rgcn.rel_topo(np.random.default_rng(0), 500, 300, 4, "cpu")
    assert np.array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    assert np.array_equal(got.indices.numpy(), np.asarray(want.indices))


def test_serve_sage_data_equals_jax(monkeypatch):
    import quiver_tpu
    loc = jax_locals("serve_sage", ["--nodes", "3000", "--dim", "12"],
                     monkeypatch, quiver_tpu, "CSRTopo")
    got = serve_sage.make_graph(np.random.default_rng(0), 3000, 12)
    for name, arr in zip(("deg", "indptr", "indices", "feat"), got):
        assert np.array_equal(arr, loc[name]), name
    # the trace draws from the generator after the data: one stream
    rng = np.random.default_rng(0)
    serve_sage.make_graph(rng, 3000, 12)
    assert rng.bit_generator.state == loc["rng"].bit_generator.state


def test_gat_weighted_data_equals_jax(monkeypatch):
    import quiver_tpu
    argv = ["--nodes", "2000", "--avg-deg", "6", "--dim", "8",
            "--classes", "3"]
    loc = jax_locals("gat_weighted", argv, monkeypatch, quiver_tpu,
                     "CSRTopo")
    rng = np.random.default_rng(0)
    got = gat_weighted.make_graph(rng, 2000, 6, 8, 3)
    for name, arr in zip(("deg", "indptr", "indices", "labels", "centers",
                          "feat"), got):
        assert np.array_equal(arr, loc[name]), name
    assert rng.bit_generator.state == loc["rng"].bit_generator.state


@pytest.mark.parametrize("weighted", [False, True])
def test_hetero_rgcn_data_equals_jax(monkeypatch, weighted):
    import quiver_tpu
    argv = ["--papers", "600", "--authors", "300", "--institutions", "20",
            "--dim", "8", "--classes", "3"] + (["--weighted"] if weighted
                                               else [])
    loc = jax_locals("hetero_rgcn", argv, monkeypatch, quiver_tpu,
                     "HeteroGraphSageSampler")
    rng = np.random.default_rng(0)
    rels = [hetero_rgcn.rel_topo(rng, *shape, "cpu")
            for shape in ((600, 600, 8), (600, 300, 3), (300, 20, 2))]
    for topo, et in zip(rels, (hetero_rgcn.CITES, hetero_rgcn.WRITES,
                               ("institution", "employs", "author"))):
        want = loc["topo"].rels[et]
        assert np.array_equal(topo.indptr.numpy(), np.asarray(want.indptr))
        assert np.array_equal(topo.indices.numpy(),
                              np.asarray(want.indices))
    labels, centers, feats = hetero_rgcn.make_features(
        rng, {"paper": 600, "author": 300, "institution": 20}, 8, 3)
    assert np.array_equal(labels, loc["labels"])
    for t in feats:
        assert np.array_equal(centers[t], loc["centers"][t]), t
        assert np.array_equal(feats[t], loc["feats"][t]), t
    if weighted:
        e = int(rels[0].indices.shape[0])
        w = rng.exponential(1.0, e).astype(np.float32)
        (jw,) = loc["sampler_kw"]["edge_weight"].values()
        assert np.array_equal(w, jw)
    assert rng.bit_generator.state == loc["rng"].bit_generator.state


# -- the CLI surface -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(PORT))
def test_cli_surface_is_jax_plus_device(name, monkeypatch):
    want = surface(jax_parser(name, monkeypatch))
    got = surface(PORT[name].build_parser())
    device = got.pop("device")
    assert got == want
    assert device[:3] == (("--device",), "cuda", ["cuda", "cpu"])


def test_shuffle_refusal_equals_jax(monkeypatch):
    argv = ["--shuffle", "butterfly"]
    with pytest.raises(SystemExit) as jax_exit:
        jax_main("train_products_synthetic", argv, monkeypatch)
    with pytest.raises(SystemExit) as port_exit:
        train_products_synthetic.main(argv + CPU)
    assert port_exit.value.code == jax_exit.value.code
    assert "--shuffle only applies to rotation/window" in port_exit.value.code


@pytest.mark.parametrize("name", sorted(PORT))
def test_cuda_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[name].main(["--device", "cuda"])


# -- deterministic pieces --------------------------------------------------

def test_unsup_loss_equals_jax_body():
    """``link_loss`` on one sampled block of ``[seeds | positives |
    negatives]`` against the JAX script's ``unsup_loss`` body (lines
    93-111) on the same block, positives, negatives and weights: 1e-5."""
    import jax
    import jax.numpy as jnp
    from quiver_tpu.models import GraphSAGE as FlaxSAGE
    from quiver_tpu.ops.sample import LayerSample as JLayer
    from quiver_tpu.parallel.train import layers_to_adjs as jadjs
    from quiver_tpu_torch.models import GraphSAGE, flax_to_state_dict
    from quiver_tpu_torch.models.convert import random_flax_params
    from quiver_tpu_torch.ops import sample_multihop_dedup
    from quiver_tpu_torch.parallel import (layers_to_adjs,
                                           masked_feature_gather)
    from quiver_tpu_torch.utils import CSRTopo

    rng = np.random.default_rng(3)
    n, bs, hidden, sizes = 600, 16, 8, graph_sage_unsup.SIZES
    edge_index, feat, _ = graph_sage_unsup.make_community_graph(rng, n)
    topo = CSRTopo(edge_index=edge_index, device="cpu")
    seeds = rng.choice(n, bs, replace=False).astype(np.int32)
    pos = rng.integers(0, n, bs).astype(np.int32)
    neg = rng.integers(0, n, bs).astype(np.int32)
    batch = torch.from_numpy(np.concatenate([seeds, pos, neg]))
    n_id, layers, blocals = sample_multihop_dedup(
        topo.indptr, topo.indices, batch, sizes,
        torch.Generator().manual_seed(5))
    x = masked_feature_gather(torch.from_numpy(feat), n_id)
    variables = random_flax_params(feat.shape[1], hidden, hidden, 2, seed=7)
    model = GraphSAGE(feat.shape[1], hidden, hidden, 2, dropout=0.0)
    model.load_state_dict(flax_to_state_dict(variables))
    got = graph_sage_unsup.link_loss(
        model, x, layers_to_adjs(layers, 3 * bs, sizes), blocals, bs)

    tri = 3 * bs
    jl = [JLayer(*(None if v is None else jnp.asarray(v.numpy())
                   for v in layer)) for layer in layers]
    fmodel = FlaxSAGE(hidden_dim=hidden, out_dim=hidden, num_layers=2,
                      dropout=0.0)
    z = fmodel.apply(variables, jnp.asarray(x.numpy()),
                     jadjs(jl, tri, sizes))[:tri]
    z = z[jnp.asarray(blocals.numpy())]
    zu, zp, zn = z[:bs], z[bs:2 * bs], z[2 * bs:]
    pos_logit = jnp.sum(zu * zp, axis=1)
    neg_logit = jnp.sum(zu * zn, axis=1)
    want = -(jax.nn.log_sigmoid(pos_logit).mean()
             + jax.nn.log_sigmoid(-neg_logit).mean())
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               atol=1e-5)


def test_auc_equals_jax_lines():
    """``auc`` against the JAX script's lines 144-150 (the pair scores
    through the node table, then the share of ordered pairs) on the
    same embeddings: equal."""
    rng = np.random.default_rng(1)
    eval_pos = rng.integers(0, 300, (2, 200))
    eval_neg = rng.integers(0, 300, (2, 200))
    nodes = np.unique(np.concatenate([eval_pos.reshape(-1),
                                      eval_neg.reshape(-1)]))
    z = rng.standard_normal((len(nodes), 6)).astype(np.float32)
    lut = {g: i for i, g in enumerate(nodes)}

    def score(pairs):
        a = z[[lut[g] for g in pairs[0]]]
        b = z[[lut[g] for g in pairs[1]]]
        return (a * b).sum(1)
    sp, sn = score(eval_pos), score(eval_neg)
    want = (sp[:, None] > sn[None, :]).mean()
    assert graph_sage_unsup.auc(z, nodes, eval_pos, eval_neg) == want


def test_eval_accuracy_count_equals_jax_lines():
    """``count_correct`` against the JAX script's lines 325-330 on the
    same logits, with NaN (unlabeled) labels among them: equal."""
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    bs, classes = 64, 7
    logits = rng.standard_normal((bs, classes)).astype(np.float32)
    labels = rng.integers(0, classes, bs).astype(np.float64)
    labels[rng.random(bs) < 0.2] = np.nan
    pred = np.asarray(jnp.argmax(jnp.asarray(logits)[:bs], -1))
    y = np.asarray(labels, dtype=np.float64)
    ok = np.isfinite(y)
    want = (int((pred[ok] == y[ok].astype(np.int64)).sum()), int(ok.sum()))
    got = train_products_synthetic.count_correct(torch.from_numpy(logits),
                                                 labels)
    assert got == want


# -- end to end on the CPU -------------------------------------------------

TRAIN_ARGS = ["--nodes", "8000", "--batch", "128", "--epochs", "2",
              "--sizes", "5", "3", "--eval-batches", "2"]


def test_train_products_end_to_end_against_jax(capsys, monkeypatch):
    """Fully cached, 2 epochs of 6 steps at 8,000 nodes. JAX's script at
    this size printed losses 3.7572 -> 1.6143 and test accuracy 0.9688
    (its random stream). Band: the port's loss falls by at least 30%,
    its last loss is within 0.6x to 1.6x of JAX's, and its test
    accuracy within 0.15 of JAX's."""
    jax_out = run_jax("train_products_synthetic", TRAIN_ARGS, capsys,
                      monkeypatch)
    out = run_port("train_products_synthetic", TRAIN_ARGS, capsys)
    for text in (jax_out, out):
        assert len(re.findall(STORE, text, re.M)) == 1
        assert len(floats(EPOCH_TRAIN, text)) == 2
        assert len(floats(ACCURACY, text)) == 1
    jl, pl = floats(EPOCH_TRAIN, jax_out), floats(EPOCH_TRAIN, out)
    assert pl[1] < 0.7 * pl[0]
    assert 0.6 * jl[1] <= pl[1] <= 1.6 * jl[1]
    assert abs(floats(ACCURACY, out)[0]
               - floats(ACCURACY, jax_out)[0]) <= 0.15


@pytest.mark.parametrize("argv", [
    ["--cache", "16KB"],                          # tiered, prefetched
    ["--sampling", "rotation", "--shuffle", "butterfly"],
    ["--sampling", "window", "--layout", "pair"],
    ["--cache-policy", "p2p_clique_replicate", "--cache", "16KB"],
], ids=["tiered", "rotation_butterfly", "window_pair", "clique"])
def test_train_products_routes(capsys, argv):
    out = run_port("train_products_synthetic", TRAIN_ARGS + argv, capsys)
    losses = floats(EPOCH_TRAIN, out)
    assert len(losses) == 2 and losses[1] < losses[0]
    assert len(floats(ACCURACY, out)) == 1


def test_train_products_npz_and_trace(capsys, tmp_path):
    """``--npz`` over a dump written here, and ``--trace`` to a file that
    holds the step and epoch spans."""
    indptr, indices, feat, labels, train_idx, test_idx = \
        train_products_synthetic.synthetic(2000, 6, 10, 4)
    row = np.repeat(np.arange(2000), np.diff(indptr))
    path = tmp_path / "ds.npz"
    np.savez(path, edge_index=np.stack([row, indices]), feat=feat,
             labels=labels, train_idx=train_idx, test_idx=test_idx)
    trace = tmp_path / "trace.json"
    out = run_port("train_products_synthetic",
                   ["--npz", str(path), "--batch", "64", "--epochs", "2",
                    "--sizes", "4", "2", "--classes", "2", "--eval-batches",
                    "1", "--trace", str(trace)], capsys)
    assert "feature store: 2000/2000 rows cached in HBM" in out
    assert len(floats(EPOCH_TRAIN, out)) == 2
    assert re.search(r"^wrote \d+ spans to .*trace\.json — load at "
                     r"https://ui\.perfetto\.dev$", out, re.M)
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"train.step", "train.epoch"} <= names


def test_train_products_eval_skip_note(capsys):
    out = run_port("train_products_synthetic",
                   ["--nodes", "1000", "--batch", "128", "--epochs", "1",
                    "--sizes", "3"], capsys)
    assert "eval skipped: 50 test nodes < batch 128 (lower --batch or " \
        "--eval-batches 0 to silence)" in out


def test_graph_sage_unsup_end_to_end_against_jax(capsys, monkeypatch):
    """1,500 nodes, batch 128, 2 epochs. JAX's script at this size
    printed link-AUC 0.745 -> 0.814. Band: the port's last AUC is above
    0.6 and within 0.15 of JAX's last."""
    argv = ["--nodes", "1500", "--batch", "128", "--epochs", "2"]
    jax_out = run_jax("graph_sage_unsup", argv, capsys, monkeypatch)
    out = run_port("graph_sage_unsup", argv, capsys)
    ja, pa = floats(EPOCH_UNSUP, jax_out), floats(EPOCH_UNSUP, out)
    assert len(ja) == len(pa) == 2
    assert pa[-1] > 0.6 and abs(pa[-1] - ja[-1]) <= 0.15


def test_gat_weighted_end_to_end(capsys):
    """Both samplings at 1,500 nodes, batch 64, 2 epochs. JAX's script
    at this size (exact) printed losses 1.6557 -> 1.6373: the labels
    are random and GAT has no self term, so the loss sits near ln 5 =
    1.609 and falls little. Band: finite, falling, within 0.1 of ln 5
    at the last epoch."""
    for sampling in ("exact", "rotation"):
        out = run_port("gat_weighted",
                       ["--nodes", "1500", "--batch", "64", "--epochs", "2",
                        "--sampling", sampling], capsys)
        losses = floats(EPOCH_PLAIN, out)
        assert len(losses) == 2 and losses[1] < losses[0]
        assert abs(losses[1] - np.log(5)) <= 0.1


def test_hetero_rgcn_end_to_end_against_jax(capsys, monkeypatch):
    """1,000 papers, batch 64, 2 epochs. JAX's script at this size
    printed losses 1.2625 -> 0.0599. Band: the port's loss falls below a
    quarter of its first epoch's and below 0.3 (JAX's last x 5)."""
    argv = ["--papers", "1000", "--authors", "500", "--institutions", "50",
            "--batch", "64", "--epochs", "2"]
    jax_out = run_jax("hetero_rgcn", argv, capsys, monkeypatch)
    jl = floats(EPOCH_PLAIN, jax_out)
    assert len(jl) == 2
    for extra in ([], ["--weighted"]):
        pl = floats(EPOCH_PLAIN, run_port("hetero_rgcn", argv + extra,
                                          capsys))
        assert len(pl) == 2
        assert pl[1] < 0.25 * pl[0] and pl[1] < max(5 * jl[1], 0.3)


def test_serve_sage_end_to_end(capsys, tmp_path):
    trace = tmp_path / "serve.json"
    out = run_port("serve_sage", ["--nodes", "3000", "--seconds", "0.5",
                                  "--trace", str(trace)], capsys)
    assert "compiling the fanout ladder [[10, 5], [4, 2]] at " \
        "batch_cap=32 ..." in out
    assert "offering ~2000 req/s for 0.5s ..." in out
    m = re.search(r"^served (\d+) requests \((\d+) shed at admission\); "
                  r"first row argmax = \d+$", out, re.M)
    assert m and int(m[1]) + int(m[2]) == 1000
    assert re.search(r"^per-request latency \(\d+ requests\): p50 ", out,
                     re.M)
    assert re.search(r"^slo: p99 target 50\.0 ms", out, re.M)
    assert re.search(r"^wrote \d+ spans to .*serve\.json — load it at ",
                     out, re.M)
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert "serve.dispatch" in names


def test_module_entry_runs():
    """``python -m quiver_tpu_torch.examples.train_products_synthetic``
    at a small size; the modules load neither JAX nor the JAX package."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "quiver_tpu_torch.examples.train_products_synthetic", *CPU,
         "--nodes", "1500", "--batch", "64", "--epochs", "1", "--sizes",
         "3", "2", "--eval-batches", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(floats(EPOCH_TRAIN, proc.stdout)) == 1
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from quiver_tpu_torch.examples import (dist_feature_demo, "
         "dist_train_demo, gat_weighted, graph_sage_unsup, hetero_rgcn, "
         "serve_sage, train_products_synthetic)\n"
         "assert not [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'flax', 'optax', 'quiver_tpu', 'examples')]\n"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
