"""The port's one span path (``quiver_tpu_torch/tracing.py`` and the torch
side in ``profiling.py``) on the CPU: nothing records while tracing is
off and no profiler runs; each path the benchmark drives gives its named
span tree with parents, and a layer's self time is its duration less
its children's; a ``torch.profiler`` session switches recording on and
its end switches it off; a ring export and a profiler trace of one block
line up once merged; the tiered lookup's counters equal counts made by
hand; the ``@hot_path`` functions that hold spans stay clean under the
host lint; ``tracing`` imports without torch."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quiver_tpu_torch import (CSRTopo, Feature, GraphSAGE, GraphSageSampler,
                              ServeEngine, profiling, tailsampling, tracing)
from quiver_tpu_torch.parallel import (build_split_train_step,
                                       build_train_step, init_state)

REPO = Path(__file__).resolve().parents[1]
N, DIM, HIDDEN, OUT = 400, 12, 16, 5
SIZES = [4, 3]
CAP = 16


@pytest.fixture(scope="module")
def graph():
    g = np.random.default_rng(7)
    deg = g.integers(0, 20, N)
    indptr = np.zeros(N + 1, np.int32)
    indptr[1:] = np.cumsum(deg)
    indices = g.integers(0, N, indptr[-1]).astype(np.int32)
    feat = g.standard_normal((N, DIM)).astype(np.float32)
    return indptr, indices, feat


@pytest.fixture
def traced():
    tracing.clear()
    tracing.enable()
    yield tracing.get_tracer()
    tracing.disable()
    tracing.clear()


def _topo(graph):
    indptr, indices, _ = graph
    return CSRTopo(indptr=indptr, indices=indices, device="cpu")


def _store(graph, hot_rows=100, dedup=True, **kw):
    topo = _topo(graph)
    return Feature(device_cache_size=hot_rows * (DIM + 8), csr_topo=topo,
                   dedup_cold=dedup, dtype_policy="int8",
                   host_placement="offload", device="cpu",
                   **kw).from_cpu_tensor(graph[2])


def _engine(graph, store):
    return ServeEngine(GraphSAGE(DIM, HIDDEN, OUT, len(SIZES)), None,
                       _topo(graph), store, [SIZES], CAP, fused_hot_hop=True,
                       fused_row_cap=32, seed=3, device="cpu")


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r[0], []).append(r)
    return out


def _children(recs, rec):
    return sorted(r[0] for r in recs if r[7] == rec[6])


# -- off ---------------------------------------------------------------------


def test_off_span_is_the_shared_null_object():
    tracing.disable()
    sp = tracing.span("x")
    assert sp is tracing._NULL_SPAN and not sp.active
    with sp as s:
        s.count(rows=torch.ones(3).sum())       # a no-op, nothing kept
    assert tracing.span("y", args={"a": 1}) is sp


def test_off_the_engine_and_the_sampler_leave_the_ring_empty(graph):
    tracing.disable()
    tracing.clear()
    eng = _engine(graph, _store(graph))
    eng.run(np.arange(CAP, dtype=np.int32))
    smp = GraphSageSampler(_topo(graph), SIZES, device="cpu", seed=1)
    smp.sample(torch.arange(CAP))
    assert len(tracing.get_tracer()) == 0 and tracing.records() == []


# -- on: the span trees ------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_sampler_span_tree(graph, traced, weighted):
    indptr, indices, _ = graph
    w = torch.rand(int(indptr[-1]), generator=torch.Generator()
                   .manual_seed(2)) + 0.1 if weighted else None
    smp = GraphSageSampler(_topo(graph), SIZES, device="cpu", seed=1,
                           edge_weight=w)
    smp.sample(torch.arange(CAP))
    recs = traced.records()
    (root,) = [r for r in recs if r[0] == "sampler.sample"]
    assert root[7] is None
    kids = [r for r in recs if r[7] == root[6]]
    assert [(r[0], r[5]["hop"]) for r in kids] == [
        ("sample.draw", 0), ("sample.compact", 0),
        ("sample.draw", 1), ("sample.compact", 1)]
    methods = {r[5]["method"] for r in kids if r[0] == "sample.draw"}
    assert methods == {"weighted" if weighted else "exact"}
    assert len(recs) == 5


def test_split_train_step_span_tree(graph, traced):
    indptr, indices, feat = graph
    model = GraphSAGE(DIM, HIDDEN, OUT, len(SIZES))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    sample_fn, step_fn = build_split_train_step(model, opt, SIZES, CAP)
    seeds = torch.arange(CAP, dtype=torch.int32)
    n_id, adjs = sample_fn(torch.as_tensor(indptr), torch.as_tensor(indices),
                           seeds, 5)
    x = torch.as_tensor(feat)[n_id.long().clamp(min=0)]
    tracing.clear()
    step_fn(init_state(model, opt), x, adjs, torch.zeros(CAP).long(), 3)
    recs = traced.records()
    (root,) = [r for r in recs if r[0] == "train.step"]
    assert root[7] is None
    assert _children(recs, root) == ["train.backward", "train.forward",
                                     "train.optimizer"]


def test_fused_train_step_has_the_same_spans(graph, traced):
    indptr, indices, feat = graph
    model = GraphSAGE(DIM, HIDDEN, OUT, len(SIZES))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = build_train_step(model, opt, SIZES, CAP)
    step(init_state(model, opt), torch.as_tensor(feat), None,
         torch.as_tensor(indptr), torch.as_tensor(indices),
         torch.arange(CAP, dtype=torch.int32), torch.zeros(CAP).long(),
         [1, 2], 3)
    recs = traced.records()
    (root,) = [r for r in recs if r[0] == "train.step"]
    kids = _children(recs, root)
    assert {"train.forward", "train.backward", "train.optimizer"} <= set(kids)


def test_serve_span_tree_and_self_times(graph, traced):
    eng = _engine(graph, _store(graph))
    eng.run(np.arange(CAP, dtype=np.int32))
    recs = traced.records()
    by = _by_name(recs)
    (root,) = by["serve.run"]
    assert root[7] is None
    assert _children(recs, root) == ["serve.cold_fixup", "serve.model",
                                     "serve.walk"]
    (fix,) = by["serve.cold_fixup"]
    (look,) = by["feature.lookup"]
    assert look[7] == fix[6]
    kids = _children(recs, look)
    assert "feature.dedup" in kids and "feature.host_gather" in kids
    # self time: the duration less the direct children's
    table = tracing.span_table(recs)
    for rec in (root, fix, look):
        kids_ms = sum(r[3] for r in recs if r[7] == rec[6]) * 1e3
        assert table[rec[0]]["self_ms"] == pytest.approx(
            rec[3] * 1e3 - kids_ms)
        assert table[rec[0]]["host_ms"] == pytest.approx(rec[3] * 1e3)
    assert table["serve.walk"]["self_ms"] == table["serve.walk"]["host_ms"]
    # spans nest in time
    for r in recs:
        if r[7] is not None:
            (p,) = [q for q in recs if q[6] == r[7]]
            assert p[2] <= r[2] and r[2] + r[3] <= p[2] + p[3]


def test_record_files_under_the_open_span(traced):
    with tracing.span("outer") as sp:
        tracing.record("inner", 0.0, 0.001)
    recs = traced.records()
    inner = [r for r in recs if r[0] == "inner"][0]
    assert inner[6] is None and inner[7] == sp.id
    assert tracing.span_table(recs)["outer"]["calls"] == 1


def test_parents_stay_within_their_thread_under_contention(traced):
    """Each thread keeps its own stack of open spans: with more threads
    than cores and a short switch interval, every child's parent is a
    span of its own thread and name."""
    import threading
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for _ in range(200):
                with tracing.span(f"outer.{k}"):
                    with tracing.span(f"inner.{k}"):
                        pass
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = traced.records()
    by_id = {r[6]: r for r in recs}
    inner = [r for r in recs if r[0].startswith("inner.")]
    assert len(inner) == 16 * 200
    for r in inner:
        p = by_id[r[7]]
        assert p[1] == r[1] and p[0] == "outer." + r[0].split(".")[1]
    assert all(r[7] is None for r in recs if r[0].startswith("outer."))


# -- the profiler switch ----------------------------------------------------


def test_a_profiler_session_records_spans_with_tracing_off(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    tracing.disable()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.span("qt.probe").active
        with tracing.span("qt.profiled"):
            torch.ones(8) + 1
    assert [r[0] for r in tracing.records()] == ["qt.profiled"]
    assert not tracing.span("qt.probe").active
    with tracing.span("qt.after"):
        pass
    assert [r[0] for r in tracing.records()] == ["qt.profiled"]
    path = tmp_path / "p.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    # the span is a host op of its name in the profiler's trace
    assert any(e.get("name") == "qt.profiled" and e.get("ph") == "X"
               and e.get("cat") in ("cpu_op", "user_annotation")
               for e in evs)
    tracing.clear()


def test_ring_and_profiler_exports_merge_onto_one_clock(tmp_path, traced):
    with profiling.trace(str(tmp_path / "prof")):
        with tracing.span("qt.warm"):
            pass
        with tracing.span("qt.block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    ring = tmp_path / "ring.json"
    tracing.export_chrome_trace(str(ring))
    doc = json.loads(ring.read_text())
    assert isinstance(doc["baseTimeNanoseconds"], int)
    merged = tmp_path / "merged.json"
    tracing.merge_chrome_traces([str(ring), str(tmp_path / "prof" /
                                                "trace.json")], str(merged))
    evs = [e for e in json.loads(merged.read_text())["traceEvents"]
           if e.get("name") == "qt.block" and e.get("ph") == "X"]
    cats = sorted(e["cat"] for e in evs)
    assert len(evs) == 2 and cats[1] == "qt"
    assert abs(evs[0]["ts"] - evs[1]["ts"]) < 200.0      # microseconds


def test_merge_rebases_files_onto_the_earliest_base(tmp_path):
    paths = []
    for i, base in enumerate((5_000_000, 2_000_000)):
        p = tmp_path / f"{i}.json"
        p.write_text(json.dumps({"baseTimeNanoseconds": base, "traceEvents": [
            {"ph": "X", "pid": 1, "tid": 1, "name": f"e{i}", "ts": 10.0,
             "dur": 1.0}]}))
        paths.append(str(p))
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "pid": 9, "tid": 1, "name": "p", "ts": 7.0, "dur": 1}]}))
    out = tmp_path / "m.json"
    tracing.merge_chrome_traces(paths + [str(plain)], str(out))
    doc = json.loads(out.read_text())
    assert doc["baseTimeNanoseconds"] == 2_000_000
    ts = {e["name"]: e["ts"] for e in doc["traceEvents"]}
    assert ts == {"e0": 3010.0, "e1": 10.0, "p": 7.0}


def test_export_ts_is_unix_time_less_the_base(tmp_path, traced):
    import time
    before = time.time_ns()
    with tracing.span("qt.now"):
        pass
    path = tmp_path / "r.json"
    tracing.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    (ev,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    unix = doc["baseTimeNanoseconds"] + ev["ts"] * 1e3
    assert abs(unix - before) < 5e6            # within 5 ms of the clock
    assert ev["args"]["span"] >= 1


def test_kept_traces_name_their_clock_base():
    tracer = tracing.Tracer(capacity=16)
    recs = []

    class Sink:
        def emit(self, rec, kind=None):
            recs.append(rec)

    s = tailsampling.TailSampler(sink=Sink(), head_rate=1.0).attach(tracer)
    tracer.record("serve.dispatch", 2.0005, 0.001, 9)
    tracer.record("serve.request", 2.0, 0.002, 9)
    s.detach()
    (rec,) = recs
    assert rec["base_ns"] == tracing.unix_ns(2.0)


# -- device marks, units and the reader helper -------------------------------


class _Events:
    """A span's device events as the torch side hands them over."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed(self):
        return self.ms


def _fake_record(tracer, name, t0, dur, sid, parent, dev_ms=None, **counts):
    mark = tracing.Mark(_Events(dev_ms) if dev_ms is not None else None,
                        counts or None)
    tracer._file(name, t0, dur, None, None, sid, parent, mark)


def test_units_per_unit_and_resolve():
    tr = tracing.get_tracer()
    tracing.clear()
    sid = 1
    for u in range(3):
        root = sid
        _fake_record(tr, "serve.run", u, 0.010, root, None, dev_ms=8.0)
        _fake_record(tr, "serve.walk", u + 0.001, 0.004, root + 1, root,
                     dev_ms=5.0)
        _fake_record(tr, "feature.lookup", u + 0.006, 0.002, root + 2, root,
                     dev_ms=2.0, host_rows=torch.tensor(10 + u))
        sid += 3
    assert len(tracing.units(tracing.records(), "serve.run")) == 3
    assert tracing.per_unit("serve.run", 2) == pytest.approx(8.0)
    assert tracing.per_unit("serve.run", 2, "serve.walk") == \
        pytest.approx(5.0)
    assert tracing.per_unit("serve.run", 3, "feature.lookup",
                            "host_rows") == pytest.approx(11.0)
    assert tracing.per_unit("serve.run", 2, field="host_ms") == \
        pytest.approx(10.0)
    assert tracing.per_unit("serve.run", 4) is None          # too few
    assert tracing.per_unit("serve.run", 2, "serve.model") is None
    assert tracing.per_unit("serve.run", 0) is None
    tracing.clear()


def test_resolve_reads_a_mark_once():
    reads = []

    class Once(_Events):
        def elapsed(self):
            reads.append(1)
            return self.ms

    m = tracing.Mark(Once(3.5), {"n": torch.tensor(3),
                                 "flag": torch.tensor(True)})
    rec = ("x", 1, 0.0, 0.001, None, None, 1, None, m)
    tracing.resolve([rec])
    tracing.resolve([rec])
    assert (m.device_ms, m.values) == (3.5, {"n": 3, "flag": 1})
    assert reads == [1] and m.events is None and m.counts is None


def test_the_event_ring_hands_a_reused_pair_no_time():
    """A span's events read no time once the ring has given its pair to
    a later span: the pair is taken on a turn, and the turn moved."""
    class Clock:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, other):
            return other.ms - self.ms

    ev = profiling._Events.__new__(profiling._Events)
    ev.start, ev.end, ev.turn = Clock(1.0), Clock(4.0), 7
    first = profiling._Taken(ev, 7)
    assert first.elapsed() == 3.0
    ev.turn = 7 + profiling.POOL_PAIRS
    assert first.elapsed() is None


# -- the lookup's counters ----------------------------------------------------


def _hand_counts(store, ids, budget):
    """``(cold_slots, host_rows, overflow)`` of a masked lookup of
    ``ids``, counted on the host."""
    ids = np.asarray(ids)
    valid = ids >= 0
    order = store.feature_order
    t = order.numpy()[np.clip(ids, 0, None)] if order is not None \
        else np.clip(ids, 0, None)
    cold = valid & (t >= store.cache_rows)
    if budget >= len(ids):
        # no compaction: one read of every cold slot
        return int(cold.sum()), int(cold.sum()), 0
    over = int(len(np.unique(t[valid])) > budget)
    distinct_cold = len(np.unique(t[cold]))
    return int(cold.sum()), int(cold.sum()) if over else distinct_cold, over


@pytest.mark.parametrize("budget", [None, 48, 6])
def test_lookup_counters_equal_counts_by_hand(graph, traced, budget):
    kw = {} if budget is None else {"cold_budget": budget}
    store = _store(graph, **kw)
    g = np.random.default_rng(5)
    ids = g.integers(0, N, 64).astype(np.int64)
    ids[::5] = ids[1::5][: len(ids[::5])]        # duplicates
    ids[-7:] = -1                                # padding
    from quiver_tpu_torch.feature import _resolve_cold_budget
    b = _resolve_cold_budget(True, store.cold_budget, len(ids))
    store.getitem_masked(torch.as_tensor(ids))
    recs = tracing.resolve(traced.records())
    (look,) = [r for r in recs if r[0] == "feature.lookup"]
    got = look[8].values
    cold, host, over = _hand_counts(store, ids, b)
    assert (got["cold_slots"], got["host_rows"], got["dedup_overflow"]) == \
        (cold, host, over)
    assert over == (budget == 6) and cold > 0
    if budget == 48:
        assert host < cold          # the duplicates are read once


def test_lookup_counters_without_dedup_count_every_cold_slot(graph, traced):
    store = _store(graph, dedup=False)
    ids = torch.arange(0, N, 3)
    store.getitem_masked(ids)
    (look,) = [r for r in tracing.resolve(traced.records())
               if r[0] == "feature.lookup"]
    cold, _, _ = _hand_counts(store, ids.numpy(), 10 ** 9)
    assert look[8].values == {"cold_slots": cold, "host_rows": cold,
                              "dedup_overflow": 0}


def test_recorded_counters_keep_no_tensor_alive(graph, traced):
    """A record holds its counters as a row of the torch side's host
    buffer, not as tensors, and reads nothing once the row is reused."""
    store = _store(graph)
    store.getitem_masked(torch.arange(0, N, 2))
    (look,) = [r for r in traced.records() if r[0] == "feature.lookup"]
    staged = look[8].counts
    assert isinstance(staged, profiling._Staged)
    assert not any(torch.is_tensor(getattr(staged, k)) for k in
                   ("row", "turn", "names", "plain"))
    assert set(staged.read()) == {"cold_slots", "unique", "live_rows"} \
        or set(staged.read()) == {"cold_slots", "host_rows",
                                  "dedup_overflow"}
    turn = profiling._row_turns[staged.row]
    profiling._row_turns[staged.row] = turn + profiling.POOL_PAIRS
    try:
        assert staged.read() is None
    finally:
        profiling._row_turns[staged.row] = turn


def test_recording_leaves_the_rows_and_logits_unchanged(graph):
    store = _store(graph)
    ids = torch.arange(0, N, 2)
    eng = _engine(graph, store)
    seeds = np.arange(CAP, dtype=np.int32)
    tracing.disable()
    rows_off, out_off = store.getitem_masked(ids), eng.run(seeds, 0, [4, 5])
    tracing.enable()
    try:
        rows_on, out_on = store.getitem_masked(ids), eng.run(seeds, 0, [4, 5])
    finally:
        tracing.disable()
        tracing.clear()
    assert torch.equal(rows_off, rows_on) and torch.equal(out_off, out_on)


# -- the lint and the standalone import ---------------------------------------


def test_host_lint_is_clean_on_the_spanned_hot_paths():
    import ast
    from quiver_tpu_torch.analysis import host_lint
    files = [REPO / "quiver_tpu_torch" / f for f in
             ("feature.py", "serving.py", "parallel/train.py")]
    # the marked functions that open spans, or call those that do
    spanned = [fn.name for p in files
               for fn in ast.walk(ast.parse(p.read_text()))
               if isinstance(fn, ast.FunctionDef)
               and host_lint._hot_path_marked(fn)
               and ("tracing.span" in ast.unparse(fn)
                    or "_lookup_tiered" in ast.unparse(fn)
                    or "_model_loss" in ast.unparse(fn))]
    assert {"_lookup_tiered", "_tiered", "step", "_fused_loss"} <= \
        set(spanned)
    findings = [f for f in host_lint.run_host_lint(files)
                if f.rule == "hot_path_blocking"]
    assert findings == []


def test_tracing_imports_without_torch(tmp_path):
    code = ("import sys, importlib.util\n"
            "sys.modules['torch'] = None\n"
            f"spec = importlib.util.spec_from_file_location('t', "
            f"{str(REPO / 'quiver_tpu_torch' / 'tracing.py')!r})\n"
            "t = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(t)\n"
            "t.enable()\n"
            "with t.span('a'):\n"
            "    pass\n"
            "print(t.span_table(t.records())['a']['calls'],\n"
            "      t.span('b').active)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "True"]
