"""The port's verifier (``quiver_tpu_torch.analysis``) against the JAX
package's (``tests/test_analysis.py``).

1. Seeded violations: each JAX seeded violation has a port case that
   the port's rule flags with the right rule id, and a clean twin that
   passes (a host read in a metered train step; a collective after a
   host read of an unreduced flag, also laundered through in-place
   copies; an in-place state replaced by new tensors; a tiered lookup
   over a halved cold budget; a split gather; an oversized exchange
   cap; unbounded, mistyped and oversized census lattices).
2. The host lint: the port's copy gives JAX's findings on the seeded
   sources of ``tests/test_analysis.py``, flags torch's blocking calls
   in a ``@hot_path`` function, and finds the port's tree clean but for
   its documented deviations.
3. The registry: every entry, at JAX's fixture shapes on the CPU, is
   clean (the compact exchange held to its one documented host
   synchronisation), records every census lattice point, and records
   the kernels its path launches; across 2 gloo ranks each rank issues
   the same collectives, in both branches of the compact exchange.
4. The command line: exit codes, ``lint`` JSONL, a host-only run that
   imports no torch.

JAX is imported only inside the tests that compare against it, so the
spawned ranks of the cross-rank test stay light."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from quiver_tpu_torch.analysis import host_lint, registry
from quiver_tpu_torch.analysis.findings import ERROR, Finding, sort_findings
from quiver_tpu_torch.analysis.op_lint import (CensusSpec, EntrySpec,
                                               compare_sequences, record,
                                               run_rules)
from quiver_tpu_torch.ops.kernels import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _rules_of(findings):
    return {f.rule for f in findings if f.level == ERROR}


@pytest.fixture
def world1():
    """A gloo world of one for the tests' own collectives."""
    group = registry.mesh_group(CPU)
    yield group
    registry.release_group()


# ---------------------------------------------------------------------------
# seeded violations — the op rules
# ---------------------------------------------------------------------------


class TestSeededOpViolations:
    def test_host_read_in_metered_step_flagged(self):
        # JAX seeds a jax.debug.print in a metered step; the port's
        # counterpart reads the loss back to log it
        spec = registry.build_entry("train_step", CPU)
        step = spec.fn

        def chatty(*args):
            out = step(*args)
            print(f"loss={float(out[1]):.4f}")
            return out

        seeded = EntrySpec(name="seeded_sync", fn=chatty, args=spec.args)
        findings = run_rules(seeded, ("no_host_sync",))
        assert _rules_of(findings) == {"no_host_sync"}
        assert "_local_scalar_dense" in findings[0].msg
        assert run_rules(registry.build_entry("train_step", CPU),
                         ("no_host_sync",)) == []

    @staticmethod
    def _swap_if(flag_of):
        def body(x):
            flag = flag_of(x)
            if flag.item():
                out = torch.empty_like(x)
                dist.all_to_all_single(out, x)
                return out
            return x
        return body

    def test_unreduced_flag_collective_flagged(self, world1):
        # the deadlock class: a collective under a branch on a flag
        # no rank agreed on
        fn = self._swap_if(lambda x: x.sum() > 0)
        spec = EntrySpec(name="seeded_divergence", fn=fn,
                         args=(torch.ones(8),))
        findings = run_rules(spec, ("collective_divergence",))
        assert _rules_of(findings) == {"collective_divergence"}
        assert "all_to_all" in findings[0].msg

    def test_reduced_flag_collective_clean(self, world1):
        def flag_of(x):
            flag = (x.sum() > 0).to(torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            return flag
        spec = EntrySpec(name="reduced", fn=self._swap_if(flag_of),
                         args=(torch.ones(8),))
        assert run_rules(spec, ("collective_divergence",)) == []

    def test_laundered_flag_still_flagged(self, world1):
        # a rank-local value laundered through in-place copies into a
        # tensor a factory made (uniform until written): the taint must
        # follow the writes, as JAX's walk iterates loop carries to a
        # fix-point
        def flag_of(x):
            a = torch.zeros(1)
            b = torch.zeros(1)
            a.copy_(x.sum().reshape(1))
            b.add_(a)
            return b > 0
        spec = EntrySpec(name="laundered", fn=self._swap_if(flag_of),
                         args=(torch.ones(8),))
        findings = run_rules(spec, ("collective_divergence",))
        assert _rules_of(findings) == {"collective_divergence"}

    def test_inplace_state_replaced_flagged(self):
        # JAX's donated state whose dtype drifts: the port's step
        # replaces its in-place state's tensors instead of updating them
        state = {"w": torch.ones(8, 8), "b": torch.ones(8)}

        def drifting_step(state, x):
            for k in list(state):
                state[k] = state[k].to(torch.bfloat16)
            return x.sum()

        spec = EntrySpec(name="seeded_drift", fn=drifting_step,
                         args=(state, torch.ones(4)), donate_argnums=(0,))
        findings = run_rules(spec, ("donation_honored",))
        assert _rules_of(findings) == {"donation_honored"}
        assert len(findings[0].detail["unmatched"]) == 2

    def test_inplace_state_updated_clean(self):
        state = {"w": torch.ones(8, 8)}

        def stable_step(state, x):
            state["w"].add_(1.0)
            return x.sum()

        spec = EntrySpec(name="stable", fn=stable_step,
                         args=(state, torch.ones(4)), donate_argnums=(0,))
        assert run_rules(spec, ("donation_honored",)) == []

    def test_over_budget_cold_gather_flagged(self):
        # the real tiered lookup with its declared budget halved: the
        # narrow path's [budget, dim] host read now exceeds it
        spec = registry.build_entry("lookup_tiered", CPU)
        tier, budget, depth = spec.tier_budgets[0]
        spec.tier_budgets = ((tier, budget // 2, depth),)
        findings = run_rules(spec, ("traffic_budget",))
        assert _rules_of(findings) == {"traffic_budget"}
        assert findings[0].detail["rows"] == budget

    def test_split_gather_total_still_flagged(self):
        tier = torch.zeros(100, 8)
        ids = torch.arange(64) % 100

        def fn(t, i):
            return t[i[:32]] + t[i[32:]]

        spec = EntrySpec(name="seeded_split", fn=fn, args=(tier, ids),
                         tier_budgets=((tier, 48, 0),))
        findings = run_rules(spec, ("traffic_budget",))
        assert _rules_of(findings) == {"traffic_budget"}
        assert findings[0].detail["rows"] == 64
        assert findings[0].detail["gathers"] == 2

    def test_split_kernel_gather_total_still_flagged(self):
        # the same through the gather kernel's wrapper (its plain version
        # on the CPU is not recorded op by op: the wrapper reports once)
        from quiver_tpu_torch.ops.kernels.gather import gather_rows
        tier = torch.zeros(100, 8)
        ids = (torch.arange(64) % 100).to(torch.int32)

        def fn(t, i):
            return gather_rows(t, i[:32]) + gather_rows(t, i[32:])

        spec = EntrySpec(name="seeded_split_kernel", fn=fn,
                         args=(tier, ids), tier_budgets=((tier, 48, 0),))
        rec = spec.recording()
        assert rec.kernel_names() == {"gather_rows": 2}
        assert rec.gathers == []
        findings = run_rules(spec, ("traffic_budget",))
        assert findings[0].detail["rows"] == 64

    def test_oversized_exchange_cap_flagged(self, world1):
        # a ballooned cap ships most of the dense payload through the
        # "compact" path
        spec = registry.dist_lookup_spec(CPU, cap=48, name="seeded_fat_cap")
        findings = run_rules(spec, ("traffic_budget",))
        assert _rules_of(findings) == {"traffic_budget"}
        d = findings[0].detail
        assert d["narrow_bytes"] > 0.25 * d["dense_bytes"]

    def test_dense_payload_outside_the_fallback_flagged(self, world1):
        # the dense exchange run unconditionally (no gated block around
        # it): its dense-shaped payloads sit at depth 0
        from quiver_tpu_torch.comm import build_dist_lookup_fn
        spec = registry.dist_lookup_spec(CPU)
        spec.fn = build_dist_lookup_fn(world1, 32, 64)      # dense path
        spec.host_syncs = 0
        findings = run_rules(spec, ("traffic_budget",))
        assert _rules_of(findings) == {"traffic_budget"}
        assert "unconditional path" in findings[0].msg

    def test_unbounded_cap_set_flagged(self):
        spec = EntrySpec(
            name="seeded_unbounded", fn=lambda x: x, args=(torch.ones(4),),
            census=CensusSpec({"exchange_cap": None}, max_programs=8))
        findings = run_rules(spec, ("executable_census",))
        assert _rules_of(findings) == {"executable_census"}
        assert "UNBOUNDED" in findings[0].msg

    def test_census_bare_string_axis_is_unbounded(self):
        spec = EntrySpec(
            name="seeded_string_axis", fn=lambda x: x,
            args=(torch.ones(4),),
            census=CensusSpec({"program": "fused"}, max_programs=8))
        findings = run_rules(spec, ("executable_census",))
        assert _rules_of(findings) == {"executable_census"}
        assert "UNBOUNDED" in findings[0].msg

    def test_census_over_bound_flagged(self):
        spec = EntrySpec(
            name="seeded_overcount", fn=lambda x: x, args=(torch.ones(4),),
            census=CensusSpec({"cap": (64, 128, 256), "variant": 2},
                              max_programs=4))
        findings = run_rules(spec, ("executable_census",))
        assert "executable_census" in _rules_of(findings)
        assert findings[0].detail["count"] == 6

    @pytest.mark.parametrize("what,fn,args", [
        ("nonzero", lambda x: torch.nonzero(x), (torch.ones(4),)),
        ("masked_select", lambda x: x[x > 0], (torch.ones(4),)),
        ("unique", lambda x: torch.unique(x), (torch.ones(4),)),
        ("repeat_interleave",
         lambda x: torch.repeat_interleave(x.long()), (torch.ones(4),)),
        ("equal", lambda x: torch.equal(x, x), (torch.ones(4),)),
        ("bool", lambda x: bool(x.sum() > 0), (torch.ones(4),)),
    ])
    def test_each_syncing_op_counts(self, what, fn, args):
        findings = run_rules(EntrySpec(name=what, fn=fn, args=args),
                             ("no_host_sync",))
        assert _rules_of(findings) == {"no_host_sync"}, what

    def test_sized_repeat_interleave_does_not_sync(self):
        def fn(x):
            return torch.repeat_interleave(x.long(), output_size=4)
        assert run_rules(EntrySpec(name="sized", fn=fn,
                                   args=(torch.ones(4),)),
                         ("no_host_sync",)) == []


# ---------------------------------------------------------------------------
# the host lint
# ---------------------------------------------------------------------------

# the seeded sources of tests/test_analysis.py, each with what JAX's
# host lint finds there
SEEDED_SOURCES = {
    "lock_held_emit": (
        "class Hub:\n"
        "    def flush(self):\n"
        "        with self._lock:\n"
        "            for rec in self._pending:\n"
        "                self._sink.emit(rec, kind='anomaly')\n"),
    "non_lock_block": (
        "class T:\n"
        "    def run(self):\n"
        "        with self.profiler.block():\n"
        "            self._sink.emit({'x': 1})\n"),
    "emit_after_release": (
        "class Hub:\n"
        "    def flush(self):\n"
        "        with self._lock:\n"
        "            pending = list(self._pending)\n"
        "        for rec in pending:\n"
        "            self._sink.emit(rec, kind='anomaly')\n"),
    "thread_no_close": (
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._run)\n"),
    "thread_close_no_finalizer": (
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._run)\n"
        "    def close(self):\n        self._t.join()\n"),
    "scoped_worker": (
        "import threading\n"
        "class W:\n"
        "    def run_once(self):\n"
        "        t = threading.Thread(target=self._work)\n"
        "        t.start()\n"
        "        t.join()\n"),
    "local_then_self": (
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        t = threading.Thread(target=self._run)\n"
        "        t.start()\n"
        "        self._t = t\n"),
    "nested_class": (
        "import threading, weakref\n"
        "class Outer:\n"
        "    class Inner:\n"
        "        def start(self):\n"
        "            self._t = threading.Thread(target=f)\n"
        "            self._fin = weakref.finalize(self._t, g)\n"
        "        def close(self):\n"
        "            self._t.join()\n"),
    "daemon_with_close": (
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        self._t = threading.Thread(target=self._run,\n"
        "                                   daemon=True)\n"
        "    def close(self):\n"
        "        self._t.join()\n"),
    "hot_path_blocking": (
        "import numpy as np\n"
        "from quiver_tpu.profiling import hot_path\n"
        "@hot_path\n"
        "def gather(store, ids):\n"
        "    rows = store.lookup(ids)\n"
        "    rows.block_until_ready()\n"
        "    return np.asarray(rows)\n"),
    "unmarked": ("import numpy as np\n"
                 "def edge(rows):\n"
                 "    return np.asarray(rows)\n"),
    "swallowed": ("def worker(q):\n"
                  "    while True:\n"
                  "        try:\n"
                  "            q.get()\n"
                  "        except Exception:\n"
                  "            continue\n"),
    "swallowed_bare": ("def worker(q):\n"
                       "    while True:\n"
                       "        try:\n"
                       "            q.get()\n"
                       "        except:\n"
                       "            pass\n"),
    "counts": ("def worker(q, stats):\n"
               "    while True:\n"
               "        try:\n"
               "            q.get()\n"
               "        except Exception:\n"
               "            stats['errors'] += 1\n"),
    "logs": ("import logging\n"
             "def worker(q):\n"
             "    while True:\n"
             "        try:\n"
             "            q.get()\n"
             "        except Exception:\n"
             "            logging.exception('worker step failed')\n"),
    "reraises": ("def worker(q):\n"
                 "    while True:\n"
                 "        try:\n"
                 "            q.get()\n"
                 "        except Exception:\n"
                 "            raise\n"),
    "narrow": ("import queue\n"
               "def worker(q):\n"
               "    while True:\n"
               "        try:\n"
               "            q.get_nowait()\n"
               "        except queue.Empty:\n"
               "            continue\n"),
    "outside_loop": ("def once(q):\n"
                     "    try:\n"
                     "        q.get()\n"
                     "    except Exception:\n"
                     "        pass\n"),
    "bounded_for": ("def sweep(procs):\n"
                    "    for p in procs:\n"
                    "        try:\n"
                    "            p.kill()\n"
                    "        except Exception:\n"
                    "            pass\n"),
}


def _key(findings):
    return sorted((f.rule, f.level, f.entry) for f in findings)


class TestSeededHostViolations:
    @pytest.mark.parametrize("case", sorted(SEEDED_SOURCES))
    def test_same_findings_as_jax(self, case):
        from quiver_tpu.analysis import host_lint as jax_host_lint
        src = SEEDED_SOURCES[case]
        got = host_lint.check_source(src, "seeded.py")
        want = jax_host_lint.check_source(src, "seeded.py")
        assert _key(got) == _key(want), case

    def test_seeded_cases_flag_their_rule(self):
        flagged = {case: [f.rule for f in host_lint.check_source(src)]
                   for case, src in SEEDED_SOURCES.items()}
        assert flagged["lock_held_emit"] == ["lock_held_emit"]
        assert flagged["thread_no_close"] == ["resource_finalizer"]
        assert flagged["thread_close_no_finalizer"] == ["resource_finalizer"]
        assert flagged["local_then_self"] == ["resource_finalizer"]
        assert flagged["hot_path_blocking"] == ["hot_path_blocking"] * 2
        assert flagged["swallowed"] == ["swallowed_worker_exception"]
        assert flagged["swallowed_bare"] == ["swallowed_worker_exception"]
        clean = ("non_lock_block", "emit_after_release", "scoped_worker",
                 "nested_class", "daemon_with_close", "unmarked", "counts",
                 "logs", "reraises", "narrow", "outside_loop", "bounded_for")
        assert all(flagged[c] == [] for c in clean)

    @pytest.mark.parametrize("call", [
        "rows.item()", "rows.tolist()", "rows.cpu()", "rows.numpy()",
        "torch.cuda.synchronize()", "ev.synchronize()",
        "torch.cuda.current_stream().synchronize()"])
    def test_torch_blocking_calls_in_hot_path(self, call):
        src = ("import torch\n"
               "from quiver_tpu_torch.profiling import hot_path\n"
               "@hot_path\n"
               "def gather(store, ids, ev):\n"
               "    rows = store.lookup(ids)\n"
               f"    {call}\n"
               "    return rows\n")
        assert [f.rule for f in host_lint.check_source(src)] == \
            ["hot_path_blocking"]
        unmarked = src.replace("@hot_path\n", "")
        assert host_lint.check_source(unmarked) == []


# ---------------------------------------------------------------------------
# clean pass over the port's tree and registry
# ---------------------------------------------------------------------------


class TestCleanPass:
    def test_host_lint_tree_clean_but_documented(self):
        findings = host_lint.run_host_lint(root=ROOT)
        undocumented = [str(f) for f in findings
                        if host_lint.documented(f) is None]
        assert undocumented == []
        # every documented deviation is still there: a repaired one
        # leaves the list
        assert len(findings) == len(host_lint.DOCUMENTED)

    @pytest.mark.parametrize("name", registry.entry_names())
    def test_registry_entry_clean(self, name):
        findings, ran = registry.run_registry([name], device=CPU)
        assert [str(f) for f in findings if f.level == ERROR] == []
        assert ran == [name]

    def test_registry_quick_clean(self):
        findings, ran = registry.run_registry(quick=True, device=CPU)
        assert [str(f) for f in findings if f.level == ERROR] == []
        assert set(ran) == {"train_step", "lookup_tiered", "dist_lookup",
                            "serve_step", "sharded_serve_step",
                            "fused_hot_hop", "fused_multihop"}
        assert not dist.is_initialized()      # its world of one ended

    def test_nine_entries_and_quick_flags_as_jax(self):
        assert registry.entry_names() == [
            "train_step", "lookup_tiered", "dist_lookup", "serve_step",
            "sharded_serve_step", "fused_hot_hop", "fused_multihop",
            "e2e_train_step", "dist_train_step"]
        assert registry.entry_names(quick=True) == \
            registry.entry_names()[:7]

    def test_every_census_lattice_point_is_recorded(self, world1):
        serve = registry.build_entry_specs("serve_step", CPU)
        assert len(serve) == serve[0].census.count() == 3
        assert len({id(s.fn) for s in serve}) == 3
        for name in ("e2e_train_step", "dist_train_step", "fused_hot_hop",
                     "fused_multihop"):
            specs = registry.build_entry_specs(name, CPU)
            assert len(specs) == specs[0].census.count() == 2, name

    @pytest.mark.parametrize("name,kernels", [
        ("train_step", {"fused_sample_hop", "fused_hot_hop"}),
        ("serve_step", {"fused_sample_hop", "fused_hot_hop"}),
        ("fused_hot_hop", {"fused_hot_hop"}),
        ("fused_multihop", {"fused_sample_hop", "fused_hot_hop"}),
        ("lookup_tiered", {"gather_rows"}),
        ("dist_lookup", {"gather_rows"}),
    ])
    def test_entries_record_their_kernels(self, world1, name, kernels):
        rec = registry.build_entry(name, CPU).recording()
        assert set(rec.kernel_names()) == kernels
        assert rec.launches == {}        # the CPU runs the plain versions

    def test_compact_exchange_declares_its_one_sync(self, world1):
        spec = registry.build_entry("dist_lookup", CPU)
        assert spec.host_syncs == 1
        assert spec.recording().syncs == ["_local_scalar_dense"]
        spec.host_syncs = 0
        assert _rules_of(run_rules(spec, ("no_host_sync",))) == \
            {"no_host_sync"}

    def test_cold_fallback_reads_are_gated(self):
        # the lookup's host reads: the narrow [budget] read at depth 0,
        # the compaction fallback's at depth 1 and its full read at 2
        rec = registry.build_entry("lookup_tiered", CPU).recording()
        depths = [(k.depth, int(k.args[1].shape[0])) for k in rec.kernels]
        assert depths == [(0, 64), (1, 64), (2, 128)]

    def test_second_pass_loads_no_library(self):
        registry.run_registry(quick=True, device=CPU)
        before = _build.loaded_libraries._cache_size()
        registry.run_registry(quick=True, device=CPU)
        assert _build.loaded_libraries._cache_size() == before

    def test_recorder_reports_a_kernel_once(self):
        # the plain version a wrapper runs on the CPU is not recorded op
        # by op: a CPU run and a card run record the same gathers
        from quiver_tpu_torch.ops.kernels.gather import gather_rows
        tab = torch.randn(50, 4)
        ids = torch.tensor([3, -1, 7], dtype=torch.int32)
        rec = record(lambda: gather_rows(tab, ids, out=torch.zeros(3, 4)))
        assert rec.kernel_names() == {"gather_rows": 1}
        assert rec.gathers == [] and rec.syncs == []


def _rank_sequences(ctx, narrow):
    """On one rank: the dist_lookup entry over the pair's group, on
    duplicate-heavy ids (the compact branch) or the fixture's (the dense
    fallback); its error findings and collective sequence."""
    group = ctx.groups[2]
    ids = None
    if narrow:
        rng = np.random.default_rng(10 + ctx.rank)
        ids = rng.choice(np.arange(4, dtype=np.int32) + 32 * ctx.rank, 64)
    spec = registry.dist_lookup_spec(CPU, group, ids=ids)
    findings = run_rules(spec)
    rec = spec.recording()
    return ([str(f) for f in findings if f.level == ERROR],
            [list(map(str, c)) for c in rec.sequence()],
            [c.depth for c in rec.collectives])


class TestAcrossRanks:
    def test_both_branches_issue_one_sequence(self):
        from chip_smoke import RankPool
        with RankPool(2, subgroups=(2,), timeout=60, call_timeout=120) as p:
            for narrow in (True, False):
                out = p.run(_rank_sequences, narrow)
                errors = [e for r in out for e in r[0]]
                assert errors == [], errors
                seqs = [r[1] for r in out]
                assert compare_sequences(seqs) == []
                fallback = max(out[0][2]) == 1
                assert fallback == (not narrow)
        assert compare_sequences([[("all_reduce", "int32", (1,))], []]) \
            and compare_sequences([[]] * 2) == []


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _cli(argv):
    from quiver_tpu_torch.analysis.__main__ import main
    return main(argv)


class TestCli:
    def test_clean_entry_exits_zero_with_jsonl(self, tmp_path):
        out = tmp_path / "lint.jsonl"
        rc = _cli(["--entry", "lookup_tiered", "--device", "cpu",
                   "--jsonl", str(out), "--no-color", "--no-host"])
        assert rc == 0
        recs = [json.loads(line) for line in out.read_text().splitlines()]
        assert recs and all(r["kind"] == "lint" for r in recs)
        assert not any(r["level"] == "ERROR" for r in recs)

    def test_seeded_violation_exits_one_with_finding(self, tmp_path):
        def build(device, group):
            def body(x):
                if (x.sum() > 0).item():
                    return x * 2
                return x
            return EntrySpec(name="seeded_sync_entry", fn=body,
                             args=(torch.ones(4),))

        out = tmp_path / "lint.jsonl"
        registry.register_entry("seeded_sync_entry", build)
        try:
            rc = _cli(["--entry", "seeded_sync_entry", "--device", "cpu",
                       "--jsonl", str(out), "--no-color", "--no-host"])
        finally:
            registry._REGISTRY.pop("seeded_sync_entry")
        assert rc == 1
        bad = [json.loads(line) for line in out.read_text().splitlines()]
        bad = [r for r in bad if r["level"] == "ERROR"]
        assert bad and bad[0]["rule"] == "no_host_sync"
        assert bad[0]["entry"] == "seeded_sync_entry"

    def test_host_only_exits_zero(self, capsys):
        assert _cli(["--host-only", "--no-color"]) == 0
        out = capsys.readouterr().out
        assert "(0 error(s))" in out and "documented" not in out

    def test_host_only_never_imports_torch(self):
        code = (
            "import sys\n"
            "sys.argv = ['verify', '--host-only', '--no-color']\n"
            "import runpy\n"
            "try:\n"
            "    runpy.run_path('quiver_tpu_torch/analysis/__main__.py',\n"
            "                   run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert (e.code or 0) == 0, e.code\n"
            "assert 'torch' not in sys.modules, 'host-only imported torch'\n"
            "print('HOST_ONLY_TORCH_FREE')\n")
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "HOST_ONLY_TORCH_FREE" in out.stdout

    def test_list(self, capsys):
        assert _cli(["--list"]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0] == "train_step  [quick]"
        assert lines[-1] == "dist_train_step"

    def test_findings_sort_errors_first(self):
        fs = [Finding("r", "INFO", "b", "m"), Finding("r", "ERROR", "z", "m"),
              Finding("r", "WARN", "a", "m")]
        assert [f.level for f in sort_findings(fs)] == \
            ["ERROR", "WARN", "INFO"]
        assert fs[1].record() == {"kind": "lint", "rule": "r",
                                  "level": "ERROR", "entry": "z",
                                  "msg": "m"}
