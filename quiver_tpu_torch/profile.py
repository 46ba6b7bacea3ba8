"""Per-stage time attribution, machine probing and roofline efficiency
for every registered hot path (counterpart of ``quiver_tpu/profile.py``).

Everything here runs off the hot path, as a separate profile pass:

- :class:`StageProfiler` times each registered entry point (and each
  census lattice point, so shed variants are attributed too) and the
  canonical train pipeline's stages, best-of-N after a warm-up: with
  CUDA events on a card, with the host clock on the CPU. A stage that
  updates state in place has that state saved before each call and
  restored after it, outside the timed region, so profiling leaves the
  caller's state as it found it;
- :func:`machine_probe` measures what this device delivers: copy,
  random-gather, and pinned host-to-device and device-to-host rates,
  the roofline denominators;
- the cost model (``analysis.costmodel``, priced from the same kind of
  recorded run the verifier reads) gives each stage modeled bytes, so
  each stage gets ``modeled_bytes / measured_time / probed_peak``.

Records land as ``profile``-kind JSONL through a ``MetricsSink`` and,
with a ``TelemetryHub`` attached, as ``stage_share:<group>/<stage>`` and
``stage_ms:<group>/<stage>`` series points, where the hub's default
``stage_share:*`` watch turns a stage silently growing its share into an
``anomaly`` record. ``python -m quiver_tpu_torch.profile`` is the CLI.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from .analysis.costmodel import CostModel, cost_of, cost_of_fn
from .analysis.op_lint import _leaves, _paths
from .utils.device import resolve_device

#: series-name prefixes the profiler feeds into a TelemetryHub, and the
#: gather efficiency figure
PROFILE_SERIES = ("stage_share", "stage_ms", "gather_efficiency")


# ---------------------------------------------------------------------------
# timing and the machine probe
# ---------------------------------------------------------------------------


def _time_once(fn, dev) -> float:
    """Seconds of one ``fn()``: CUDA events on a card, the host clock
    on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _best_of(fn, reps: int, dev) -> float:
    fn()                                   # warm-up (builds, caches)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return min(_time_once(fn, dev) for _ in range(reps))


def device_name(dev) -> str:
    """``torch.cuda.get_device_name`` of a card, ``"cpu"`` for the CPU."""
    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def machine_probe(quick: bool = False, reps: int = 3,
                  size_mb: Optional[int] = None,
                  device=None) -> Dict[str, float]:
    """One-shot measurement on ``device`` (default the card; raises
    where there is none): the copy rate (``copy_`` of the working set,
    read once and written once), the random-gather rate
    (``index_select`` of 32-wide fp32 rows in random order, each read
    and written once), and the host-to-device and device-to-host rates
    from and to pinned host memory (on the CPU: host copies). Rates are
    GB/s of this device on this day, the roofline denominators.
    ``quick`` shrinks the working set (8 MB against 64 MB) and the
    repetitions."""
    dev = resolve_device(device)
    mb = size_mb if size_mb is not None else (8 if quick else 64)
    reps = max(1, reps if not quick else min(reps, 2))
    n = mb * (1 << 20) // 4
    x = torch.ones(n, device=dev)
    y = torch.empty_like(x)
    t = _best_of(lambda: y.copy_(x), reps, dev)
    memcpy_gbps = 2 * n * 4 / t / 1e9

    width = 32
    rows = n // width
    table = x.view(rows, width)
    ids = torch.randint(0, rows, (rows,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    out = torch.empty_like(table)
    t = _best_of(lambda: torch.index_select(table, 0, ids, out=out), reps,
                 dev)
    gather_gbps = 2 * rows * width * 4 / t / 1e9

    pin = dev.type == "cuda"
    host = torch.ones(n, pin_memory=pin)
    back = torch.empty(n, pin_memory=pin)
    t = _best_of(lambda: y.copy_(host, non_blocking=pin), reps, dev)
    h2d_gbps = n * 4 / t / 1e9
    t = _best_of(lambda: back.copy_(x, non_blocking=pin), reps, dev)
    d2h_gbps = n * 4 / t / 1e9
    return {
        "memcpy_gbps": round(memcpy_gbps, 3),
        "gather_gbps": round(gather_gbps, 3),
        "h2d_gbps": round(h2d_gbps, 3),
        "d2h_gbps": round(d2h_gbps, 3),
        "size_mb": mb,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": device_name(dev),
        "power_limit": power_limit() if dev.type == "cuda" else None,
    }


# ---------------------------------------------------------------------------
# stages and groups
# ---------------------------------------------------------------------------


@dataclass
class ProfileStage:
    """One timeable callable: a registry spec, a census lattice point,
    or a pipeline sub-stage. ``donate_argnums`` names args the stage
    updates in place."""

    name: str
    fn: object
    args: tuple = ()
    donate_argnums: tuple = ()
    cost: Optional[CostModel] = None


@dataclass
class ProfileGroup:
    """Stages profiled and attributed together (one ``profile`` JSONL
    record). ``ref_stage`` names the stage whose time is the share
    denominator (the pipeline's full step, so a share reads "fraction of
    the step"); without it shares are of the group's total time."""

    name: str
    stages: List[ProfileStage] = field(default_factory=list)
    ref_stage: Optional[str] = None


def _stage_device(stage: ProfileStage) -> torch.device:
    for t in _leaves(stage.args):
        if t.is_cuda:
            return t.device
    return torch.device("cpu")


class StageProfiler:
    """Best-of-N attribution over profile groups.

    Build the groups once (``add_registry`` / ``add_pipeline`` /
    ``add_group``) and call :meth:`run` per profile pass: the kernels
    build on the first pass and every later one re-times them, so a
    second pass loads no new kernel library.

    ``sink`` receives one ``profile`` JSONL record per group (plus one
    ``__machine__`` record carrying the probe); ``hub`` receives
    ``stage_share:<group>/<stage>`` and ``stage_ms:<group>/<stage>``
    points per pass."""

    def __init__(self, reps: int = 3, probe: Optional[dict] = None,
                 sink=None, hub=None):
        self.reps = max(1, int(reps))
        self.probe = probe
        self.sink = sink
        self.hub = hub
        self.groups: List[ProfileGroup] = []

    # -- building ------------------------------------------------------------
    def add_group(self, group: ProfileGroup) -> "StageProfiler":
        self.groups.append(group)
        return self

    def add_registry(self, names: Optional[Sequence[str]] = None,
                     quick: bool = False, device="cuda") -> "StageProfiler":
        """One group per registered entry point; every spec the builder
        returns (each census lattice point) becomes a stage."""
        from .analysis.registry import build_entry_specs, entry_names
        for name in (names or entry_names(quick=quick)):
            stages = [ProfileStage(spec.name, spec.fn, spec.args,
                                   tuple(spec.donate_argnums), cost_of(spec))
                      for spec in build_entry_specs(name, device)]
            self.add_group(ProfileGroup(name=name, stages=stages))
        return self

    def add_pipeline(self, fixture=None, device="cuda",
                     name: str = "train_pipeline") -> "StageProfiler":
        """The train path decomposed: ``sample`` (the fused walk's
        sampling alone), ``gather`` (the frontier's masked row gather
        alone), ``step`` (the fused train step: the share denominator),
        ``fused_hop`` (the leaf hop's sample+gather kernel at the walk's
        leaf frontier) and ``fused_multihop`` (the whole fused walk).
        ``fixture`` (a namespace: ``indptr``, ``indices``, ``feat``,
        ``forder``, ``seeds``, ``labels``, ``sizes``, ``state``,
        ``row_cap``, ``hop_seeds``) sets the scale; the default is the
        registry's small fixture on ``device``."""
        from .ops.kernels import fused
        from .parallel import build_train_step
        from .parallel.train import masked_feature_gather
        fx = fixture if fixture is not None else _small_pipeline(device)
        sizes, hs, cap = list(fx.sizes), list(fx.hop_seeds), fx.row_cap

        def sample(ip, ix, s):
            return fused.fused_sample_multihop(ip, ix, s, sizes, hs, cap)

        sample_args = (fx.indptr, fx.indices, fx.seeds)
        n_id, layers = sample(*sample_args)
        gather_args = (fx.feat, n_id, fx.forder)
        leaf = layers[-2].n_id if len(layers) > 1 else fx.seeds

        def hop(ip, ix, s, feat, forder):
            return fused.fused_hot_hop(ip, ix, s, feat, sizes[-1], hs[-1],
                                       cap, forder)

        hop_args = (fx.indptr, fx.indices, leaf, fx.feat, fx.forder)

        def walk(ip, ix, s, feat, forder):
            return fused.fused_multihop(ip, ix, s, feat, sizes, hs, cap,
                                        forder)

        walk_args = (fx.indptr, fx.indices, fx.seeds, fx.feat, fx.forder)
        step = build_train_step(fx.state.model, fx.state.optimizer, sizes,
                                fx.seeds.shape[0], fused_hot_hop=True,
                                fused_row_cap=cap)
        step_args = (fx.state, fx.feat, fx.forder, fx.indptr, fx.indices,
                     fx.seeds, fx.labels, hs, 1)
        stages = [
            ProfileStage("sample", sample, sample_args,
                         cost=cost_of_fn(sample, sample_args)),
            ProfileStage("gather", masked_feature_gather, gather_args,
                         cost=cost_of_fn(masked_feature_gather,
                                         gather_args)),
            ProfileStage("step", step, step_args, donate_argnums=(0,),
                         cost=_saved_cost(step, step_args)),
            ProfileStage("fused_hop", hop, hop_args,
                         cost=cost_of_fn(hop, hop_args)),
            ProfileStage("fused_multihop", walk, walk_args,
                         cost=cost_of_fn(walk, walk_args)),
        ]
        return self.add_group(ProfileGroup(name, stages, ref_stage="step"))

    # -- timing --------------------------------------------------------------
    def _time_stage(self, stage: ProfileStage):
        """(best_s, mean_s) over ``reps`` timed calls after one warm-up
        call. In-place args are saved before each call and restored
        after it, both outside the timed region."""
        dev = _stage_device(stage)
        saved = _save(stage)
        stage.fn(*stage.args)
        _restore(saved)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times = []
        for _ in range(self.reps):
            times.append(_time_once(lambda: stage.fn(*stage.args), dev))
            _restore(saved)
        return min(times), sum(times) / len(times)

    def _peak_for(self, cost: Optional[CostModel]):
        """The probe peak a stage rooflines against: the random-gather
        rate when gathers carry most of its modeled bytes, the copy rate
        otherwise."""
        if cost is None or self.probe is None:
            return None, None
        total = max(cost.total_bytes, 1)
        key = ("gather_gbps"
               if cost.gather_bytes + cost.gather_index_bytes >= total // 2
               else "memcpy_gbps")
        return key, self.probe.get(key)

    # -- the pass ------------------------------------------------------------
    def run(self) -> List[dict]:
        """One profile pass: time every stage of every group, attach
        the modeled bytes and roofline efficiency, emit and feed, and
        return the ``profile`` records (one per group, each naming its
        device; a ``__machine__`` record carries the probe)."""
        records: List[dict] = []
        if self.probe is not None:
            records.append({"entry": "__machine__",
                            "machine": dict(self.probe)})
        for group in self.groups:
            timed = [(st, *self._time_stage(st)) for st in group.stages]
            ref_ms = None
            if group.ref_stage is not None:
                for st, _, mean_s in timed:
                    if st.name == group.ref_stage:
                        ref_ms = mean_s * 1e3
            if ref_ms is None:
                ref_ms = sum(mean_s for _, _, mean_s in timed) * 1e3
            stages = []
            for st, best_s, mean_s in timed:
                row = {
                    "stage": st.name,
                    "mean_ms": round(mean_s * 1e3, 4),
                    "best_ms": round(best_s * 1e3, 4),
                    "reps": self.reps,
                    "share": round(mean_s * 1e3 / ref_ms, 4)
                    if ref_ms else None,
                }
                if st.cost is not None:
                    row["modeled"] = st.cost.record()
                    achieved = st.cost.total_bytes / best_s / 1e9
                    row["achieved_gbps"] = round(achieved, 3)
                    peak_key, peak = self._peak_for(st.cost)
                    if peak:
                        row["peak"] = peak_key
                        row["efficiency"] = round(achieved / peak, 4)
                stages.append(row)
            dev = _stage_device(group.stages[0]) if group.stages \
                else torch.device("cpu")
            records.append({"entry": group.name, "stages": stages,
                            "step_ms": round(ref_ms, 4),
                            "ref_stage": group.ref_stage,
                            "device": device_name(dev)})
        self._publish(records)
        return records

    def _publish(self, records: List[dict]) -> None:
        if self.sink is not None:
            for rec in records:
                self.sink.emit(rec, kind="profile")
        if self.hub is not None:
            for rec in records:
                entry = rec.get("entry", "")
                if entry.startswith("__"):
                    continue
                for st in rec.get("stages", ()):
                    tag = f"{entry}/{st['stage']}"
                    self.hub.observe(f"stage_share:{tag}", st.get("share"))
                    self.hub.observe(f"stage_ms:{tag}", st.get("mean_ms"))


def _save(stage: ProfileStage) -> list:
    """Copies of every tensor of the stage's in-place args."""
    out = []
    for i in stage.donate_argnums:
        for t in _paths(stage.args[i]).values():
            out.append((t, t.detach().clone()))
    return out


def _restore(saved: list) -> None:
    with torch.no_grad():
        for t, copy in saved:
            t.copy_(copy)


def _saved_cost(fn, args) -> CostModel:
    """:func:`cost_of_fn` of a step that updates ``args[0]`` in place,
    leaving that state as it found it."""
    stage = ProfileStage("", fn, args, donate_argnums=(0,))
    saved = _save(stage)
    try:
        return cost_of_fn(fn, args)
    finally:
        _restore(saved)


def _small_pipeline(device):
    """The registry's fixture as a pipeline fixture."""
    from types import SimpleNamespace
    from .analysis import registry
    fx = registry._fixture(registry._device(device))
    return SimpleNamespace(
        indptr=fx.indptr, indices=fx.indices, feat=fx.feat, forder=None,
        seeds=fx.seeds, labels=fx.labels[fx.seeds.long()], sizes=fx.sizes,
        state=registry._state(fx), row_cap=64, hop_seeds=[7, 8])


def render_records(records: List[dict], color: bool = False) -> str:
    """The CLI table: one line per stage — ``stage | mean ms | modeled
    bytes | achieved GB/s | % of probed peak | % of step``."""
    GREEN, YELLOW, RED, DIM, RESET = ("\x1b[32m", "\x1b[33m",
                                      "\x1b[31m", "\x1b[2m", "\x1b[0m")

    def tint(code, s):
        return f"{code}{s}{RESET}" if color else s

    lines = []
    for rec in records:
        if rec.get("entry") == "__machine__":
            m = rec["machine"]
            lines.append(tint(DIM, (
                f"machine probe ({m.get('platform', '?')}, "
                f"{m.get('device', '?')}, {m.get('size_mb')} MB): "
                f"memcpy {m['memcpy_gbps']:.2f} GB/s, "
                f"gather {m['gather_gbps']:.2f} GB/s, "
                f"h2d {m['h2d_gbps']:.2f} GB/s, "
                f"d2h {m['d2h_gbps']:.2f} GB/s")))
            continue
        lines.append(f"{rec['entry']}  (step {rec.get('step_ms', 0):.3f} ms"
                     f" on {rec.get('device', '?')})")
        for st in rec.get("stages", ()):
            mod = st.get("modeled") or {}
            eff = st.get("efficiency")
            eff_s = "   n/a" if eff is None else f"{100 * eff:5.1f}%"
            if eff is not None:
                eff_s = tint(GREEN if eff >= 0.5 else
                             YELLOW if eff >= 0.15 else RED, eff_s)
            share = st.get("share")
            share_s = ("  n/a " if share is None
                       else f"{100 * share:5.1f}%")
            lines.append(
                f"  {st['stage']:<24} {st['mean_ms']:>9.3f} ms  "
                f"{mod.get('total_bytes', 0):>12,} B  "
                f"{st.get('achieved_gbps', 0.0):>8.3f} GB/s  "
                f"{eff_s} peak  {share_s} of step")
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m quiver_tpu_torch.profile``: profile the registry's
    entry points (and the train pipeline) on ``--device`` (the card by
    default) and print one line per stage. Exit status 0 unless
    profiling itself fails: slow is a number here, not a verdict."""
    ap = argparse.ArgumentParser(
        prog="python -m quiver_tpu_torch.profile",
        description="per-stage time attribution and roofline efficiency "
                    "for every registered hot path")
    ap.add_argument("--quick", action="store_true",
                    help="the quick entry matrix and a small probe")
    ap.add_argument("--entry", action="append", default=[],
                    help="profile only this entry point (repeatable)")
    ap.add_argument("--jsonl", default=None,
                    help="append profile-kind records to this JSONL")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed reps per stage (default 5; 3 under "
                         "--quick)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the machine probe (no efficiency column)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="skip the train pipeline group")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)
    color = not args.no_color and sys.stdout.isatty()
    from .analysis.registry import release_group
    from .metrics import MetricsSink

    reps = args.reps or (3 if args.quick else 5)
    probe = None if args.no_probe else machine_probe(quick=args.quick,
                                                     device=args.device)
    sink = MetricsSink(args.jsonl) if args.jsonl else None
    try:
        profiler = StageProfiler(reps=reps, probe=probe, sink=sink)
        profiler.add_registry(names=args.entry or None, quick=args.quick,
                              device=args.device)
        if not args.no_pipeline and not args.entry:
            profiler.add_pipeline(device=args.device)
        n_stages = sum(len(g.stages) for g in profiler.groups)
        print(f"profile: {len(profiler.groups)} entry group(s), {n_stages} "
              f"stage(s), best-of-{reps} on "
              f"{device_name(resolve_device(args.device))}")
        records = profiler.run()
        print(render_records(records, color=color))
    finally:
        release_group()
        if sink is not None:
            sink.close()
    if args.jsonl:
        print(f"profile: {len(records)} profile record(s) -> {args.jsonl}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
