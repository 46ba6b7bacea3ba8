"""Op-trace verifier: the port's counterpart of
``quiver_tpu/analysis/jaxpr_lint.py``, the performance contract as rules.

JAX's rules walk a traced program. torch has no jaxpr, so each entry
point here is run once, eagerly, under an :class:`OpRecorder` (a
``TorchDispatchMode``) that keeps what the rules need from that one
run: every aten op that would make the host wait for the card, every
``torch.distributed`` collective (op, dtype, shape), every row gather
of an aten index op, every kernel launch as its wrapper reports it
(``ops.kernels._build.recorded``: a ``ctypes`` launch never reaches the
dispatcher, and the plain version a wrapper runs on the CPU is not
recorded op by op, so a CPU run and a card run record the same
gathers), and the FLOPs of ``torch.utils.flop_counter``'s formulas.
Each rule reads that one recording, as each JAX rule reads the one
shared trace, and returns :class:`~.findings.Finding` records. The
rule names, ``EntrySpec``, ``CensusSpec``, ``RULES`` and
``run_rules`` are JAX's, so ``lint`` records compare across packages.

Rules
-----
``no_host_sync``           the recorded ops that synchronise on a card
                           (``_local_scalar_dense`` — ``.item()`` —,
                           ``nonzero``, ``masked_select``, the
                           ``unique`` family, ``repeat_interleave``
                           without ``output_size``, bool-mask indexing,
                           a copy to the CPU, ``equal``,
                           ``is_nonzero``) number exactly the entry's
                           declared ``host_syncs`` (0 unless it
                           documents one). On a card the entry also
                           runs under ``torch.cuda.set_sync_debug_mode``
                           and the card's count must agree.
``donation_honored``       torch has no donation: the counterpart is
                           in-place state. Every tensor of the args the
                           entry declares in place (``donate_argnums``:
                           a train state's parameters and Adam moments)
                           keeps its storage across a call.
``collective_divergence``  no collective after a host read (``.item()``)
                           of a value that is not uniform over the
                           group (not the output of an ``all_reduce``
                           or a broadcast): ranks could take different
                           branches and deadlock, JAX's divergent
                           ``lax.cond``. Across ranks,
                           :func:`compare_sequences` holds every rank's
                           recorded collective sequence to be the same.
``traffic_budget``         rows read from each declared tier, summed
                           over every gather the recorder saw (kernel
                           wrappers and aten index ops on that tier's
                           storage) at gate depth <= the budget's, stay
                           within its budget (a split gather still
                           counts in full); compact-exchange
                           ``all_to_all`` payloads stay under the
                           declared fraction of the dense payload, and
                           dense-shaped payloads appear only at depth 1
                           and deeper (the fallback). Depth counts
                           ``_build.gated`` blocks, the port's
                           counterpart of ``lax.cond`` branches.
``executable_census``      the declared knob lattice is finite and
                           within ``max_programs`` (JAX's rule); what it
                           bounds here is the kernel builder's loaded
                           libraries, which a second pass over every
                           lattice point must not grow.

Where trouble hides: on the CPU, ``.cpu()`` of a CPU tensor dispatches
nothing, so a copy to the host shows only on a card; the dispatcher
sees neither ``torch.cuda.synchronize`` nor an event's or a stream's
``synchronize`` (``host_lint`` and the card's sync debug mode do); and
a rank number turned into a tensor by a factory counts as uniform.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops.kernels import _build
from .findings import ERROR, INFO, Finding

# ops whose result the host must wait for on a card, by overload packet
_SYNC_OPS = frozenset((
    "_local_scalar_dense", "item", "nonzero", "masked_select", "_unique",
    "_unique2", "unique_dim", "unique_consecutive", "unique_dim_consecutive",
    "equal", "is_nonzero"))
# of those, the ones that hand the host a value to branch on
_HOST_READS = frozenset(("_local_scalar_dense", "item", "is_nonzero",
                         "equal"))
# aten ops that read rows of their first operand by an index
_GATHER_OPS = frozenset(("index", "_unsafe_index", "index_select",
                         "embedding", "gather", "take"))
# c10d ops by the collective they issue, and where the payload is
_COLLECTIVES = {
    "alltoall_base_": ("all_to_all", 1), "alltoall_": ("all_to_all", 1),
    "allreduce_": ("all_reduce", 0), "allreduce_coalesced_": ("all_reduce", 0),
    "allgather_": ("all_gather", 1), "_allgather_base_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "reduce_scatter_": ("reduce_scatter", 1),
    "_reduce_scatter_base_": ("reduce_scatter", 1),
    "broadcast_": ("broadcast", 0), "barrier": ("barrier", 0),
    "send": ("send", 0), "recv_": ("recv", 0)}
# collectives whose outputs are the same on every rank
_UNIFORM_OUT = frozenset(("all_reduce", "all_gather", "broadcast"))


def _leaves(obj) -> List[torch.Tensor]:
    """Every tensor in a nested structure: tensors, tuples and lists
    (``QuantizedTensor``, ``TrainState``), dicts, a ``ShardedTier``'s
    shards, a module's parameters and buffers, an optimizer's state."""
    out, stack, seen = [], [obj], set()
    while stack:
        x = stack.pop()
        if torch.is_tensor(x):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif id(x) in seen:
            continue
        elif isinstance(x, torch.nn.Module):
            seen.add(id(x))
            stack.extend(reversed(list(x.state_dict(keep_vars=True)
                                       .values())))
        elif isinstance(x, torch.optim.Optimizer):
            seen.add(id(x))
            stack.extend(reversed(list(x.state.values())))
        elif hasattr(x, "shards"):
            seen.add(id(x))
            stack.extend(reversed(list(x.shards)))
    return out


def _paths(obj, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The tensors of :func:`_leaves` by a stable path (the in-place
    rule compares storages path by path across a call)."""
    if torch.is_tensor(obj):
        return {prefix or "arg": obj}
    out: Dict[str, torch.Tensor] = {}
    if isinstance(obj, torch.nn.Module):
        items = obj.state_dict(keep_vars=True).items()
    elif isinstance(obj, torch.optim.Optimizer):
        items = []
        for g, group in enumerate(obj.param_groups):
            for i, p in enumerate(group["params"]):
                for k, v in obj.state.get(p, {}).items():
                    items.append((f"state.{g}.{i}.{k}", v))
    elif isinstance(obj, dict):
        items = obj.items()
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    else:
        return out
    for k, v in items:
        out.update(_paths(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def storage_key(t: torch.Tensor) -> int:
    """The identity of a tensor's storage: its base address (0 for a
    tensor that has none)."""
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def storages(obj) -> set:
    """The storage keys of every tensor in ``obj``."""
    return {storage_key(t) for t in _leaves(obj)}


def span(t: torch.Tensor) -> Tuple[int, int]:
    """The byte range ``[start, end)`` a tensor's elements cover. Two
    tiers cut from one table (as a store's hot and cold tiers are on
    the CPU) share a storage but not a range."""
    start = t.data_ptr()
    if t.numel() == 0:
        return start, start
    last = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    return start, start + (last + 1) * t.element_size()


def spans(obj) -> List[Tuple[int, int]]:
    return [span(t) for t in _leaves(obj)]


def overlaps(a, b) -> bool:
    """Do two lists of byte ranges share a byte?"""
    return any(s0 < e1 and s1 < e0 for s0, e0 in a for s1, e1 in b)


def _host_scalars(args) -> set:
    """Storage keys of the scalars that stay on the host on a card too:
    an optimizer's ``step`` counters (torch keeps them on the CPU unless
    the optimizer is ``capturable`` or ``fused``), which every rank
    advances alike."""
    out = set()
    stack = [args]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.optim.Optimizer):
            for st in x.state.values():
                step = st.get("step") if isinstance(st, dict) else None
                if torch.is_tensor(step) and step.dim() == 0 \
                        and step.device.type == "cpu":
                    out.add(storage_key(step))
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


@dataclass
class Gather:
    """One aten index op's row read."""
    op: str
    table: torch.Tensor
    rows: int
    out_bytes: int
    index_key: int
    index_bytes: int
    depth: int


@dataclass
class KernelCall:
    """One kernel wrapper call as the wrapper handed it over."""
    name: str
    args: tuple
    kwargs: dict
    out: Any
    depth: int


@dataclass
class Collective:
    """One ``torch.distributed`` collective: its name, the payload's
    dtype, shape and bytes, and the gate depth it ran at."""
    op: str
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    depth: int

    def signature(self) -> tuple:
        return (self.op, self.dtype, self.shape)


@dataclass
class Recording:
    """What one recorded run saw (see :class:`OpRecorder`)."""
    device: str = "cpu"
    syncs: List[str] = field(default_factory=list)
    collectives: List[Collective] = field(default_factory=list)
    gathers: List[Gather] = field(default_factory=list)
    kernels: List[KernelCall] = field(default_factory=list)
    divergent: List[dict] = field(default_factory=list)
    flops: int = 0
    out: Any = None
    launches: Dict[str, int] = field(default_factory=dict)
    libraries_before: int = 0
    libraries_after: int = 0

    def kernel_names(self) -> Dict[str, int]:
        """Kernel wrapper calls by name."""
        out: Dict[str, int] = {}
        for k in self.kernels:
            out[k.name] = out.get(k.name, 0) + 1
        return out

    def sequence(self) -> List[tuple]:
        """The collectives as ``(op, dtype, shape)`` in issue order: what
        every rank of a group must agree on."""
        return [c.signature() for c in self.collectives]


def kernel_reads(call: KernelCall) -> List[Tuple[Any, int]]:
    """``(table, rows)`` a kernel call reads, by id slot (an id of -1 is
    a slot all the same, as a JAX gather's output row is): a row gather's
    ids, the leaf hop's seeds and picks, a 1-D gather's elements. The
    sampling kernels read topology, not a tier, and report none."""
    a = call.args
    if call.name in ("gather_rows", "gather_rows_sharded", "gather_elems"):
        return [(a[0], int(a[1].shape[0]))]
    if call.name == "gather_segments":
        return [(a[0], int(a[1].shape[0]) * int(a[3]))]
    if call.name == "fused_hot_hop":
        k = int(a[4] if len(a) > 4 else call.kwargs["k"])
        return [(a[3], int(a[2].shape[0]) * (1 + k))]
    return []


class OpRecorder(TorchDispatchMode):
    """Records one eager run (see the module docstring). Use through
    :func:`record`, which also activates the kernel wrappers' reports."""

    def __init__(self, host_scalars=()):
        super().__init__()
        self.rec = Recording()
        self._muted = 0
        self._uniform: Dict[int, bool] = {k: True for k in host_scalars}
        self._host = set(host_scalars)
        self._branch: Optional[dict] = None

    # -- uniformity over the group (the divergence rule's dataflow) --------
    def _is_uniform(self, t) -> bool:
        return self._uniform.get(storage_key(t), False)

    def _mark(self, tensors, uniform: bool) -> None:
        for t in tensors:
            self._uniform[storage_key(t)] = uniform

    # -- the wrappers' reports ----------------------------------------------
    def kernel_call(self, name, fn, args, kwargs):
        token = _build._RECORDER.set(None)
        self._muted += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._muted -= 1
            _build._RECORDER.reset(token)
        self.rec.kernels.append(KernelCall(name, args, kwargs, out,
                                           _build.gate_depth()))
        ins = _leaves((args, kwargs))
        self._mark(_leaves(out), all(self._is_uniform(t) for t in ins))
        return out

    # -- every aten and c10d op --------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._muted:
            return func(*args, **kwargs)
        if func._overloadpacket not in _flop_registry() and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"):
            # under inference mode composite ops (linear, item) arrive
            # whole: record their parts, as outside it
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        rec = self.rec
        name = func._overloadpacket.__name__
        depth = _build.gate_depth()
        if func.namespace == "c10d":
            self._collective(name, args, depth)
            return out
        ins = _leaves((args, kwargs))
        on_host = bool(ins) and all(storage_key(t) in self._host for t in ins)
        if on_host:
            self._host.update(storage_key(t) for t in _leaves(out))
        elif _is_sync(name, args, kwargs):
            rec.syncs.append(name)
            if name in _HOST_READS and not all(
                    self._is_uniform(t) for t in ins):
                self._branch = {"read": name, "collectives": []}
        if name in _GATHER_OPS and torch.is_tensor(out):
            self._gather(name, args, out, depth)
        flop = _flop_registry().get(func._overloadpacket)
        if flop is not None:
            rec.flops += int(flop(*args, **kwargs, out_val=out))
        self._mark(_leaves(out), all(self._is_uniform(t) for t in ins))
        return out

    def _collective(self, name, args, depth):
        op, at = _COLLECTIVES.get(name, (name, 0))
        payload = _leaves(args[at] if len(args) > at else ())
        t = payload[0] if payload else None
        self.rec.collectives.append(Collective(
            op, str(t.dtype) if t is not None else "",
            tuple(t.shape) if t is not None else (),
            sum(_nbytes(p) for p in payload), depth))
        if op in _UNIFORM_OUT:
            self._mark(_leaves(args[0]), True)
        elif op != "barrier":
            self._mark(_leaves(args[0]), False)
        if self._branch is not None:
            if not self._branch["collectives"]:
                self.rec.divergent.append(self._branch)
            self._branch["collectives"].append(op)

    def _gather(self, name, args, out, depth):
        table = args[0]
        if name in ("index", "_unsafe_index"):
            idx = [i for i in args[1] if i is not None]
            if len(idx) != 1 or idx[0].dtype == torch.bool \
                    or args[1][0] is None:
                return
            index = idx[0]
        else:
            index = args[2] if name in ("index_select", "gather") \
                else args[1]
        if not torch.is_tensor(index):
            return
        if name == "embedding":
            rows = int(index.numel())
        else:
            rows = int(out.shape[0]) if out.dim() else 1
        self.rec.gathers.append(Gather(
            name, table, rows, _nbytes(out), storage_key(index),
            _nbytes(index), depth))


def _is_sync(name, args, kwargs) -> bool:
    if name in _SYNC_OPS:
        return True
    if name == "repeat_interleave":
        return torch.is_tensor(args[0]) and \
            kwargs.get("output_size") is None and \
            (len(args) < 4 or args[3] is None)
    if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
        return any(torch.is_tensor(i) and i.dtype in (torch.bool,
                                                      torch.uint8)
                   for i in (args[1] or ()) if i is not None)
    if name in ("_to_copy", "copy_"):
        src = args[1] if name == "copy_" else args[0]
        dst = kwargs.get("device") if name == "_to_copy" else args[0].device
        return torch.is_tensor(src) and src.is_cuda and dst is not None \
            and torch.device(dst).type == "cpu"
    return False


_FLOPS: Optional[dict] = None


def _flop_registry() -> dict:
    global _FLOPS
    if _FLOPS is None:
        from torch.utils.flop_counter import flop_registry
        _FLOPS = flop_registry
    return _FLOPS


def record(fn: Callable, args: Sequence = (), kwargs=None) -> Recording:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpRecorder`
    with the kernel wrappers reporting to it; the result is on
    ``Recording.out``, the wrappers' launches (``_build.LAUNCHES``
    delta: 0 on the CPU) on ``launches``, and the loaded kernel
    libraries before and after."""
    before = dict(_build.LAUNCHES)
    libs = _build.loaded_libraries._cache_size()
    rec_mode = OpRecorder(_host_scalars(args))
    token = _build._RECORDER.set(rec_mode)
    try:
        with rec_mode:
            out = fn(*args, **(kwargs or {}))
    finally:
        _build._RECORDER.reset(token)
    rec = rec_mode.rec
    rec.out = out
    devs = {t.device.type for t in _leaves((args, out))}
    rec.device = "cuda" if "cuda" in devs else "cpu"
    rec.launches = {k: v - before.get(k, 0)
                    for k, v in _build.LAUNCHES.items()
                    if v - before.get(k, 0)}
    rec.libraries_before = libs
    rec.libraries_after = _build.loaded_libraries._cache_size()
    return rec


def card_host_syncs(fn: Callable, args: Sequence = (), kwargs=None):
    """``(out, n)``: ``fn(*args)`` run on the card under
    ``torch.cuda.set_sync_debug_mode("warn")``, ``n`` the host
    synchronisations the card reported. The one implementation of
    "does this wait for the card" that the registry's rule and
    ``chip_smoke.py`` share: a path is sync-free when ``n == 0``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args, **(kwargs or {}))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n = sum("called a synchronizing CUDA operation" in str(w.message)
            for w in seen)
    return out, n


def compare_sequences(sequences: Sequence[List[tuple]],
                      entry: str = "<ranks>") -> List[Finding]:
    """The cross-rank half of ``collective_divergence``: every rank's
    recorded collective sequence (``Recording.sequence()``, gathered by
    the caller) must be the same."""
    ref = list(sequences[0]) if sequences else []
    bad = [r for r, s in enumerate(sequences) if list(s) != ref]
    if not bad:
        return []
    return [Finding(
        "collective_divergence", ERROR, entry,
        f"rank(s) {bad} issued another collective sequence than rank 0 "
        f"({len(ref)} collectives there) — the group would deadlock or "
        "mismatch payloads",
        {"ranks": bad, "rank0": [list(map(str, c)) for c in ref]})]


# ---------------------------------------------------------------------------
# entry points + the rule registry
# ---------------------------------------------------------------------------


@dataclass
class CensusSpec:
    """The declared reachable-program lattice of one entry point.

    ``axes`` maps a knob name to its DISCRETE value lattice (any finite
    sequence) or directly to an int cardinality. A ``None`` (or any
    non-enumerable) axis means the knob is unbounded — the census rule
    ERRORs. The reachable program count is the product of the axis
    cardinalities and must not exceed ``max_programs``."""

    axes: Dict[str, Any]
    max_programs: int

    def axis_count(self, value) -> Optional[int]:
        if value is None or isinstance(value, bool):
            return None
        if isinstance(value, (str, bytes)):
            # a bare string is a typo'd one-element tuple, not a
            # lattice of its characters — refuse rather than miscount
            return None
        if isinstance(value, int):
            return value if value > 0 else None
        try:
            n = len(value)
        except TypeError:
            return None
        return n if n > 0 else None

    def count(self) -> Optional[int]:
        """Reachable program count, or None if any axis is unbounded."""
        total = 1
        for v in self.axes.values():
            n = self.axis_count(v)
            if n is None:
                return None
            total *= n
        return total


@dataclass
class EntrySpec:
    """One registered hot path and the invariants it promises.

    ``fn``/``args`` give the one recorded run every rule reads.
    ``donate_argnums`` names the args the entry updates in place.
    ``host_syncs`` is the documented number of host synchronisations a
    call makes (0 unless the entry documents one). ``tier_budgets`` is
    a tuple of ``(tier, max_rows, max_depth)``: the gathers on the
    tier's storage read at most ``max_rows`` rows at gate depth <=
    ``max_depth``. ``exchange`` bounds ``all_to_all`` payloads:
    ``{"prims": ("all_to_all",), "dense_bytes": int, "max_frac": f,
    "dense_shapes": (shape, ...)}``. ``rules=None`` runs every rule."""

    name: str
    fn: Callable
    args: Tuple = ()
    donate_argnums: Tuple[int, ...] = ()
    sync_free: bool = True
    host_syncs: int = 0
    tier_budgets: Tuple = ()
    exchange: Optional[Dict] = None
    census: Optional[CensusSpec] = None
    rules: Optional[Sequence[str]] = None
    detail: Dict = field(default_factory=dict)
    _recording: Any = field(default=None, repr=False)
    _inplace: Any = field(default=None, repr=False)
    card_syncs: Optional[int] = None

    def recording(self) -> Recording:
        """The one recorded run (cached: every rule reads this)."""
        if self._recording is None:
            before = {i: {p: storage_key(t)
                          for p, t in _paths(self.args[i]).items()}
                      for i in self.donate_argnums}
            self._recording = record(self.fn, self.args)
            self._inplace = before
        return self._recording


def rule_no_host_sync(spec: EntrySpec):
    if not spec.sync_free:
        return []
    rec = spec.recording()
    syncs = rec.syncs
    out = []
    if len(syncs) != spec.host_syncs:
        by_op: Dict[str, int] = {}
        for p in syncs:
            by_op[p] = by_op.get(p, 0) + 1
        ops = ", ".join(f"{p} x{n}" for p, n in sorted(by_op.items()))
        out.append(Finding(
            "no_host_sync", ERROR, spec.name,
            f"recorded run makes {len(syncs)} host synchronisation(s) "
            f"({ops or 'none'}), the entry declares {spec.host_syncs} — "
            "counters and "
            "telemetry must ride out as device tensors",
            {"primitives": by_op, "declared": spec.host_syncs}))
    if rec.device == "cuda":
        _, spec.card_syncs = card_host_syncs(spec.fn, spec.args)
        if spec.card_syncs != len(syncs):
            out.append(Finding(
                "no_host_sync", ERROR, spec.name,
                f"the card's sync debug mode counts {spec.card_syncs} "
                f"host synchronisation(s), the recorder {len(syncs)} — "
                "the two verdicts disagree",
                {"card": spec.card_syncs, "recorded": len(syncs)}))
    return out


def rule_donation_honored(spec: EntrySpec):
    if not spec.donate_argnums:
        return []
    spec.recording()
    unmatched = []
    for argnum, before in spec._inplace.items():
        after = {p: storage_key(t)
                 for p, t in _paths(spec.args[argnum]).items()}
        for path, key in before.items():
            if after.get(path) != key:
                t = _paths(spec.args[argnum]).get(path)
                unmatched.append({
                    "argnum": argnum, "path": path,
                    "shape": list(t.shape) if t is not None else None,
                    "dtype": str(t.dtype) if t is not None else None})
    if not unmatched:
        return []
    head = ", ".join(f"arg {u['argnum']}: {u['path']}"
                     for u in unmatched[:4])
    return [Finding(
        "donation_honored", ERROR, spec.name,
        f"{len(unmatched)} in-place tensor(s) were replaced instead of "
        f"updated ({head}) — the step allocates a new state every call "
        "and the caller's references go stale; update in place or drop "
        "donate_argnums",
        {"unmatched": unmatched})]


def rule_collective_divergence(spec: EntrySpec):
    out = []
    for d in spec.recording().divergent:
        prims = sorted(set(d["collectives"]))
        out.append(Finding(
            "collective_divergence", ERROR, spec.name,
            f"collective(s) {'/'.join(prims)} issued after a host read "
            f"({d['read']}) of a value that is NOT uniform across the "
            "group — ranks can take different branches and deadlock the "
            "collective; all_reduce(MAX) the predicate over the group "
            "first",
            {"collectives": prims, "read": d["read"]}))
    return out


def tier_components(tier) -> List[Tuple[Tuple[int, int], str]]:
    """``(byte range, label)`` of each leaf of a tier (codes, scale and
    zero of an int8 tier; one range each, overlapping when packed)."""
    return [(span(t), f"{tuple(t.shape)}:{t.dtype}") for t in _leaves(tier)]


def tier_reads(rec: Recording) -> List[Tuple[list, int, int]]:
    """``(table byte ranges, rows, depth)`` of every gather the
    recording saw: aten index ops and kernel calls."""
    out = [([span(g.table)], g.rows, g.depth) for g in rec.gathers]
    for call in rec.kernels:
        for table, rows in kernel_reads(call):
            out.append((spans(table), rows, call.depth))
    return out


def rule_traffic_budget(spec: EntrySpec):
    out = []
    rec = spec.recording()
    reads = tier_reads(rec)
    for tier, max_rows, max_depth in spec.tier_budgets:
        for rng, label in tier_components(tier):
            hits = [r for s, r, d in reads
                    if overlaps(s, [rng]) and d <= max_depth]
            total = sum(hits)
            if total > max_rows:
                out.append(Finding(
                    "traffic_budget", ERROR, spec.name,
                    f"gathers read {total} rows total ({len(hits)} "
                    f"gather(s)) from the {label} tier at gate depth <= "
                    f"{max_depth} — budget is {max_rows} rows "
                    "(dedup/compaction bound violated)",
                    {"rows": int(total), "budget": int(max_rows),
                     "tier": label, "gathers": len(hits)}))
    ex = spec.exchange
    if ex:
        prims = tuple(ex.get("prims", ("all_to_all",)))
        payloads = [c for c in rec.collectives if c.op in prims]
        dense_shapes = {tuple(s) for s in ex.get("dense_shapes", ())}
        for c in payloads:
            if c.shape in dense_shapes and c.depth == 0:
                out.append(Finding(
                    "traffic_budget", ERROR, spec.name,
                    f"dense-shaped collective payload {c.shape} {c.dtype} "
                    "on the unconditional path — the dense exchange must "
                    "run only as the gated fallback",
                    {"shape": list(c.shape), "bytes": c.nbytes}))
        dense_bytes = ex.get("dense_bytes")
        max_frac = ex.get("max_frac", 0.25)
        if dense_bytes:
            narrow = sum(c.nbytes for c in payloads
                         if c.shape not in dense_shapes)
            if narrow > max_frac * dense_bytes:
                out.append(Finding(
                    "traffic_budget", ERROR, spec.name,
                    f"compact-exchange payload is {narrow} bytes > "
                    f"{max_frac:.2f} x dense ({dense_bytes} bytes) — "
                    "the exchange is no longer narrow (cap oversized?)",
                    {"narrow_bytes": int(narrow),
                     "dense_bytes": int(dense_bytes),
                     "max_frac": max_frac}))
    return out


def rule_executable_census(spec: EntrySpec):
    c = spec.census
    if c is None:
        return []
    out = []
    unbounded = [k for k, v in c.axes.items() if c.axis_count(v) is None]
    if unbounded:
        return [Finding(
            "executable_census", ERROR, spec.name,
            f"knob axis/axes {', '.join(sorted(unbounded))} are "
            "UNBOUNDED — the reachable program set cannot be "
            "enumerated, so the set of kernel builds is not provably "
            "flat; declare a finite discrete lattice",
            {"unbounded_axes": sorted(unbounded)})]
    n = c.count()
    axes = {k: c.axis_count(v) for k, v in c.axes.items()}
    if n > c.max_programs:
        out.append(Finding(
            "executable_census", ERROR, spec.name,
            f"census of {n} reachable programs exceeds the declared "
            f"bound of {c.max_programs} (axes: {axes})",
            {"count": n, "max_programs": c.max_programs}))
    libs = spec.recording().libraries_after
    out.append(Finding(
        "executable_census", INFO, spec.name,
        f"{n} reachable program(s) (axes: {axes}, bound "
        f"{c.max_programs}); {libs} kernel librar(y/ies) loaded",
        {"count": n, "max_programs": c.max_programs,
         "libraries": libs}))
    return out


RULES: Dict[str, Callable] = {
    "no_host_sync": rule_no_host_sync,
    "donation_honored": rule_donation_honored,
    "collective_divergence": rule_collective_divergence,
    "traffic_budget": rule_traffic_budget,
    "executable_census": rule_executable_census,
}


def run_rules(spec: EntrySpec, rules: Optional[Sequence[str]] = None):
    """Run ``rules`` (default: the entry's own list, else all) against
    one entry point. Returns the findings list (possibly empty)."""
    names = rules or spec.rules or tuple(RULES)
    out = []
    for name in names:
        out += RULES[name](spec)
    return out
