"""Host-side AST verifier (the port's copy of
``quiver_tpu/analysis/host_lint.py``): the bug classes code review
catches by hand, checked mechanically over the port's source tree.
Standard library ``ast`` only, so ``python -m quiver_tpu_torch.analysis
--host-only`` runs in milliseconds without importing torch.

``lock_held_emit``     a JSONL sink emission (``*.emit(...)`` /
                       ``*.emit_stats(...)``) inside a ``with <lock>:``
                       block: a slow sink disk stalls every thread
                       contending on that hub/server lock (queue under
                       the lock, emit after release).
``resource_finalizer`` a class that stores a ``threading.Thread`` /
                       ``Pipeline`` / ``ThreadPoolExecutor`` on
                       ``self`` must define ``close()``; a non-daemon
                       thread or an executor additionally needs a
                       ``weakref.finalize`` safety net (a ``Pipeline``
                       carries its own finalizer; a daemon thread dies
                       with the process and ``close()`` reaps it
                       deterministically).
``hot_path_blocking``  inside a function marked ``@hot_path``
                       (``quiver_tpu_torch.profiling.hot_path``), no
                       blocking host sync: torch's ``.item()``,
                       ``.tolist()``, ``.cpu()``, ``.numpy()``,
                       ``torch.cuda.synchronize()`` and
                       ``Event``/``Stream.synchronize()``; and, as in
                       the JAX package, ``device_get``,
                       ``.block_until_ready()`` and ``np.asarray``/
                       ``np.array`` (each reads a device array back).
``swallowed_worker_exception``
                       a bare / over-broad ``except`` (``except:``,
                       ``except Exception``, ``except BaseException``)
                       inside a ``while`` loop whose handler neither
                       re-raises, nor calls anything (logging, a
                       counter method, failing a future), nor mutates
                       state (a ``+= 1`` counter) — the worker-loop
                       swallow the fault injector keeps finding: the
                       loop looks healthy while silently dropping its
                       work. Count it, log it, or re-raise it.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Iterable, List, Optional

from .findings import ERROR, Finding

# resource constructors the lifecycle rule tracks: name -> whether the
# type carries its OWN weakref.finalize (Pipeline does — pipeline.py;
# ExtentReader binds one to its pool+fds — io.py; a class storing
# either must still define close() for deterministic shutdown)
_RESOURCES = {"Thread": False, "ThreadPoolExecutor": False,
              "Pipeline": True, "ExtentReader": True}

# JAX's four, then torch's: a card tensor read back to the host, and
# every way to wait for the card (torch.cuda.synchronize, an event's or
# a stream's synchronize)
_BLOCKING_ATTRS = ("block_until_ready", "device_get", "item", "tolist",
                   "cpu", "numpy", "synchronize")


def _call_name(func) -> str:
    """Trailing identifier of a call target: ``threading.Thread`` ->
    ``Thread``, ``Pipeline`` -> ``Pipeline``."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


_LOCK_NAME = re.compile(r"(^|_)locks?($|_)")


def _mentions_lock(expr) -> bool:
    """Does a with-item context expression name a lock? (``self._lock``,
    ``hub._lock``, ``self._counts_lock``, a bare ``lock`` variable.)
    Word-boundary match — ``block``/``blocking`` must not count."""
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        if name and _LOCK_NAME.search(name.lower()):
            return True
    return False


def _is_daemon_thread(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


def _emit_calls(expr):
    """``*.emit*(...)`` calls inside one expression — pruning lambda
    bodies (they run later, not under the enclosing lock)."""
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and \
                node.func.attr.startswith("emit"):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def _check_lock_held_emit(tree, path: str) -> List[Finding]:
    out = []

    def flag(expr):
        for call in _emit_calls(expr):
            out.append(Finding(
                "lock_held_emit", ERROR, f"{path}:{call.lineno}",
                f"sink emission `{ast.unparse(call.func)}(...)` while "
                "holding a lock — a slow sink disk stalls every thread "
                "contending on it; queue under the lock, emit after "
                "release"))

    def scan(stmts, held):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                scan(node.body, False)     # runs later, lock released
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = held or any(_mentions_lock(i.context_expr)
                                    for i in node.items)
                if held:
                    for i in node.items:
                        flag(i.context_expr)
                scan(node.body, inner)
                continue
            if held:
                # header expressions of this statement only — the
                # nested statement lists recurse below
                for _, value in ast.iter_fields(node):
                    vals = value if isinstance(value, list) else [value]
                    for v in vals:
                        if isinstance(v, ast.expr):
                            flag(v)
            # every nested statement list (if/for/try bodies, orelse,
            # finally, except handlers, match cases) keeps the lock
            for _, value in ast.iter_fields(node):
                if not isinstance(value, list) or not value:
                    continue
                if isinstance(value[0], ast.stmt):
                    scan(value, held)
                else:
                    for item in value:
                        body = getattr(item, "body", None)
                        if isinstance(body, list) and body and \
                                isinstance(body[0], ast.stmt):
                            scan(body, held)

    scan(tree.body, False)
    return out


def _walk_pruning_classes(node):
    """``ast.walk`` that does not descend into nested ClassDefs — a
    nested class's resources belong to ITS scan, not the outer one."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, ast.ClassDef):
            stack.extend(ast.iter_child_nodes(n))


def _self_stored_resources(cls):
    """Resource constructor calls a class actually STORES on self —
    directly (``self.x = Thread(...)``) or through a local that a
    later statement in the same method assigns to self
    (``t = Thread(...); ...; self._t = t``). A scoped worker that is
    joined and dropped cannot leak and is not collected."""
    created = []      # (resource_name, call_node)
    for fn in _walk_pruning_classes(cls):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
        local_res = {}                  # local name -> (res, call)
        for node in assigns:            # pass 1: locals holding one
            if isinstance(node.value, ast.Call) and \
                    _call_name(node.value.func) in _RESOURCES:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        local_res[t.id] = (_call_name(node.value.func),
                                           node.value)
        for node in assigns:            # pass 2: what lands on self
            for t in node.targets:
                if not (isinstance(t, ast.Attribute) and isinstance(
                        t.value, ast.Name) and t.value.id == "self"):
                    continue
                v = node.value
                if isinstance(v, ast.Call) and \
                        _call_name(v.func) in _RESOURCES:
                    created.append((_call_name(v.func), v))
                elif isinstance(v, ast.Name) and v.id in local_res:
                    created.append(local_res[v.id])
    return [(name, call.lineno,
             not _RESOURCES[name] and not (name == "Thread"
                                           and _is_daemon_thread(call)))
            for name, call in created]


def _check_resource_finalizer(tree, path: str) -> List[Finding]:
    out = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        has_close = False
        has_finalize = False
        for node in _walk_pruning_classes(cls):
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef)) and \
                    node.name == "close":
                has_close = True
            if isinstance(node, ast.Call):
                name = _call_name(node.func)
                if name == "finalize" and isinstance(
                        node.func, ast.Attribute) and \
                        _call_name(node.func.value) in ("weakref",):
                    has_finalize = True
        created = _self_stored_resources(cls)
        if not created:
            continue
        names = sorted({n for n, _, _ in created})
        line = min(l for _, l, _ in created)
        if not has_close:
            out.append(Finding(
                "resource_finalizer", ERROR, f"{path}:{line}",
                f"class {cls.name} creates {'/'.join(names)} but "
                "defines no close() — the worker outlives the object "
                "across long runs; add idempotent close() (and a "
                "weakref.finalize safety net)"))
        elif any(nf for _, _, nf in created) and not has_finalize:
            bad = sorted({n for n, _, nf in created if nf})
            out.append(Finding(
                "resource_finalizer", ERROR, f"{path}:{line}",
                f"class {cls.name} creates {'/'.join(bad)} with no "
                "weakref.finalize safety net — an abandoned (never "
                "closed) instance leaks its worker; bind a finalizer "
                "to the resource (not self), or make the thread "
                "daemon=True with close() reaping it"))
    return out


def _hot_path_marked(fn) -> bool:
    for dec in fn.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        if _call_name(target) == "hot_path":
            return True
    return False


def _check_hot_path_blocking(tree, path: str) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _hot_path_marked(fn):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Attribute) and \
                    func.attr in _BLOCKING_ATTRS:
                what = f".{func.attr}()"
            elif isinstance(func, ast.Attribute) and \
                    func.attr in ("asarray", "array") and isinstance(
                        func.value, ast.Name) and \
                    func.value.id in ("np", "numpy"):
                what = f"np.{func.attr}(...)"
            else:
                continue
            out.append(Finding(
                "hot_path_blocking", ERROR, f"{path}:{node.lineno}",
                f"blocking host sync {what} inside @hot_path function "
                f"`{fn.name}` — the hot path must stay sync-free "
                "(read back at the edges, never per step)"))
    return out


_BROAD_EXC = ("Exception", "BaseException")


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    """bare ``except:`` or ``except Exception/BaseException``
    (including as one element of a tuple)."""
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for e in types:
        name = e.attr if isinstance(e, ast.Attribute) else \
            getattr(e, "id", "")
        if name in _BROAD_EXC:
            return True
    return False


def _handler_reacts(handler: ast.ExceptHandler) -> bool:
    """Does the handler body count, log, or re-raise? Any ``raise``,
    any call (logging, a counter/stat method, failing a future), or
    any assignment/aug-assignment (``self.errors += 1``) counts as a
    reaction; ``pass``/``continue``/``break``/bare returns do not."""
    for node in ast.walk(handler):
        if isinstance(node, (ast.Raise, ast.Call, ast.AugAssign,
                             ast.Assign)):
            return True
    return False


def _check_swallowed_worker_exception(tree, path: str) -> List[Finding]:
    out = []

    def scan(node, in_loop):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                scan(child, False)      # a nested scope is its own loop
                continue
            # ``while`` loops only: a worker loop spins until told to
            # stop; a bounded ``for`` (shutdown best-effort sweeps,
            # result collection) retires its work either way, and its
            # swallow is judged by the surrounding code
            inner = in_loop or isinstance(child, ast.While)
            if isinstance(child, ast.ExceptHandler) and in_loop and \
                    _is_broad_handler(child) and \
                    not _handler_reacts(child):
                what = ("bare except" if child.type is None
                        else f"except {ast.unparse(child.type)}")
                out.append(Finding(
                    "swallowed_worker_exception", ERROR,
                    f"{path}:{child.lineno}",
                    f"{what} inside a worker loop neither counts, "
                    "logs, nor re-raises — the loop keeps spinning "
                    "while silently dropping its work (the class the "
                    "fault injector keeps finding); increment a "
                    "counter, log once, or re-raise"))
            scan(child, inner)

    scan(tree, False)
    return out


_CHECKS = (_check_lock_held_emit, _check_resource_finalizer,
           _check_hot_path_blocking, _check_swallowed_worker_exception)

HOST_RULES = ("lock_held_emit", "resource_finalizer",
              "hot_path_blocking", "swallowed_worker_exception")


# the findings the port's tree keeps by design, each with its reason:
# (rule, file the finding's entry names, text its message holds, why)
DOCUMENTED = (
    ("hot_path_blocking", "quiver_tpu_torch/comm.py",
     "`dist_lookup_local`",
     "the compact exchange's one .item() of its all_reduce(MAX)-ed "
     "overflow flag: every rank takes the same branch, where JAX's "
     "lax.cond needs no host read"),
)


def documented(finding: Finding) -> Optional[str]:
    """The reason a finding is a documented deviation of the port's
    tree (:data:`DOCUMENTED`), or None."""
    for rule, path, text, why in DOCUMENTED:
        if finding.rule == rule and path in finding.entry.replace(
                "\\", "/") and text in finding.msg:
            return why
    return None


def check_source(src: str, path: str = "<string>") -> List[Finding]:
    """Run every host-lint rule over one source string."""
    tree = ast.parse(src)
    out: List[Finding] = []
    for check in _CHECKS:
        out += check(tree, path)
    return out


def default_paths(root=".") -> List[pathlib.Path]:
    """Every Python source of the port's package under ``root``."""
    out = sorted((pathlib.Path(root) / "quiver_tpu_torch").rglob("*.py"))
    return [p for p in out if "__pycache__" not in p.parts]


def run_host_lint(paths: Optional[Iterable] = None,
                  root=".") -> List[Finding]:
    """Host-lint a set of files (default: the port's package)."""
    out: List[Finding] = []
    for p in (paths if paths is not None else default_paths(root)):
        p = pathlib.Path(p)
        out += check_source(p.read_text(), str(p))
    return out
