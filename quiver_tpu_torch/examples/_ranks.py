"""What the examples share: the ``--device`` flag, and the launch of a
rank function over a ``torch.distributed`` group.

:func:`run` joins ``torchrun``'s group when the environment names one
(``RANK`` and ``WORLD_SIZE``); started plainly, it runs one rank per
visible card over NCCL (with one card, in this process), or
``CPU_RANKS`` gloo ranks with ``--device cpu``. Spawned ranks
rendezvous through a file in a fresh temporary directory, every
collective is bounded by ``TIMEOUT_S``, and when a rank fails the
others are stopped and the run exits non-zero. Each rank builds its
inputs from numpy and puts them on its own device.
"""

import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time

CPU_RANKS = 2
TIMEOUT_S = 300.0


def add_device_flag(p) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the tensors live: the card (default; "
                        "raises where there is none) or the CPU")


def quiet(*_args, **_kw) -> None:
    """``print`` on the ranks that do not report."""


def run(fn, args) -> int:
    """``fn(args, rank, world, group, device) -> int`` on every rank of
    a group (see the module docstring); returns 0 when every rank
    returned 0."""
    import torch

    from ..utils.device import resolve_device
    backend = "nccl" if args.device == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        return _rank(fn, args, backend, None, rank,
                     int(os.environ["WORLD_SIZE"]),
                     int(os.environ.get("LOCAL_RANK", rank)))
    if args.device == "cuda":
        resolve_device("cuda")            # raises without a card
        world = torch.cuda.device_count()
    else:
        world = CPU_RANKS
    tmp = tempfile.mkdtemp(prefix="qt_example_ranks_")
    init = f"file://{tmp}/rendezvous"
    try:
        if world == 1:
            return _rank(fn, args, backend, init, 0, 1, 0)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_child,
                             args=(fn, args, backend, init, r, world))
                 for r in range(world)]
        for p in procs:
            p.start()
        return _join(procs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _join(procs) -> int:
    """Wait for every rank; when one fails, stop the rest."""
    while any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            for p in procs:
                if p.is_alive():
                    p.terminate()
            break
        time.sleep(0.1)
    for p in procs:
        p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        print(f"rank(s) {bad} failed (exit codes "
              f"{[procs[r].exitcode for r in bad]})", file=sys.stderr)
        return 1
    return 0


def _child(fn, args, backend, init, rank, world):
    sys.exit(_rank(fn, args, backend, init, rank, world, rank))


def _rank(fn, args, backend, init, rank, world, local) -> int:
    import torch
    import torch.distributed as dist
    from ..comm import init_distributed
    if backend == "nccl":
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    else:
        dev = torch.device("cpu")
        if world > 1:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = init_distributed(backend, init, world, rank, timeout=TIMEOUT_S)
    try:
        return fn(args, rank, world, group, dev)
    finally:
        dist.destroy_process_group()
