"""The readings that limits are set from, all in one process:

    python3 -m qbench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--seconds 2]

For each of ``--seeds`` it runs the cell (a short window at the cell's
own sizes and load) and prints the program's readings; for each of
``--control-seeds`` the control's (the reference in the precision below
the configuration's, or the sampler that breaks its guarantee, in the
program's place); for each of ``--fault-seeds`` the readings with each
fault of ``qbench/faults.py`` planted in the program. One JSON line a
reading, on standard output and in ``build/qbench/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

from . import faults, run, spec


def _line(f, rec):
    s = json.dumps(rec)
    print(s, flush=True)
    f.write(s + "\n")
    f.flush()


def _ints(s):
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m qbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--buckets", default="",
                   help="seeds to run one window of with its units "
                        "counted in 2-second buckets")
    args = p.parse_args(argv)
    run._cache_dirs(spec.root())
    import torch
    if not torch.cuda.is_available():
        print("qbench: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    kind = cell.traffic["driver"]
    out_dir = spec.root() / "build" / "qbench"
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"calibrate_{args.workload}.jsonl", "a") as f:
        for seed in _ints(args.buckets):
            _line(f, {"side": "buckets", "seed": seed, "units_per_s":
                      buckets(cell, seed, args.seconds, dev)})
        for seed in _ints(args.seeds):
            drv = _run(cell, seed, args.seconds, dev)
            _line(f, {"side": "program", "seed": seed,
                      "readings": _clean(drv.readings())})
        for seed in _ints(args.control_seeds):
            drv = _run(cell, seed, args.seconds, dev)
            _line(f, {"side": "control", "seed": seed,
                      "readings": _clean(drv.control_readings())})
        for seed in _ints(args.fault_seeds):
            for name in faults.DRIVER_FAULTS[kind]:
                with faults.FAULTS[name](kind):
                    drv = _run(cell, seed, args.seconds, dev)
                _line(f, {"side": f"fault:{name}", "seed": seed,
                          "readings": _clean(drv.readings())})
    return 0


def _run(cell, seed, seconds, dev):
    """Set up, run a short window, and release the program's state;
    returns the driver, ready for its readings."""
    import torch
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, dev)
    drv.setup()
    units, secs = run.window(drv, seconds)[:2]
    drv.end_to_end(units, secs)
    drv.release()
    torch.cuda.synchronize(dev)
    return drv


def _clean(d):
    return {k: (v if not isinstance(v, float) or math.isfinite(v)
                else str(v)) for k, v in d.items()}


def buckets(cell, seed, seconds, dev, width=2.0):
    """Units a ``width``-second bucket over one window, each bucket
    closed by a synchronise: whether the window runs at one pace."""
    import time
    import torch
    drv = spec.driver(cell.traffic["driver"]).Driver(cell, seed, dev)
    drv.setup()
    i, out, t0 = drv.first_unit, [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        b0, n = time.perf_counter(), 0
        while time.perf_counter() - b0 < width:
            drv.unit(i)
            i += 1
            n += 1
        torch.cuda.synchronize(dev)
        out.append(round(n / (time.perf_counter() - b0), 2))
    return out


if __name__ == "__main__":
    sys.exit(main())
