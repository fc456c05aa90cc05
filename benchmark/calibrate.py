"""Read the numbers that set a cell's limits of ``correct``, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 [--out FILE]

For each of ``--seeds`` the program's own numbers (its sound runs: the
lower reading); for each of ``--control-seeds`` the control's (the float32
reference computed in fp8 in the program's place: the upper reading); for
each of ``--fault-seeds`` every fault the window plants (its ``FAULTS``,
and over several cards its ``MESH_FAULTS``);
for each of ``--witness-seeds`` the program's computing in float32, a
second witness beside the reference (training). The readings are the
window's ``readings`` (all in one call, printed together at its end; over
several cards the program's on the ranks of one launch), or one by one its
``reading``, at the cell's own sizes, without a timed window. One JSON line
a reading, to standard output and ``--out``. Needs a card; the benchmark's
runs never call this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--witness-seeds", default="", help="training: the program computing in float32")
    ap.add_argument("--faults", default="", help="the planted faults to read (default: every one)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from harness import registry

    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.workload(args.workload)
    mod = registry.window(cell["kind"])
    planted = dict(mod.FAULTS, **(getattr(mod, "MESH_FAULTS", {}) if cell["chips"] > 1 else {}))
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    chosen = [f for f in args.faults.split(",") if f] or sorted(planted)
    jobs = [("program", "program", s, None) for s in seeds(args.seeds)]
    jobs += [("control", "control", s, None) for s in seeds(args.control_seeds)]
    jobs += [(name, "program", s, planted[name]) for s in seeds(args.fault_seeds) for name in chosen]
    jobs += [("float32_program", "float32_program", s, None) for s in seeds(args.witness_seeds)]
    out = open(args.out, "a") if args.out else None

    def emit(label, seed, numbers, seconds):
        line = json.dumps({"cell": args.workload, "reading": label, "seed": seed, "numbers": numbers,
                           "seconds": seconds})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        if hasattr(mod, "readings"):  # every reading in one call (over several cards, on one launch's ranks)
            t0 = time.perf_counter()
            got = mod.readings(cell, [(seed, hook, what) for _, what, seed, hook in jobs], device)
            for (label, _, seed, _), numbers in zip(jobs, got):
                emit(label, seed, numbers, (time.perf_counter() - t0) / len(jobs))
        else:
            for label, what, seed, hook in jobs:
                t0 = time.perf_counter()
                emit(label, seed, mod.reading(cell, seed, device, hook=hook, what=what), time.perf_counter() - t0)
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
