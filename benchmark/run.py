"""Run one cell of the benchmark of ``object_detection_cib_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. The cell is ``benchmark/workloads/<cell>.json``; its ``kind`` picks
the window, ``benchmark/harness/<kind>_cell.py``. With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics (each
read by ``benchmark/metrics/<metric>.py`` from the traced record) and a
breakdown. The last line of standard output is one JSON object; the last
lines of standard error, and the result's last key, give each number that
decided ``correct`` beside its limit. Exits non-zero, printing no result,
without a card, or if JAX or the JAX package was loaded (here or, over
several cards, in a rank: the window raises).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

def card(chips: int):
    """The first card, or None (and why) where there are too few."""
    import torch

    if not torch.cuda.is_available():
        return None, "torch.cuda.is_available() is False"
    if torch.cuda.device_count() < chips:
        return None, f"{torch.cuda.device_count()} cards, the cell asks for {chips}"
    return torch.device("cuda", 0), None


def smi(query: str) -> list:
    """``nvidia-smi``'s reading of ``query``, a line a card (none if it
    cannot be read)."""
    try:
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def power_limit() -> str:
    return (smi("name,power.limit") or ["not read"])[0]


def card_state(chips: int) -> str:
    """Each card's SM clock, its maximum, temperature and power draw as the
    run ends: what a drift between runs is looked for in."""
    return "; ".join(smi("index,clocks.sm,clocks.max.sm,temperature.gpu,power.draw")[:chips]) or "not read"


def result(cell: dict, out: dict, bench: dict, traced: bool, kind: str) -> dict:
    """The result line: correct, attempted, failed, metrics, device (the
    card's name ``kind``), breakdown (traced), and the numbers compared
    last."""
    from harness import judge, registry, tracing

    limits = cell["limits"]
    numbers = out["numbers"]
    metrics = {}
    for name, unit in registry.metrics_for(cell["name"], bench, traced).items():
        value = registry.reader(name)(out["record"]) if traced else out["e2e"].get(name)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    dev = {"platform": "gpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": judge.verdict(numbers, limits) and out["failed"] == 0, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = out["record"]["busy_s"], out["record"]["window_s"]
        line["breakdown"] = tracing.breakdown(out["record"])
    line["checks"] = {k: {"value": _number(numbers.get(k, float("nan"))), "limit": v} for k, v in limits.items()}
    return line


def _number(x: float):
    """A finite number as it is; inf or nan as text, which JSON can hold."""
    return x if math.isfinite(x) else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import registry
    from harness.loaded import forbidden_modules

    cell = registry.workload(args.workload)
    bench = registry.spec()
    device, why = card(cell["chips"])
    if device is None:
        print(f"benchmark: no card to run on: {why}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    out = registry.window(cell["kind"]).run(cell, args.seed, args.seconds, bool(args.trace), device, T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    import torch

    line = result(cell, out, bench, bool(args.trace), torch.cuda.get_device_name(device))
    print(f"benchmark: {args.workload} seed {args.seed} on {power_limit()}; window {out['window_s']:.3f} s, "
          f"set-up {out['setup_s']:.3f} s", file=sys.stderr)
    print(f"benchmark: cards as the run ends (index, SM clock, its maximum, temperature, power): "
          f"{card_state(cell['chips'])}", file=sys.stderr)
    if out.get("detail"):
        print(f"benchmark: {out['detail']}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
