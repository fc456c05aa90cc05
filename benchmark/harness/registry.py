"""Everything the harness runs is found by name, in files of its own.

  * ``configs/<config>.json``: a model configuration (source, reduced,
    assumed, and the source's ``nc``, ``depth_multiple``, ``width_multiple``);
  * ``workloads/<cell>.json``: a cell (its configuration, ``kind``,
    ``chips``, sizes, traffic, the limits of ``correct``, ``why``);
  * ``harness/<kind>_cell.py``: the window of every cell of that ``kind``,
    a module with ``run``, ``reading`` and ``FAULTS``;
  * ``metrics/<metric>.py``: a per-layer metric's reader, a function
    ``read(record) -> float | None``;
  * ``BENCHMARK.json`` at the root of the checkout: which metrics each cell
    reports, and their units.

A later change adds a cell, a configuration or a metric by adding files;
no file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


def _load(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    return json.loads(path.read_text())


def kinds(root: Path = BENCH_DIR) -> List[str]:
    """The kinds of window: ``harness/<kind>_cell.py``."""
    return sorted(p.name[:-len("_cell.py")] for p in (root / "harness").glob("*_cell.py"))


def window(kind: str):
    """The module of the window of ``kind``."""
    if kind not in kinds():
        raise ValueError(f"no window of kind {kind!r}: there is no harness/{kind}_cell.py")
    return importlib.import_module(f"harness.{kind}_cell")


def names(kind: str, root: Path = BENCH_DIR) -> List[str]:
    """The names of every ``configs``, ``workloads`` or ``metrics`` entry."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(f"*{suffix}") if not p.name.startswith("_"))


def config(name: str, root: Path = BENCH_DIR) -> dict:
    cfg = _load(root / "configs" / f"{check_name(name)}.json")
    cfg["name"] = name
    for key in ("source", "reduced", "assumed", "depth_multiple", "width_multiple", "nc"):
        if key not in cfg:
            raise KeyError(f"configuration {name} has no {key!r}")
    cfg["deepen_factor"], cfg["widen_factor"] = cfg["depth_multiple"], cfg["width_multiple"]
    return cfg


def workload(name: str, root: Path = BENCH_DIR) -> dict:
    """The cell ``name`` with its configuration under ``"model"``."""
    cell = _load(root / "workloads" / f"{check_name(name)}.json")
    cell["name"] = name
    if cell.get("kind") not in kinds(root):
        raise ValueError(f"cell {name}: kind must be one of {kinds(root)}, got {cell.get('kind')!r}")
    if cell.get("chips") not in (1, 4):
        raise ValueError(f"cell {name}: chips must be 1 or 4")
    for key in ("config", "image_size", "batch", "why", "limits"):
        if key not in cell:
            raise KeyError(f"cell {name} has no {key!r}")
    cell["model"] = config(cell["config"], root)
    return cell


def reader(name: str, root: Path = BENCH_DIR) -> Callable[[dict], Optional[float]]:
    """``read(record)`` of ``metrics/<name>.py``, loaded from its file."""
    path = root / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"_bench_metric_{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def spec(checkout: Path = CHECKOUT) -> dict:
    return _load(checkout / "BENCHMARK.json")


def metrics_for(cell: str, bench: dict, traced: bool) -> Dict[str, str]:
    """{metric: unit} that ``cell`` reports: its end-to-end metrics, or with
    ``traced`` its per-layer ones (a metric without ``workloads`` is every
    cell's that reports the end-to-end metric it moves)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    mine = {n for n, m in e2e.items() if "workloads" not in m or cell in m["workloads"]}
    if not traced:
        return {n: e2e[n]["unit"] for n in sorted(mine)}
    out = {}
    for m in bench["per_layer"]:
        listed = m.get("workloads")
        if (cell in listed) if listed is not None else (m["moves"] in mine):
            out[m["name"]] = m["unit"]
    return out
