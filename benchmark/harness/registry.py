"""Everything the harness runs is found by name, in files of its own.

  * ``configs/<config>.json``: a model configuration (source, reduced,
    assumed, ``network``, and the keys its network family reads);
  * ``networks/<network>.py``: a network family, the one module that knows
    the network (``networks/__init__.py`` gives the names it defines:
    ``KEYS``, the reference and its control, the seed's weights, the
    program's ``Trainer`` keywords and eval network, the reference's
    training steps and decode, the counts of one image);
  * ``workloads/<cell>.json``: a cell (its configuration, ``kind``,
    ``chips``, sizes, traffic, the limits of ``correct``, ``why``);
  * ``harness/<kind>_cell.py``: the window of every cell of that ``kind``,
    a module with ``run``, ``reading`` and ``FAULTS``;
  * ``metrics/<metric>.py``: a per-layer metric's reader, a function
    ``read(record) -> float | None``;
  * ``BENCHMARK.json`` at the root of the checkout: which metrics each cell
    reports, and their units.

A later change adds a cell, a configuration, a metric or a network by
adding files; no file here needs an edit for it. A new network brings its
family module, its reference beside ``reference/`` (plain float32 PyTorch
that imports neither the program nor JAX), a configuration naming it, and
its cells.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
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


_FAMILIES: Dict[str, ModuleType] = {}  # each family's module, loaded once from its file


def config(name: str, root: Path = BENCH_DIR) -> dict:
    """The configuration ``name``; ``network_file`` is its family's module."""
    cfg = _load(root / "configs" / f"{check_name(name)}.json")
    cfg["name"] = name
    for key in ("source", "reduced", "assumed", "network"):
        if key not in cfg:
            raise KeyError(f"configuration {name} has no {key!r}")
    path = root / "networks" / f"{check_name(cfg['network'])}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {name} names network {cfg['network']!r}, and {path} does not exist")
    cfg["network_file"] = str(path)
    for key in family(cfg).KEYS:
        if key not in cfg:
            raise KeyError(f"configuration {name} has no {key!r}, which network {cfg['network']} reads")
    return cfg


def family(cfg: dict) -> ModuleType:
    """The module of the configuration's network family."""
    path = cfg["network_file"]
    if path not in _FAMILIES:
        spec = importlib.util.spec_from_file_location(f"_bench_network_{cfg['network'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _FAMILIES[path] = mod
    return _FAMILIES[path]


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
