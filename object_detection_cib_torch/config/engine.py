"""YAML config composition and instantiation: the Hydra subset the repo uses.

A copy of the JAX package's ``config/engine.py`` (it needs only ``yaml``):
``compose``, ``resolve_interpolations``, ``load_yaml`` and ``instantiate``
behave as there, ``${now:...}`` included, and read the same ``configs/``
tree. One change, in ``instantiate``: every ``_target_`` in ``configs/``
names the JAX package, and a target under that package's name resolves to
the same dotted path under this one (``_port_target``). A target with no
counterpart here raises ``ImportError`` naming both paths; the JAX module
is never imported. Any other target imports as written.

Capability parity: the reference's config surface (SURVEY.md §5.6) — a YAML
tree with group dirs, a root ``train.yaml`` defaults list, ``@package
_global_`` experiment overlays, CLI group overrides (``experiment=yv5s``),
dotted value overrides (``data.mixup_prob=0.3``), ``${path}`` interpolation,
and recursive ``_target_``/``_partial_`` object instantiation. Hydra itself
is not a dependency; README command spellings translate 1:1.

Grammar supported:
  defaults:                # list, processed in order
    - _self_               # merge this file's own keys at this point
    - data: default        # load configs/data/default.yaml into cfg.data
    - override /model: yv5 # (in overlays) re-select a group
    - /nn/losses/yv5@loss  # absolute group at a custom package key
    - augmentations/default@train_data_augmentor   # relative to file's dir
    - experiment: null     # placeholder group, selectable from CLI
  '# @package _global_'    # first-line pragma: file merges at config root

CLI override forms:
  group=option             # (re)select a group (e.g. experiment=yv5s)
  group=null               # clear a group
  key.path=value           # set a value (YAML-parsed scalar)
  +key.path=value          # add a new key
  ~key.path                # delete a key
"""

from __future__ import annotations

import copy
import importlib
import re
from functools import partial
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import yaml

_GLOBAL_PRAGMA = re.compile(r"^#\s*@package\s+_global_\s*$", re.MULTILINE)
_INTERP = re.compile(r"\$\{([^}]+)\}")


def load_yaml(path: Path) -> Tuple[dict, bool]:
    """Returns (config dict, is_global_package)."""
    text = Path(path).read_text()
    is_global = bool(_GLOBAL_PRAGMA.search(text.split("\n", 3)[0] + "\n"
                                           + "\n".join(text.split("\n")[1:3])))
    data = yaml.safe_load(text) or {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    return data, is_global


def _deep_merge(dst: dict, src: dict) -> dict:
    """Merge src into dst (src wins); dicts merge recursively."""
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _set_path(cfg: dict, dotted: str, value: Any, must_exist: bool = False):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        if p not in node or not isinstance(node[p], dict):
            if must_exist:
                raise KeyError(f"override path not found: {dotted}")
            node[p] = {}
        node = node[p]
    if must_exist and parts[-1] not in node:
        raise KeyError(f"override path not found: {dotted}")
    node[parts[-1]] = value


def _del_path(cfg: dict, dotted: str):
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node[p]
    node.pop(parts[-1], None)


def _get_path(cfg: dict, dotted: str) -> Any:
    node = cfg
    for p in dotted.split("."):
        node = node[p]
    return node


def _parse_value(s: str) -> Any:
    return yaml.safe_load(s)


class _Composer:
    def __init__(self, config_dir: Path):
        self.config_dir = Path(config_dir)

    def _resolve_group_file(self, group: str, option: str, base_dir: Path) -> Path:
        if group.startswith("/"):
            p = self.config_dir / group.lstrip("/")
        else:
            p = base_dir / group
        return p / f"{option}.yaml"

    def compose_file(
        self,
        path: Path,
        cfg: dict,
        group_selections: Dict[str, str],
        package: Optional[str] = None,
    ) -> dict:
        """Compose one file (with its defaults list) into cfg."""
        data, is_global = load_yaml(path)
        base_dir = path.parent
        defaults = data.pop("defaults", None)

        own_target = cfg
        if package and not is_global:
            # navigate/create the package node
            node = cfg
            for p in package.split("."):
                if not isinstance(node.get(p), dict):
                    node[p] = {}
                node = node[p]
            own_target = node

        merged_self = False

        def merge_self():
            nonlocal merged_self
            _deep_merge(own_target, data)
            merged_self = True

        # package prefix for children: relative to this file's package,
        # except for global (@package _global_) files which compose at root
        parent_pkg = None if is_global else package

        def compose_child(group: str, option: str, pkg: str):
            child = self._resolve_group_file(group, option, base_dir)
            child_pkg = f"{parent_pkg}.{pkg}" if (parent_pkg and pkg) else (
                pkg or parent_pkg
            )
            self.compose_file(child, cfg, group_selections, child_pkg)

        if defaults:
            for entry in defaults:
                if entry == "_self_":
                    merge_self()
                    continue
                if isinstance(entry, str):
                    if "@" in entry or "/" in entry:
                        # bare path entry: "/anchor_boxes/voc_s8@anchor_info.ll"
                        path_part, _, pkg = entry.partition("@")
                        group, _, option = path_part.rpartition("/")
                        if not pkg:
                            pkg = path_part.lstrip("/").replace("/", ".")
                        # CLI selection for path-style groups, e.g.
                        # "data/augmentations=albu/default"
                        gdir = (
                            self.config_dir / group.lstrip("/")
                            if group.startswith("/")
                            else base_dir / group
                        )
                        try:
                            sel_key = str(
                                gdir.resolve().relative_to(
                                    self.config_dir.resolve()
                                )
                            )
                        except ValueError:
                            sel_key = group.lstrip("/")
                        # A file inside group G referencing a sibling in G
                        # (e.g. experiment/imbalance/* including
                        # /experiment/yv5s) is explicit composition — the
                        # CLI's selection for G must not re-route it (it IS
                        # the selection), or selection would recurse.
                        in_own_group = str(path.resolve()).startswith(
                            str((self.config_dir / sel_key).resolve()) + "/"
                        )
                        if sel_key in group_selections and not in_own_group:
                            sel = group_selections[sel_key]
                            if sel is None:
                                continue
                            option = str(sel)
                        compose_child(group or ".", option, pkg)
                    else:
                        # same-group config include: "- yv5s"
                        self.compose_file(
                            base_dir / f"{entry}.yaml", cfg, group_selections,
                            parent_pkg,
                        )
                    continue
                (key, option), = entry.items()
                if key.startswith("override "):
                    key = key[len("override "):].strip()
                if "@" in key:
                    group, pkg = key.split("@", 1)
                else:
                    group, pkg = key, key.lstrip("/").replace("/", ".")
                # CLI group selection wins
                sel_key = group.lstrip("/")
                if sel_key in group_selections:
                    option = group_selections[sel_key]
                if option is None:
                    continue
                compose_child(group, str(option), pkg)
        if not merged_self:
            merge_self()
        return cfg


def compose(
    config_dir: Union[str, Path],
    config_name: str = "train",
    overrides: Sequence[str] = (),
) -> dict:
    """Compose the config tree with CLI-style overrides, resolve interp."""
    config_dir = Path(config_dir)
    group_selections: Dict[str, str] = {}
    value_overrides: List[Tuple[str, str, Any]] = []

    for ov in overrides:
        if ov.startswith("~"):
            value_overrides.append(("del", ov[1:], None))
            continue
        if "=" not in ov:
            raise ValueError(f"bad override {ov!r}")
        key, _, raw = ov.partition("=")
        add = key.startswith("+")
        key = key.lstrip("+")
        val = _parse_value(raw)
        # group selection iff the key names a group dir (single path, no dot)
        group_dir = config_dir / key.replace(".", "/")
        if "." not in key and (config_dir / key).is_dir():
            group_selections[key] = val
        elif group_dir.parent.is_dir() and isinstance(val, str) and (
            group_dir.parent / f"{val}.yaml"
        ).exists() and (config_dir / key.split(".")[0]).is_dir():
            # nested group like experiment=imbalance/class_aware/default
            group_selections[key] = val
        else:
            value_overrides.append(("add" if add else "set", key, val))

    composer = _Composer(config_dir)
    cfg: dict = {}
    composer.compose_file(config_dir / f"{config_name}.yaml", cfg, group_selections)

    for kind, key, val in value_overrides:
        if kind == "del":
            _del_path(cfg, key)
        else:
            _set_path(cfg, key, val)

    return resolve_interpolations(cfg)


def resolve_interpolations(cfg: dict) -> dict:
    """Resolve ${a.b} references (relative ones like ${..x} supported) and
    ${now:FORMAT} timestamps (hydra's ${now:...} resolver — one timestamp
    per compose so every reference agrees)."""
    import datetime

    now = datetime.datetime.now()

    def resolve(node, value, path: Tuple[str, ...]):
        if isinstance(value, str):
            m = _INTERP.fullmatch(value)
            if m:
                return lookup(m.group(1), path)
            return _INTERP.sub(lambda mm: str(lookup(mm.group(1), path)), value)
        return value

    def lookup(ref: str, path: Tuple[str, ...]):
        if ref.startswith("now:"):
            return now.strftime(ref[4:])
        if ref.startswith("."):
            # relative: each extra leading dot walks one level up
            up = len(ref) - len(ref.lstrip("."))
            base = list(path[: len(path) - up])
            ref = ref.lstrip(".")
            target = ".".join(base + ([ref] if ref else []))
        else:
            target = ref
        val = _get_path(cfg, target)
        if isinstance(val, str) and _INTERP.search(val):
            val = resolve(cfg, val, tuple(target.split(".")[:-1]))
        return val

    def walk(node, path: Tuple[str, ...]):
        if isinstance(node, dict):
            return {k: walk(resolve(node, v, path + (k,)), path + (k,))
                    if not isinstance(v, (dict, list)) else walk(v, path + (k,))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path) if isinstance(v, (dict, list))
                    else resolve(node, v, path) for v in node]
        return node

    return walk(cfg, ())


# the JAX package, whose paths every _target_ in configs/ names
REFERENCE_PACKAGE = "object_detection_cib_tpu"
PORT_PACKAGE = "object_detection_cib_torch"


def _port_target(target: str) -> str:
    """The port's dotted path for a target under the JAX package's name."""
    if target.split(".")[0] != REFERENCE_PACKAGE:
        return target
    return PORT_PACKAGE + target[len(REFERENCE_PACKAGE):]


def _import_target(target: str):
    path = _port_target(target)
    module, _, attr = path.rpartition(".")
    try:
        return getattr(importlib.import_module(module), attr)
    except (ModuleNotFoundError, AttributeError) as e:
        missing = getattr(e, "name", None)
        ours = isinstance(e, AttributeError) or (missing is not None and module.startswith(missing))
        if path == target or not ours:
            raise
        raise ImportError(f"_target_ {target!r} has no counterpart in the port: {path!r} "
                          f"does not exist ({e})") from None


def instantiate(node: Any, **extra_kwargs):
    """Recursively build objects from ``_target_`` specs (hydra.utils
    .instantiate equivalent; kod/lightning/tasks/trainer.py:47-97 usage)."""
    if isinstance(node, list):
        return [instantiate(x) for x in node]
    if not isinstance(node, dict):
        return node
    node = dict(node)
    target = node.pop("_target_", None)
    is_partial = node.pop("_partial_", False)
    kwargs = {k: instantiate(v) for k, v in node.items()}
    kwargs.update(extra_kwargs)
    if target is None:
        return kwargs
    fn = _import_target(target)
    if is_partial:
        return partial(fn, **kwargs)
    return fn(**kwargs)
