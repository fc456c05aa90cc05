"""flax -> torch weight converter for the YOLOv5 network.

``flax_to_torch(variables)`` takes the JAX package's variables as a nested
dict of numpy arrays, ``{"params": ..., "batch_stats": ...}`` (the caller
does the ``jax.tree.map(np.asarray, ...)``), and returns a ``state_dict`` for
``models/yolov5.py:Yolov5Network``:

  * conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W)
  * BN ``scale``/``bias`` -> ``weight``/``bias``; batch_stats ``mean``/``var``
    -> ``running_mean``/``running_var``
  * each head's ``{box,obj,cls}_kernel`` / ``_bias`` concatenated in that
    order into the one head conv's ``weight`` / ``bias``
    (models/yolov5.py:295-299 of the JAX package)

Module paths are the flax paths joined with dots. A tree trained with the
space-to-depth stem converts unchanged: that stem keeps the plain (6, 6, 3, C)
kernel. Every leaf is consumed; a leaf the converter does not know raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_HEAD_PARTS = ("box", "obj", "cls")
_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy dicts) -> Yolov5Network state_dict (f32)."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    sd: Dict[str, np.ndarray] = {}
    heads: Dict[tuple, Dict[str, np.ndarray]] = {}

    for path, v in params.items():
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            sd[".".join(mod + ("weight",))] = v.transpose(3, 2, 0, 1)
        elif mod and mod[-1] == "bn" and leaf in _BN_PARAMS:
            sd[".".join(mod + (_BN_PARAMS[leaf],))] = v
        elif leaf.rsplit("_", 1)[0] in _HEAD_PARTS and leaf.endswith(("_kernel", "_bias")):
            heads.setdefault(mod, {})[leaf] = v
        else:
            raise KeyError(f"unknown flax parameter {'/'.join(path)}")

    for mod, leaves in heads.items():
        expected = {f"{p}_{s}" for p in _HEAD_PARTS for s in ("kernel", "bias")}
        if set(leaves) != expected:
            raise KeyError(f"head {'/'.join(mod)} has {sorted(leaves)}, want {sorted(expected)}")
        kernel = np.concatenate([leaves[f"{p}_kernel"] for p in _HEAD_PARTS], axis=-1)
        bias = np.concatenate([leaves[f"{p}_bias"] for p in _HEAD_PARTS])
        sd[".".join(mod + ("conv", "weight"))] = kernel.transpose(3, 2, 0, 1)
        sd[".".join(mod + ("conv", "bias"))] = bias

    for path, v in stats.items():
        mod, leaf = path[:-1], path[-1]
        if leaf not in _BN_STATS:
            raise KeyError(f"unknown flax batch stat {'/'.join(path)}")
        sd[".".join(mod + (_BN_STATS[leaf],))] = v

    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()
    }
