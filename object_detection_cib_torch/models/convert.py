"""flax -> torch converters for the YOLOv5 network and its training state.

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

``flax_state_to_torch(state)`` converts the whole training state, the JAX
package's ``TrainState`` (``train/steps.py``) as Orbax restores it without a
target: ``{"params", "batch_stats", "opt_state": {"momentum_buf"}, "step"}``.
It returns the port's checkpoint dict, ``{"net": state_dict, "optimizer":
{"step_count": int, "momentum": {name: tensor}}}`` (``train/checkpoint.py``,
``SmartSGD.state_dict``). The momentum tree is shaped like ``params`` and
takes the parameters' rules, so each buffer lands under its parameter's
name, and with it in the optimizer group of that parameter. ``torch_to_flax_state``
is the inverse; the round trip is bitwise both ways. It splits each head by
the anchors a cell and the class count the caller built the network with,
and refuses a head of any other width.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from object_detection_cib_torch.models.yolov5 import ANCHORS_PER_CELL

_HEAD_PARTS = ("box", "obj", "cls")
_HEAD_LEAVES = {f"{p}_{s}" for p in _HEAD_PARTS for s in ("kernel", "bias")}
_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}
_BN_PARAMS_BACK = {v: k for k, v in _BN_PARAMS.items()}
_BN_STATS_BACK = {v: k for k, v in _BN_STATS.items()}
_STATE_KEYS = {"params", "batch_stats", "opt_state", "step"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _nest(flat: Mapping[tuple, np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def _params_to_torch(params: Mapping, what: str = "parameter") -> Dict[str, np.ndarray]:
    """A tree shaped like flax ``params`` (the parameters, or a momentum
    tree) -> ``{torch parameter name: array}`` by the rules above."""
    sd: Dict[str, np.ndarray] = {}
    heads: Dict[tuple, Dict[str, np.ndarray]] = {}
    for path, v in _flatten(params).items():
        mod, leaf = path[:-1], path[-1]
        if leaf == "kernel":
            sd[".".join(mod + ("weight",))] = v.transpose(3, 2, 0, 1)
        elif mod and mod[-1] == "bn" and leaf in _BN_PARAMS:
            sd[".".join(mod + (_BN_PARAMS[leaf],))] = v
        elif leaf in _HEAD_LEAVES:
            heads.setdefault(mod, {})[leaf] = v
        else:
            raise KeyError(f"unknown flax {what} {'/'.join(path)}")

    for mod, leaves in heads.items():
        if set(leaves) != _HEAD_LEAVES:
            raise KeyError(f"head {'/'.join(mod)} has {sorted(leaves)}, want {sorted(_HEAD_LEAVES)}")
        kernel = np.concatenate([leaves[f"{p}_kernel"] for p in _HEAD_PARTS], axis=-1)
        bias = np.concatenate([leaves[f"{p}_bias"] for p in _HEAD_PARTS])
        sd[".".join(mod + ("conv", "weight"))] = kernel.transpose(3, 2, 0, 1)
        sd[".".join(mod + ("conv", "bias"))] = bias
    return sd


def _params_to_flax(named: Mapping[str, torch.Tensor], num_classes: int, num_anchors_per_cell: int) -> dict:
    """The inverse of ``_params_to_torch``: a head is the one conv with a
    bias (every other conv's bias is its BatchNorm's), of A * (5 + nc)
    outputs, split into box (4A) | obj (A) | cls (A nc)."""
    A = num_anchors_per_cell
    flat: Dict[tuple, np.ndarray] = {}
    for name, t in named.items():
        v = t.detach().cpu().numpy().copy()
        path = tuple(name.split("."))
        mod, leaf = path[:-1], path[-1]
        if mod and mod[-1] == "bn" and leaf in _BN_PARAMS_BACK:
            flat[mod + (_BN_PARAMS_BACK[leaf],)] = v
        elif mod and mod[-1] == "conv" and ".".join(mod + ("bias",)) in named:
            head = mod[:-1]
            if v.shape[0] != A * (5 + num_classes):
                raise ValueError(f"head {name} has {v.shape[0]} outputs, not A * (5 + nc) = {A * (5 + num_classes)} "
                                 f"for num_anchors_per_cell={A} and num_classes={num_classes}")
            cuts = np.cumsum([4 * A, A])
            parts = np.split(v.transpose(2, 3, 1, 0) if leaf == "weight" else v, cuts, axis=-1)
            suffix = {"weight": "kernel", "bias": "bias"}[leaf]
            for p, x in zip(_HEAD_PARTS, parts):
                flat[head + (f"{p}_{suffix}",)] = np.ascontiguousarray(x)
        elif leaf == "weight" and v.ndim == 4:
            flat[mod + ("kernel",)] = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        else:
            raise KeyError(f"unknown torch parameter {name}")
    return _nest(flat)


def flax_to_torch(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables (nested numpy dicts) -> Yolov5Network state_dict (f32)."""
    sd = _params_to_torch(variables["params"])
    for path, v in _flatten(variables.get("batch_stats", {})).items():
        mod, leaf = path[:-1], path[-1]
        if leaf not in _BN_STATS:
            raise KeyError(f"unknown flax batch stat {'/'.join(path)}")
        sd[".".join(mod + (_BN_STATS[leaf],))] = v
    return _tensors(sd)


def flax_state_to_torch(state: Mapping) -> dict:
    """The JAX ``TrainState`` as Orbax restores it without a target (nested
    numpy dicts) -> the port's checkpoint dict, every leaf consumed. An
    unknown key or leaf raises, and so does a momentum tree whose paths or
    shapes differ from ``params``; ``step`` (0-d integer) becomes an int."""
    if set(state) != _STATE_KEYS:
        raise KeyError(f"a TrainState has {sorted(_STATE_KEYS)}, this one {sorted(state)}")
    opt = state["opt_state"]
    if set(opt) != {"momentum_buf"}:
        raise KeyError(f"a SmartSGDState has ['momentum_buf'], this one {sorted(opt)}")
    params, mom = _flatten(state["params"]), _flatten(opt["momentum_buf"])
    if set(params) != set(mom):
        raise KeyError(f"momentum paths differ from the parameters': missing "
                       f"{sorted('/'.join(p) for p in set(params) - set(mom))}, unexpected "
                       f"{sorted('/'.join(p) for p in set(mom) - set(params))}")
    shapes = [("/".join(p), v.shape, mom[p].shape) for p, v in params.items() if v.shape != mom[p].shape]
    if shapes:
        raise ValueError(f"momentum shapes differ from the parameters' (path, parameter, momentum): {shapes}")
    step = np.asarray(state["step"])
    if step.ndim != 0 or not np.issubdtype(step.dtype, np.integer):
        raise ValueError(f"step must be a 0-d integer, got {step.dtype} of shape {step.shape}")
    return {"net": flax_to_torch(state),
            "optimizer": {"step_count": int(step),
                          "momentum": _tensors(_params_to_torch(opt["momentum_buf"], "momentum"))}}


def torch_to_flax_state(ckpt: Mapping, num_classes: int, num_anchors_per_cell: int = ANCHORS_PER_CELL) -> dict:
    """The port's checkpoint dict of a network of ``num_classes`` classes
    and ``num_anchors_per_cell`` anchors a cell -> the JAX ``TrainState``
    layout as nested numpy dicts (what Orbax restores without a target).
    A head whose outputs are not ``A * (5 + nc)`` raises, naming both."""
    net, opt = ckpt["net"], ckpt["optimizer"]
    stats = {k: v for k, v in net.items() if k.rsplit(".", 1)[-1] in _BN_STATS_BACK}
    params = {k: v for k, v in net.items() if k not in stats}
    if set(opt["momentum"]) != set(params):
        raise KeyError(f"momentum buffers differ from the parameters: missing "
                       f"{sorted(set(params) - set(opt['momentum']))}, unexpected "
                       f"{sorted(set(opt['momentum']) - set(params))}")
    batch_stats = _nest({tuple(k.split("."))[:-1] + (_BN_STATS_BACK[k.rsplit(".", 1)[-1]],):
                         v.detach().cpu().numpy().copy() for k, v in stats.items()})
    heads = (num_classes, num_anchors_per_cell)
    return {"params": _params_to_flax(params, *heads),
            "batch_stats": batch_stats,
            "opt_state": {"momentum_buf": _params_to_flax(opt["momentum"], *heads)},
            "step": np.asarray(opt["step_count"], np.int32)}
