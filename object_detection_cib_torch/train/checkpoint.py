"""Checkpoints of the training state, and best-metric tracking.

The counterpart of the JAX package's ``train/checkpoint.py`` with
``torch.save``/``torch.load`` in place of Orbax. A checkpoint is one file
holding ``{"net": net.state_dict(), "optimizer": SmartSGD.state_dict()}``:
the parameters in f32 and the BatchNorm running statistics, the momentum
buffers by parameter name and ``step_count``. The names and layout are the
JAX package's: ``<dirpath>/last``, ``<dirpath>/best`` and ``meta.json``
(``best_value``, ``monitor``), so ``ckpt_path=<run>/checkpoints/last``
names a checkpoint as the README spells it. A checkpoint of the JAX package
(an Orbax directory) is not read here: ``tools/orbax_to_torch.py`` converts
it, where the JAX package is installed, into a file written by
``save_state`` (and ``save_meta`` beside a converted ``best``), and
``load_state`` of a directory raises naming that tool.

Saves run on one worker thread, so they stay ordered and an error surfaces
at the next save, wait or restore. The optimizer updates the parameters
in place, so a thread that read the live tensors would save a later
step's weights: a ``Snapshot`` clones every tensor on its device (enqueued on
the current stream before the next step), and the worker copies the clones
to the host once an event recorded behind them has passed, then writes the
file under a temporary name and renames it. Under data parallelism rank 0
alone saves; every rank restores the same file after a barrier
(``train/trainer.py``).

Capability parity: Lightning ModelCheckpoint as configured by the reference
(kod/configs/callbacks/model_checkpoint.yaml: monitor 'map', mode max,
save_top_k 1, save_last) and ckpt_path resume/eval
(kod/lightning/tasks/trainer.py:120-138).
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from object_detection_cib_torch.train.optim import SmartSGD


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.to("cpu") if isinstance(tree, torch.Tensor) else tree


class Snapshot:
    """Device-side copies of the training state, and an event behind them."""

    def __init__(self, net: torch.nn.Module, optimizer: SmartSGD):
        with torch.no_grad():
            self.state = _clone({"net": net.state_dict(), "optimizer": optimizer.state_dict()})
        self.event = None
        if next(net.parameters()).is_cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def to_host(self) -> dict:
        """The state on the host, once the clones have been made."""
        if self.event is None:
            return self.state
        self.event.synchronize()
        with torch.cuda.stream(torch.cuda.Stream()):  # not behind the training stream's queue
            return _to_host(self.state)


def save_state(path: Path, state: dict) -> None:
    """Write a checkpoint dict as one ``torch.save`` file: under a
    temporary name beside ``path``, then renamed onto it."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)


def save_meta(directory: Path, best_value: float, monitor: str) -> None:
    """Write ``meta.json`` (the best value and its metric) into a
    checkpoint directory, where ``CheckpointManager`` reads it."""
    Path(directory, "meta.json").write_text(json.dumps({"best_value": best_value, "monitor": monitor}))


def load_state(path: Path) -> dict:
    path = Path(path)
    if path.is_dir():
        raise IsADirectoryError(
            f"{path} is a directory: an Orbax checkpoint of the JAX package? The port reads only its own "
            "checkpoints (one torch.save file); convert it first, where the JAX package is installed, with "
            f"`python tools/orbax_to_torch.py {path} <file>` and pass that file as ckpt_path")
    return torch.load(path, map_location="cpu", weights_only=True)


def apply_state(state: dict, net: torch.nn.Module, optimizer: Optional[SmartSGD]) -> None:
    net.load_state_dict(state["net"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])


class CheckpointManager:
    def __init__(self, directory: Path, monitor: str = "map", mode: str = "max"):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_value: Optional[float] = None
        self._meta_path = self.directory / "meta.json"
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        self._pending = None
        if self._meta_path.exists():
            meta = json.loads(self._meta_path.read_text())
            self.best_value = meta.get("best_value")

    def _save(self, name: str, snap: Snapshot):
        self._drain()
        path = self.directory / name

        self._pending = self._pool.submit(lambda: save_state(path, snap.to_host()))

    def _drain(self):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def wait_until_finished(self):
        self._drain()

    def save_last(self, snap: Snapshot):
        self._save("last", snap)

    def maybe_save_best(self, snap: Snapshot, metrics: dict) -> bool:
        value = metrics.get(self.monitor)
        if value is None:
            return False
        better = (
            self.best_value is None
            or (self.mode == "max" and value > self.best_value)
            or (self.mode == "min" and value < self.best_value)
        )
        if better:
            self.best_value = float(value)
            self._save("best", snap)
            save_meta(self.directory, self.best_value, self.monitor)
        return better

    def restore(self, net: torch.nn.Module, optimizer: Optional[SmartSGD] = None,
                name: str = "last") -> dict:
        """Load checkpoint ``name`` into ``net`` (and ``optimizer``); returns it."""
        self.wait_until_finished()
        state = load_state(self.directory / name)
        apply_state(state, net, optimizer)
        return state


def restore_checkpoint(path: Path, net: torch.nn.Module, optimizer: Optional[SmartSGD] = None) -> dict:
    """Restore from an explicit checkpoint file (the ``ckpt_path`` flag)."""
    state = load_state(Path(path).absolute())
    apply_state(state, net, optimizer)
    return state
