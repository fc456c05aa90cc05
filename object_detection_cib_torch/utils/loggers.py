"""Metric loggers: CSV, TensorBoard, W&B, MLflow, and the console progress.

A copy of the JAX package's ``utils/loggers.py`` with one change: the
TensorBoard logger writes through ``torch.utils.tensorboard.SummaryWriter``
(``new_style`` scalars: the float32 tensor summaries with the ``scalars``
plugin that TensorFlow's ``tf.summary.scalar`` writes). Neither importing
this module nor building a logger changes the process's imports beyond what
``SummaryWriter`` itself does; an entry point that wants tensorboard without
TensorFlow calls ``tensorboard_without_tensorflow`` first. The CSV file is
the same byte for byte, resume-append included. W&B and MLflow use their client when it is installed; without it
they still write real
files, wandb's offline run directory and MLflow's FileStore layout, so no
credentials or network are needed. A logger whose client or writer cannot
be made (``tensorboard`` not installed, say) warns once and becomes a
``NoOpLogger``. Under data parallelism the trainer builds loggers on rank 0
only (the JAX package's ``build_loggers`` returns none elsewhere).

Capability parity: the reference's pluggable logger set (kod/configs/
logger/*: csv, tensorboard, wandb, mlflow) and headless progress table
(kod/lightning/callbacks/progress.py:25-50).
"""

from __future__ import annotations

import csv
import json
import sys
import time
import types
import uuid
import warnings
from pathlib import Path
from typing import Dict, List, Optional


class CSVLogger:
    def __init__(self, save_dir: Path):
        self.dir = Path(save_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "metrics.csv"
        self._fieldnames: Optional[List[str]] = None
        # resume-append: a pre-existing metrics.csv (ckpt_path resume) keeps
        # its rows; adopt its header so subsequent writes append
        if self.path.exists():
            with open(self.path) as fp:
                header = fp.readline().strip()
            if header:
                self._fieldnames = header.split(",")

    def log(self, metrics: Dict[str, float], step: int):
        row = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        names = list(row)
        if self._fieldnames is None or any(n not in self._fieldnames for n in names):
            old_rows = []
            if self.path.exists() and self._fieldnames:
                with open(self.path) as fp:
                    old_rows = list(csv.DictReader(fp))
            self._fieldnames = sorted(set(names) | set(self._fieldnames or []),
                                      key=lambda x: (x != "step", x))
            with open(self.path, "w", newline="") as fp:
                w = csv.DictWriter(fp, fieldnames=self._fieldnames)
                w.writeheader()
                for r in old_rows:
                    w.writerow(r)
        with open(self.path, "a", newline="") as fp:
            csv.DictWriter(fp, fieldnames=self._fieldnames).writerow(row)


class TensorBoardLogger:
    def __init__(self, save_dir: Path):
        from torch.utils.tensorboard import SummaryWriter  # needs the tensorboard package

        self.writer = SummaryWriter(str(save_dir))

    def log(self, metrics: Dict[str, float], step: int):
        for k, v in metrics.items():
            self.writer.add_scalar(k, float(v), global_step=step, new_style=True)
        self.writer.flush()

    def finalize(self):
        self.writer.close()


class NoOpLogger:
    def __init__(self, *a, **kw):
        pass

    def log(self, metrics, step):
        pass


class WandbLogger:
    """Weights & Biases logger (parity: kod/configs/logger/wandb.yaml).

    With the wandb client installed, delegates to ``wandb.init``. Without
    it, the history is written in wandb's run-dir format: one
    ``wandb/offline-run-<name>/files/`` directory holding
    ``wandb-history.jsonl`` (one JSON object per log call, ``_step`` keyed),
    ``wandb-metadata.json``.
    """

    def __init__(self, save_dir: Path, project: str = "kod", name: Optional[str] = None,
                 tags: Optional[list] = None, group: str = ""):
        try:
            import wandb  # optional client; offline files otherwise

            self._run = wandb.init(dir=str(save_dir), project=project, name=name,
                                   tags=list(tags or []), group=group or None)
            self._fp = None
        except ImportError:
            run_name = name or f"run-{int(time.time())}"
            d = Path(save_dir) / "wandb" / f"offline-run-{run_name}" / "files"
            d.mkdir(parents=True, exist_ok=True)
            (d / "wandb-metadata.json").write_text(json.dumps({
                "project": project, "name": run_name,
                "tags": list(tags or []), "group": group,
                "startedAt": time.strftime("%Y-%m-%dT%H:%M:%S"),
            }))
            self._run = None
            self._fp = open(d / "wandb-history.jsonl", "a")

    def log(self, metrics: Dict[str, float], step: int):
        row = {k: float(v) for k, v in metrics.items()}
        if self._run is not None:
            self._run.log(row, step=step)
        else:
            self._fp.write(json.dumps({"_step": step, **row}) + "\n")
            self._fp.flush()

    def finalize(self):
        if self._run is not None:
            self._run.finish()
        else:
            self._fp.close()


class MLflowLogger:
    """MLflow logger (parity: kod/configs/logger/mlflow.yaml).

    With the mlflow client installed, delegates to the tracking API. Without
    it, ``file:`` URIs get the documented FileStore layout written directly:
    ``<root>/<experiment_id>/meta.yaml``, ``<root>/<exp>/<run_id>/meta.yaml``
    and per-metric files ``metrics/<key>`` of ``<ts_ms> <value> <step>``
    lines, which ``mlflow ui`` reads.
    """

    def __init__(self, tracking_uri: str, experiment_name: str = "kod",
                 run_name: Optional[str] = None):
        try:
            import mlflow  # optional client; file-store written directly otherwise

            self._mlflow = mlflow
            mlflow.set_tracking_uri(tracking_uri)
            mlflow.set_experiment(experiment_name)
            self._run = mlflow.start_run(run_name=run_name)
            return
        except ImportError:
            pass
        self._mlflow = None
        if not tracking_uri.startswith("file:"):
            raise ValueError("mlflow client not installed; only file: tracking URIs are "
                             "supported by the built-in FileStore writer")
        root = Path(tracking_uri[len("file:"):])
        # experiment ids are numeric strings in the FileStore; reuse the
        # experiment dir whose meta names this experiment, else allocate
        exp_id = None
        if root.exists():
            for d in sorted(root.iterdir()):
                meta = d / "meta.yaml"
                if d.is_dir() and d.name.isdigit() and meta.exists() and (
                        f"name: {experiment_name}\n" in meta.read_text()):
                    exp_id = d.name
                    break
        if exp_id is None:
            taken = {int(d.name) for d in root.iterdir()
                     if d.is_dir() and d.name.isdigit()} if root.exists() else set()
            exp_id = str(max(taken, default=0) + 1)
            exp_dir = root / exp_id
            exp_dir.mkdir(parents=True, exist_ok=True)
            (exp_dir / "meta.yaml").write_text(
                f"artifact_location: file:{root}/{exp_id}\n"
                f"experiment_id: '{exp_id}'\n"
                f"lifecycle_stage: active\n"
                f"name: {experiment_name}\n"
            )
        run_id = uuid.uuid4().hex
        self._run_dir = root / exp_id / run_id
        (self._run_dir / "metrics").mkdir(parents=True)
        (self._run_dir / "params").mkdir()
        (self._run_dir / "tags").mkdir()
        start_ms = int(time.time() * 1000)
        (self._run_dir / "meta.yaml").write_text(
            f"artifact_uri: file:{self._run_dir}/artifacts\n"
            f"end_time: null\n"
            f"entry_point_name: ''\n"
            f"experiment_id: '{exp_id}'\n"
            f"lifecycle_stage: active\n"
            f"run_id: {run_id}\n"
            f"run_name: {run_name or run_id[:8]}\n"
            f"run_uuid: {run_id}\n"
            f"source_name: ''\n"
            f"source_type: 4\n"
            f"source_version: ''\n"
            f"start_time: {start_ms}\n"
            f"status: 1\n"
            f"user_id: unknown\n"
        )
        (self._run_dir / "tags" / "mlflow.runName").write_text(run_name or run_id[:8])

    def log(self, metrics: Dict[str, float], step: int):
        if self._mlflow is not None:
            self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)
            return
        ts = int(time.time() * 1000)
        for k, v in metrics.items():
            with open(self._run_dir / "metrics" / k, "a") as fp:
                fp.write(f"{ts} {float(v)} {step}\n")

    def finalize(self):
        if self._mlflow is not None:
            self._mlflow.end_run()
            return
        meta = self._run_dir / "meta.yaml"
        txt = meta.read_text().replace("end_time: null", f"end_time: {int(time.time() * 1000)}", 1)
        meta.write_text(txt.replace("status: 1", "status: 3", 1))


def tensorboard_without_tensorflow() -> None:
    """Bind tensorboard to its no-TensorFlow stub (its
    ``//tensorboard/compat:no_tensorflow`` build) for the rest of the process.

    Where TensorFlow is installed, importing ``torch.utils.tensorboard``
    imports it too, and some TensorFlow builds import JAX. tensorboard
    resolves that binding once per process and keeps it, so only a process's
    entry point calls this, before anything imports tensorboard: ``python -m
    object_detection_cib_torch.cli.train`` and ``chip_smoke.py`` do. A process
    that also writes TensorFlow's own summaries (the JAX package's logger)
    must not, since those need tensorboard bound to TensorFlow.
    """
    sys.modules.setdefault("tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


def build_loggers(logger_cfg: Optional[dict]) -> list:
    """Loggers from the ``cfg.logger`` group (csv/tensorboard/wandb/mlflow).

    A logger that cannot be made warns once and is replaced by a no-op.
    """
    out = []
    for name, sub in (logger_cfg or {}).items():
        try:
            if name == "csv":
                out.append(CSVLogger(sub["save_dir"]))
            elif name == "tensorboard":
                out.append(TensorBoardLogger(sub["save_dir"]))
            elif name == "wandb":
                out.append(WandbLogger(sub.get("save_dir", "."), project=sub.get("project", "kod"),
                                       name=sub.get("name"), tags=sub.get("tags"),
                                       group=sub.get("group", "")))
            elif name == "mlflow":
                out.append(MLflowLogger(sub.get("tracking_uri", "file:./mlruns"),
                                        experiment_name=sub.get("experiment_name", "kod"),
                                        run_name=sub.get("run_name")))
            else:
                out.append(NoOpLogger())
        except Exception as e:  # missing client/credentials -> warn once, no-op
            warnings.warn(f"logger '{name}' unavailable ({e!r}); using no-op")
            out.append(NoOpLogger())
    return out


class RichEpochProgress:
    """Rich live progress bar for one epoch (RichProgressBar analog)."""

    def __init__(self, epoch: int, total: int):
        from rich.progress import BarColumn, Progress, TextColumn, TimeElapsedColumn

        self._p = Progress(
            TextColumn(f"epoch {epoch}"),
            BarColumn(),
            TextColumn("{task.completed}/{task.total}"),
            TimeElapsedColumn(),
            TextColumn("{task.fields[postfix]}"),
            transient=True,
        )
        self._p.start()
        self._task = self._p.add_task("train", total=total, postfix="")

    def advance(self, metrics: Optional[Dict[str, float]] = None):
        postfix = " ".join(f"{k}={float(v):.3f}" for k, v in metrics.items()) if metrics else ""
        self._p.update(self._task, advance=1, postfix=postfix)

    def close(self):
        self._p.stop()


class ProgressTable:
    """Interval console metrics (ref ProgressDisplayCallback)."""

    def __init__(self, interval: int = 20, enabled: bool = True):
        self.interval = interval
        self.enabled = enabled
        self._t0 = time.time()

    def update(self, epoch: int, step: int, metrics: Dict[str, float]):
        if not self.enabled or self.interval <= 0 or step % self.interval:
            return
        body = "  ".join(f"{k}={float(v):.4f}" for k, v in metrics.items())
        dt = time.time() - self._t0
        print(f"[epoch {epoch:3d} step {step:6d} t {dt:7.1f}s] {body}", flush=True)
