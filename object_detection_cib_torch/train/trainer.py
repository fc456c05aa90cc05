"""The training loop and its runtime, and validation and prediction.

The counterpart of ``object_detection_cib_tpu/train/trainer.py``.
``Trainer`` runs the training loop through one of the JAX package's three
feeds (its ``__init__`` and ``_train_prefetcher``, :263-284, :635-701): the
device pipeline with the corpus on the card (per step K2, K5, K4 and the
train step; the production loop), the device pipeline fed per step by the
host (K5, K4), or the host pipeline (``data/pipeline.py``: reader, mosaic,
affine, HSV and flip in numpy and cv2, a ``Prefetcher`` of worker threads),
over fake draws or JPEG files. It is built from plain arguments, or by
``Trainer.from_config`` from a composed config (``configs/``, through
``object_detection_cib_torch.config``), reading what the JAX
``Trainer.__init__`` reads (:224-512). ``train(cfg)`` is the JAX task:
fit, then test, then predict, then finalize the loggers.

``fit`` is the JAX ``fit`` (:974-1297) with its two loops. The fused
epoch (``_fused_epoch``), the JAX trainer's default device-cache loop,
which ``data.fused_epoch``, ``fused_pipelined`` and ``fused_dispatch_ahead``
select by the JAX rule (``_fused_config``): per epoch the whole plan runs
as gather -> augment -> train step, on the card one captured CUDA graph a
step replayed once per step, with batch i+1 made while step i trains
(pipelined) and the next epoch enqueued before this one's metrics are
fetched (dispatch-ahead); the training stream is the step loop's. Each
fused epoch's stage marks (``utils/tracing.py``) give ``epoch_metrics[-1]
["stage_ms"]``, each stage's median device ms a step, and the epoch's
device time, which ``images_per_sec`` (logged with each validation, beside
the stage ms) and ``device_epoch_walls`` read. The
step loop runs the per-step control flow: ``limit_train_batches`` as a
fraction (``max(int(n * f), 1)``), ``fast_dev_run`` (one epoch, one train
batch, one val batch), ``overfit_batches`` (the first k batches replayed).
Both: ``trainer.profiler``'s ``torch.profiler`` trace of a window of steps
(on the fused loop, of the epochs that hold them; a Chrome trace under
``profile/``), validation every
``check_val_every_n_epoch`` epochs (``limit_val_batches`` a fraction too),
the losses logged every ``log_every_n_steps`` steps from the one per-epoch
copy of the step metrics (no host sync per step), early stopping, best and
last checkpoints (``train/checkpoint.py``) at the ``every_n_epochs``
cadence, the sampler-statistics file, the overflow warnings, and resume
from ``ckpt_path`` at ``step_count // steps_per_epoch``. The runtime's
knobs are attributes with the defaults of a plain run (validate every
epoch, no checkpoint, no logger), which ``from_config`` sets from the
config.

Config keys the port does not act on are named at start-up, never dropped
silently (``_KEYS_READ_NOT_ACTED_ON``): ``model.net.stem_space_to_depth``
(the same function as the plain 6x6/2 stem), ``trainer.compile_cache``
(XLA's), ``trainer.deterministic``, ``trainer.min_epochs`` and the step
schedule's ``model.scheduler.step_size`` and ``model.scheduler.gamma``
(the JAX trainer ignores them too; ``make_schedule`` takes its defaults,
100 epochs and 0.5).
Keys with a value it does not know raise, naming the key
(``_refuse_unported``): an unknown ``model.remat_policy``,
``data.corpus_sharding`` or ``data.corpus_layout``. ``model.remat_policy``
(the train step's rematerialisation, ``train/steps.py``),
``data.warp_pallas`` (False pins the dense bf16 warp in place of K5,
``ops/augment.py``) and ``data.corpus_layout`` (``flat`` holds the corpus
on the card as NHWC rows gathered by K3 in place of K2,
``data/device_pipeline.py``) act on both loops. The JAX package runs its
Pallas gather only in one process (a GSPMD workaround); the port's K3,
like its K2, runs on every rank. ``trainer.platform`` null means
the card: there is no fallback to the CPU, which ``trainer=cpu`` selects.

Data parallelism (``mesh``, a ``parallel.mesh.DataMesh`` with a process
group, one per rank; ``cli.train`` launches the ranks of a host for
``trainer.num_devices`` N > 1, null meaning every visible card, or joins
them from the environment over several hosts): the JAX package's mesh, a
JAX process being a port host. ``batch_size`` is the batch of one host,
as in the JAX trainer (:339-350): the global batch is ``hosts *
batch_size``, each of a host's N ranks trains on ``batch_size / N`` rows,
and ``steps_per_epoch`` is ``len(train) // (batch_size * hosts)``; on one
host ``batch_size`` is the global batch, as on one card. Each rank makes
its rows (``data/device_pipeline.py``: the step loop from its host's plan,
the fused epoch from one global plan; the host pipeline's batch of its
host, seeded ``seed + host * 1000003`` and fed from its host's shard of the
stream, made once by the host's local rank 0 and dealt over its ranks by
rows, ``data/pipeline.py``), the step is the global one (``train/steps.py``).
The per-epoch metric matrix is summed over the ranks (``lr`` excepted)
before its one copy to the host, so the losses, ``assign_drop`` and
``targets_dropped`` count every rank. The images an epoch records follow
the JAX rule (:1101-1103): the fused epoch counts the global batch, the
step loop its host's. Validation is sharded by rank over every rank of the
group (``shard_indices``: rank r takes images r, r+R, ...), each rank
through its own validation cache or host feed with K1 on its card in
batches of ``batch_size / N`` (a JAX host's batch split over its local
devices, :853-859), and the records are merged in image order
(``eval/coco_map.py``), so every rank reads the one-process mAP dict (JAX's
host shards after ``sync_across_processes``), and early stopping and "best"
agree. Global rank 0 writes the checkpoints, the loggers' files,
``hparams.json`` and the console lines; every rank waits for the others at
the end of ``fit`` and reads ``ckpt_path`` on resume (as JAX's Orbax
restore does on every process), so the path must be visible from every
host. A mesh without a group (one card) is the one-process path, bit for
bit.

``Evaluator.validate`` is the counterpart of ``Trainer._validate_device``
(:832-956) and ``Evaluator.validate_batches`` of ``Trainer.validate``'s
host feed (:787-830); ``Evaluator.predict`` and ``predict_batches`` of
``Trainer.predict``'s per-image dicts (:1333-1382). The uint8 canvases of a
``ValDeviceCache`` (built on the trainer's device) become one (nb, B, S, S,
3) tensor there, padded with zero images; each block is sliced, scaled by 1/255 and run
through the eval step. The host feed copies each batch up, the last one
padded to B with zero images. Either way the host converts and scores batch
i-1 while the card runs batch i (a one-deep pipeline: results come back by
a non-blocking copy into pinned memory, and the host waits on that copy's
event only).
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.config.engine import instantiate
from object_detection_cib_torch.core.assigner import THRESHOLD
from object_detection_cib_torch.core.nms import NMSResult
from object_detection_cib_torch.core.types import (
    AnchorBoxInfo,
    FeatureShape,
    LevelAnchors,
    default_anchors,
)
from object_detection_cib_torch.data.cache import DatasetInfo, deserialize_cached_dataset
from object_detection_cib_torch.data.device_pipeline import LAYOUTS, DeviceCorpus, DeviceDataPipeline, metric_column
from object_detection_cib_torch.data.host_augment import (
    AugParams,
    TrainSampleAugmentor,
    ValidationSampleAugmentor,
)
from object_detection_cib_torch.data.reader import SampleReader
from object_detection_cib_torch.data.samplers import shard_indices
from object_detection_cib_torch.data.synthetic import build_fake_manifest, build_synthetic_dataset
from object_detection_cib_torch.data.val_cache import ValDeviceCache
from object_detection_cib_torch.eval.coco_map import MeanAveragePrecisionEvaluator
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.parallel.distributed import (
    all_reduce_sum_,
    allgather_bytes,
    barrier,
    broadcast_module_,
    host_group,
)
from object_detection_cib_torch.parallel.mesh import DataMesh, host_batch_sharding, refuse_model_axis
from object_detection_cib_torch.train.checkpoint import CheckpointManager, Snapshot, restore_checkpoint
from object_detection_cib_torch.train.loss import LossParams
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD, WarmupParams
from object_detection_cib_torch.train.steps import REMAT_SAVES, Batch, StepMetrics, make_eval_step, make_train_step
from object_detection_cib_torch.utils import tracing
from object_detection_cib_torch.utils.device import resolve_device, to_unit
from object_detection_cib_torch.utils.fs import get_default_dataset_cache_dir, get_default_datasets_dir
from object_detection_cib_torch.utils.loggers import ProgressTable, build_loggers


class Evaluator:
    """Runs the eval step over a ``ValDeviceCache`` or host batches, for mAP
    or predictions."""

    def __init__(
        self,
        net: torch.nn.Module,
        anchors: LevelAnchors,
        classes: Sequence[str],
        batch_size: int,
        conf_thres: float = 0.001,
        iou_thres: float = 0.6,
        max_det: int = 300,
        max_nms: int = 2048,
        device: Union[str, torch.device] = "cuda",
        mesh: Optional[DataMesh] = None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh  # with a group: each rank evaluates its shard, the records are merged
        net_device = next(net.parameters()).device
        if net_device.type != self.device.type:
            raise ValueError(f"net is on {net_device}, evaluator on {self.device}")
        self.classes = list(classes)
        self.batch_size = batch_size
        self.nms = dict(conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det, max_nms=max_nms)
        self.eval_step = make_eval_step(
            net, anchors, conf_thres=conf_thres, iou_thres=iou_thres,
            max_det=max_det, max_nms=max_nms,
        )
        self._blocks: Optional[Tuple[ValDeviceCache, torch.Tensor]] = None

    def device_blocks(self, cache: ValDeviceCache) -> torch.Tensor:
        """The cache's canvases on the device as (nb, B, S, S, 3) uint8."""
        if self._blocks is None or self._blocks[0] is not cache:
            B = self.batch_size
            n = len(cache)
            nb = max((n + B - 1) // B, 1)
            canv = cache.canvases.to(self.device)
            pad = nb * B - n
            if pad:
                canv = torch.cat([canv, canv.new_zeros((pad,) + tuple(canv.shape[1:]))])
            S = cache.S
            self._blocks = (cache, canv.reshape(nb, B, S, S, 3))
        return self._blocks[1]

    def run_blocks(self, cache: ValDeviceCache,
                   max_blocks: Optional[int] = None) -> Iterator[Tuple[int, NMSResult]]:
        """Yield (block index, numpy NMSResult trimmed to the block's real
        rows) for the first ``max_blocks`` blocks (all by default).

        Block i's result is yielded after block i+1 has been enqueued.
        """
        ds = self.device_blocks(cache)
        n = len(cache)
        B = self.batch_size
        pending = None
        for bi in range(ds.shape[0] if max_blocks is None else min(max_blocks, ds.shape[0])):
            res = self.eval_step(to_unit(ds[bi]))
            fetched = _fetch(res)
            if pending is not None:
                yield _trimmed(*pending, B, n)
            pending = (bi, fetched)
        if pending is not None:
            yield _trimmed(*pending, B, n)

    def validate(self, cache: ValDeviceCache, max_blocks: Optional[int] = None) -> Dict[str, float]:
        """mAP over every image of the cache, or of its first ``max_blocks``
        blocks; under a mesh, over every rank's cache (its images merged by
        their ids in the set, ``cache.indices``)."""
        evaluator = MeanAveragePrecisionEvaluator(len(self.classes), class_names=self.classes)
        B = self.batch_size
        for bi, res in self.run_blocks(cache, max_blocks):
            sl = slice(bi * B, bi * B + res.boxes.shape[0])
            evaluator.add_batch(res, cache.gt_boxes[sl], cache.gt_labels[sl], cache.gt_mask[sl])
        if self.mesh is not None and self.mesh.group is not None:
            evaluator.sync_across_processes(cache.indices[:evaluator.n_images], self.mesh)
        return evaluator.results_dict()

    def _run_batches(self, batches: Iterable[Batch]) -> Iterator[Tuple[NMSResult, Batch]]:
        """Per host batch (uint8 images, as ``Prefetcher(device=None)`` yields
        them): the numpy result of its real rows, and the batch.
        Each is copied up, the last padded to B with zero images, and handed
        back while the card runs the next."""
        B = self.batch_size
        pending = None
        for batch in batches:
            n = batch.images.shape[0]
            images = batch.images.to(self.device, non_blocking=True)
            if n < B:
                images = torch.cat([images, images.new_zeros((B - n,) + images.shape[1:])])
            fetched = _fetch(self.eval_step(to_unit(images)))
            if pending is not None:
                yield _waited(*pending[:2]), pending[2]
            pending = (fetched, n, batch)
        if pending is not None:
            yield _waited(*pending[:2]), pending[2]

    def validate_batches(self, batches: Iterable[Batch],
                         image_ids: Optional[Sequence[int]] = None) -> Dict[str, float]:
        """mAP over host batches, scored on the host while the card runs the
        next; under a mesh, over every rank's batches, whose images are
        ``image_ids`` (in the order fed) of the set."""
        evaluator = MeanAveragePrecisionEvaluator(len(self.classes), class_names=self.classes)
        for res, batch in self._run_batches(batches):
            evaluator.add_batch(res, batch.boxes.numpy(), batch.labels.numpy(), batch.mask.numpy())
        if self.mesh is not None and self.mesh.group is not None:
            evaluator.sync_across_processes(image_ids[:evaluator.n_images], self.mesh)
        return evaluator.results_dict()

    def _dicts(self, res: NMSResult) -> List[dict]:
        out = []
        for i in range(res.boxes.shape[0]):
            n = int(res.num_valid[i])
            out.append({
                "boxes": res.boxes[i][:n].tolist(),
                "scores": res.scores[i][:n].tolist(),
                "classes": [self.classes[int(c)] for c in res.classes[i][:n]],
            })
        return out

    def predict(self, cache: ValDeviceCache, out_path: Optional[Path] = None) -> list:
        """Per-image {"boxes", "scores", "classes"} dicts, optionally dumped as JSON."""
        results = [d for _, res in self.run_blocks(cache) for d in self._dicts(res)]
        if out_path is not None:
            Path(out_path).write_text(json.dumps(results))
        return results

    def predict_batches(self, batches: Iterable[Batch], out_path: Optional[Path] = None) -> list:
        """``predict`` over host batches (the JAX ``Trainer.predict``'s feed).
        Under a mesh each rank predicts its shard (``shard_indices``) and the
        ranks' lists are merged back into the set's order (JAX :1364-1380);
        rank 0 writes ``out_path``."""
        results = [d for res, _ in self._run_batches(batches) for d in self._dicts(res)]
        if self.mesh is not None and self.mesh.group is not None:
            per_rank = [json.loads(b.decode()) for b in allgather_bytes(json.dumps(results).encode(), self.mesh)]
            iters = [iter(x) for x in per_rank]
            results = [next(iters[g % len(per_rank)]) for g in range(sum(len(x) for x in per_rank))]
        if out_path is not None and (self.mesh is None or self.mesh.is_main):
            Path(out_path).write_text(json.dumps(results))
        return results


def _fetch(res: NMSResult):
    """Start the device->host copy of ``res``; returns (host tensors, event)."""
    if not res.boxes.is_cuda:
        return res, None
    host = NMSResult(*(t.to("cpu", non_blocking=True) for t in res))
    event = torch.cuda.Event()
    event.record()
    return host, event


def _waited(fetched, rows: int) -> NMSResult:
    """The fetched result as numpy, once its copy has ended, first ``rows`` images."""
    host, event = fetched
    if event is not None:
        event.synchronize()
    return NMSResult(*(t.numpy()[:rows] for t in host))


def _trimmed(bi: int, fetched, B: int, n: int) -> Tuple[int, NMSResult]:
    return bi, _waited(fetched, min(n - bi * B, B))


METRIC_ROWS = StepMetrics._fields  # rows of the per-epoch metric matrix; the overflow is the last
LR_ROW = METRIC_ROWS.index("lr")


def _compute_loss_weights(info: DatasetInfo) -> np.ndarray:
    """sum(n)/n_c per class (ref tasks/trainer.py:54-60)."""
    counts = info.get_instance_count()
    total = sum(counts.values())
    return np.asarray([total / max(counts[c], 1) for c in info.classes], np.float32)


def _fraction_of(n: int, fraction) -> int:
    """``max(int(n * fraction), 1)``: the JAX trainer's limit_*_batches."""
    return max(int(n * float(fraction)), 1)


class FitConfig(NamedTuple):
    """``fit``'s control flow: the keys of ``configs/trainer/default.yaml``
    (and the profiler preset's) with the JAX trainer's defaults."""

    check_val_every_n_epoch: int = 1
    limit_train_batches: Optional[float] = None  # a fraction of the epoch's steps
    limit_val_batches: Optional[float] = None  # a fraction of the validation batches
    fast_dev_run: bool = False
    overfit_batches: Optional[int] = None
    log_every_n_steps: int = 20
    profiler: Optional[str] = None  # any value: a torch.profiler trace
    profile_start_step: int = 5
    profile_steps: int = 5


class EarlyStopping(NamedTuple):
    """Lightning ``EarlyStopping``'s knobs (configs/callbacks/early_stopping.yaml);
    ``patience`` 0 disables it."""

    monitor: str = "map"
    mode: str = "max"
    patience: int = 0
    min_delta: float = 0.0
    check_finite: bool = False


class Trainer:
    """The training loop on one card, or on this rank's card of a ``mesh``.

    From plain arguments: the network (random weights from ``seed``; ``size``
    a variant name or ``{"deepen_factor", "widen_factor"}``); the training
    feed, chosen as the JAX trainer chooses it: ``pipeline="device"`` is the
    device pipeline (corpus on the card with ``device_cache``, else
    host-fed), ``pipeline="host"`` the host pipeline (``train_augmentor``, by
    default ``TrainSampleAugmentor(aug_params)``) under a ``Prefetcher`` of
    ``num_workers`` threads, drawing from ``sampler`` or a
    ``ShuffleSampler``; images are fake draws with ``fake_mode`` (implied by
    a dataset name starting with "fake") or JPEG files under ``root_dir``.
    SmartSGD with ``steps_per_epoch = len(train) // batch_size`` and the lr
    schedule's horizon ``max_epochs``, the one source of that number; the
    train step with the assigner knobs; and the ``Evaluator`` with the NMS
    thresholds, over a ``ValDeviceCache`` of ``val_info`` with the corpus on
    the card (unless ``val_device_cache`` is off), over the host feed
    otherwise. ``train_info=None`` builds no training feed (evaluation from
    a checkpoint). ``sampler`` is any object with ``epoch_indices()``
    (``data/samplers.py``); ``corpus`` shares one ``DeviceCorpus`` between
    trainers over the same dataset. ``remat_policy`` is the train step's
    (``train/steps.py``), ``warp_pallas`` (False: the dense bf16 warp in
    place of K5) and ``corpus_layout`` (``"flat"``: the corpus on the card
    as NHWC rows, gathered by K3) the device pipeline's, all the config's
    keys.

    The runtime's knobs, with a plain run's defaults, are attributes:
    ``loop`` (a ``FitConfig``), ``early_stopping``, ``ckpt`` (a
    ``CheckpointManager`` or None) and ``ckpt_every_n_epochs``, ``loggers``,
    ``progress``, ``rich_progress``, ``sampler_debug``, ``debug_nans``,
    ``out_dir`` and ``verbose`` (the JAX trainer's console lines).
    ``from_config`` sets them all. ``fused_epoch``, ``fused_pipelined`` and
    ``fused_dispatch_ahead`` are the config's keys of those names, with
    ``configs/data/default.yaml``'s defaults: ``fused_epoch=False`` is the
    step loop.

    ``mesh`` (a ``DataMesh`` with a process group, as ``parallel.
    distributed.launch`` gives each rank) makes this one rank of a
    data-parallel run (module docstring); ``device`` must then be the
    mesh's and ``batch_size`` is its host's batch.
    ``corpus_sharding="sharded"`` spreads the corpus on the card over the
    ranks. The fused epoch is captured in a CUDA graph on the card, and run
    eagerly there under a gloo group, whose collectives a graph cannot
    hold.
    """

    def __init__(
        self,
        train_info: Optional[DatasetInfo],
        val_info: DatasetInfo,
        size: Union[str, Dict[str, float]] = "s",
        image_size: int = 416,
        batch_size: int = 64,
        aug_params: AugParams = AugParams(),
        optimizer: OptimizerConfig = OptimizerConfig(),
        loss_params: LossParams = LossParams(),
        use_loss_weights: bool = False,
        max_targets: int = 120,
        seed: int = 0,
        dtype: Optional[torch.dtype] = torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        sampler=None,
        mixup_prob: float = 0.0,
        use_mosaic: bool = True,
        warp_precision: str = "fast",
        corpus: Optional[DeviceCorpus] = None,
        max_epochs: int = 300,
        pipeline: str = "device",
        device_cache: bool = True,
        fake_mode: bool = False,
        root_dir: Optional[Path] = None,
        enable_ram_cache: bool = False,
        num_workers: int = 8,
        train_augmentor: Optional[Callable] = None,
        anchors: Optional[LevelAnchors] = None,
        num_anchors_per_cell: int = 3,
        assign_threshold: float = THRESHOLD,
        assign_offset_capacity: int = 3,
        assign_compact_slots: Optional[int] = 128,
        val_conf_thres: float = 0.001,
        val_iou_thres: float = 0.6,
        val_max_nms: int = 2048,
        val_device_cache: bool = True,
        fused_epoch: bool = True,
        fused_pipelined: bool = True,
        fused_dispatch_ahead: bool = True,
        mesh: Optional[DataMesh] = None,
        corpus_sharding: str = "replicated",
        remat_policy: Optional[str] = None,
        warp_pallas: Union[bool, str] = "auto",
        corpus_layout: str = "planar",
    ):
        if pipeline not in ("device", "host"):
            raise ValueError(f"pipeline must be 'device' or 'host', got {pipeline!r}")
        if optimizer.max_epochs not in (max_epochs, OptimizerConfig().max_epochs):
            raise ValueError(f"OptimizerConfig(max_epochs={optimizer.max_epochs}) against "
                             f"Trainer(max_epochs={max_epochs}): the horizon is set once, on the Trainer")
        if pipeline == "device" and train_augmentor is not None:
            raise ValueError("the device pipeline augments by aug_params; train_augmentor is the "
                             "host pipeline's")
        if corpus is not None and not (pipeline == "device" and device_cache):
            raise ValueError("corpus is the card-resident corpus of pipeline='device', device_cache=True")
        refuse_model_axis(mesh)
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.group is not None else None
        if self.mesh is not None:
            if self.device != self.mesh.device:
                raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
            if batch_size % self.mesh.local_size:
                raise ValueError(f"data.batch_size={batch_size} (the batch of one host) does not divide over "
                                 f"{self.mesh.local_size} ranks")
        self.hosts, self.host = (self.mesh.hosts, self.mesh.host) if self.mesh is not None else (1, 0)
        self.is_main = self.mesh is None or self.mesh.is_main
        self.pipeline_name, self.device_cache = pipeline, bool(device_cache)
        self.fused_epoch, self.fused_pipelined = bool(fused_epoch), bool(fused_pipelined)
        self.fused_dispatch_ahead = bool(fused_dispatch_ahead)
        self.train_info, self.val_info = train_info, val_info
        self.classes = list((train_info or val_info).classes)
        self.batch_size = batch_size
        self.max_targets = max_targets
        self.max_epochs = int(max_epochs)
        self.image_shape = FeatureShape(image_size, image_size)
        self.anchors = anchors or default_anchors()
        # a dataset named fake* lists files that do not exist (JAX :237-241)
        self.fake_mode = fake_mode or val_info.name.startswith("fake")
        self.root_dir = root_dir
        self.enable_ram_cache = enable_ram_cache
        self.num_workers = max(int(num_workers), 1)
        self.net = build_network(len(self.classes), size, num_anchors_per_cell=num_anchors_per_cell,
                                 dtype=dtype, device=self.device, seed=seed)
        broadcast_module_(self.net, self.mesh)  # every rank starts from rank 0's weights
        feed_dtype = torch.float32 if dtype is None else dtype
        self.sampler = sampler
        self.pipeline: Optional[DeviceDataPipeline] = None
        self.prefetcher = None
        if train_info is not None and pipeline == "device":
            self.pipeline = DeviceDataPipeline(
                train_info, image_size, batch_size, aug_params, max_targets=max_targets,
                mixup_prob=mixup_prob, use_mosaic=use_mosaic, warp_precision=warp_precision,
                sampler=sampler, seed=seed, fake_mode=self.fake_mode, device_cache=device_cache,
                feed_dtype=feed_dtype, device=self.device, corpus=corpus, root_dir=root_dir,
                enable_ram_cache=enable_ram_cache, mesh=self.mesh, corpus_sharding=corpus_sharding,
                warp_pallas=warp_pallas, corpus_layout=corpus_layout,
            )
        elif train_info is not None:
            # cv2 and Pillow are needed only here: the host pipeline is imported when asked for
            from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher, RowShare
            from object_detection_cib_torch.data.samplers import ShuffleSampler

            # per-host augment streams (JAX :262-268); the sampler's stream
            # is every host's, sharded by the Prefetcher
            train_ds = DetectionDataset(
                train_info, SampleReader(image_size, self.classes, self.fake_mode, root_dir),
                train_augmentor or TrainSampleAugmentor(aug_params), enable_ram_cache=enable_ram_cache,
                use_mosaic=use_mosaic, mosaic_target_size=image_size, mixup_prob=mixup_prob,
                sampler=sampler, seed=seed + self.host * 1000003)
            # a host's ranks share one maker of its batches (its local rank 0)
            share = None
            if self.mesh is not None and self.mesh.local_size > 1:
                share = RowShare(host_group(self.mesh), self.host * self.mesh.local_size, self.mesh.local_size,
                                 self.mesh.local_rank, (image_size, image_size))
            self.prefetcher = Prefetcher(
                train_ds, batch_size, max_targets, sampler=sampler or ShuffleSampler(train_info, seed=seed),
                num_threads=self.num_workers, device=self.device, feed_dtype=feed_dtype,
                rows=host_batch_sharding(self.mesh, batch_size) if self.mesh is not None else None,
                host=self.host, hosts=self.hosts, share=share)
        if corpus_sharding != "replicated" and self.pipeline is None:
            raise ValueError("corpus_sharding='sharded' is the device pipeline's corpus on the card")
        # each of the hosts feeds its batch of a global one a step (JAX :339-350)
        self.steps_per_epoch = max(len(train_info.samples) // (batch_size * self.hosts), 1) if train_info else 1
        self.optimizer = SmartSGD(self.net, optimizer._replace(max_epochs=self.max_epochs),
                                  self.steps_per_epoch)
        class_weights = None
        if use_loss_weights and train_info is not None:
            class_weights = torch.from_numpy(_compute_loss_weights(train_info)).to(self.device)
        self.class_weights = class_weights
        self.loss_params = loss_params
        self.assign_threshold = float(assign_threshold)
        self.assign_offset_capacity = int(assign_offset_capacity)
        self.assign_compact_slots = assign_compact_slots
        self.train_step = make_train_step(
            self.net, self.anchors, self.image_shape, self.optimizer, loss_params, class_weights,
            assign_threshold=assign_threshold, assign_offset_capacity=assign_offset_capacity,
            assign_compact_slots=assign_compact_slots, mesh=self.mesh, remat_policy=remat_policy)
        # validation feed (JAX :781-786): the val set on the card beside the
        # corpus on the card, else the host feed, built at its first use;
        # under a mesh this rank's shard of it (JAX :705-720, :846-870)
        self.val_indices = np.arange(len(val_info.samples))
        if self.mesh is not None:
            self.val_indices = shard_indices(self.val_indices, self.mesh.rank, self.mesh.size)
        self.val_cache: Optional[ValDeviceCache] = None
        if pipeline == "device" and device_cache and val_device_cache:
            self.val_cache = ValDeviceCache(val_info, self.val_indices, image_size, max_targets,
                                            fake_mode=self.fake_mode, root_dir=root_dir, device=self.device)
        self._val_dataset = None
        # under a mesh each rank validates at its share of the host's batch,
        # as each local device of a JAX host does (JAX :853-859): the
        # batches a rank runs are those of its host in JAX
        eval_batch = batch_size // self.mesh.local_size if self.mesh is not None else batch_size
        self.evaluator = Evaluator(self.net, self.anchors, val_info.classes, batch_size=eval_batch,
                                   conf_thres=val_conf_thres, iou_thres=val_iou_thres, max_nms=val_max_nms,
                                   device=self.device, mesh=self.mesh)
        self.epoch = 0  # epochs trained so far
        self.epoch_imgs: List[int] = []
        self.epoch_walls: List[float] = []
        self.epoch_metrics: List[Dict[str, np.ndarray]] = []
        self._last_sampler_plan: Optional[np.ndarray] = None
        # the runtime, as a plain run has it; from_config sets every one
        self.loop = FitConfig()
        self.early_stopping = EarlyStopping()
        self.ckpt: Optional[CheckpointManager] = None
        self.ckpt_every_n_epochs = 1
        self.loggers: list = []
        self.progress = ProgressTable(enabled=False)
        self.rich_progress = False
        self.sampler_debug = False
        self.debug_nans = False
        self.out_dir: Optional[Path] = None
        self.verbose = False
        self._es_best: Optional[float] = None  # early stopping's best and bad checks, per fit
        self._es_bad = 0
        self._overfit_cache: Optional[list] = None  # overfit_batches: the batches replayed, per fit
        self._fused_fn = None  # the pipeline's FusedEpoch, built at the first fused epoch
        self._fused_inflight = None  # the next epoch, enqueued ahead of this one's fetch
        self._fused_prev_fetch: Optional[float] = None
        self._epoch_stamps: Dict[int, np.ndarray] = {}  # the fused epochs' stage stamps, by epoch
        self._prof = None  # trainer.profiler's trace: None (not started), running, or False (written)

    # ------------------------------------------------------------------ config
    @classmethod
    def from_config(cls, cfg: dict, mesh: Optional[DataMesh] = None) -> "Trainer":
        """A trainer for a composed config, as the JAX ``Trainer(cfg)``; with
        ``mesh``, this rank's (``cli.train`` launches the ranks of
        ``trainer.num_devices`` > 1); in a process that joined a group from
        the environment, that group's rank."""
        tcfg, dcfg, mcfg = cfg["trainer"], cfg["data"], cfg["model"]
        device = device_from_cfg(tcfg)
        _refuse_unported(cfg)
        mesh = _check_mesh(tcfg, device, mesh)
        if mesh is not None and mesh.group is not None:
            device = mesh.device
        say = print if mesh is None or mesh.is_main else (lambda *a, **k: None)
        ignored = [f"{k} ({why})" for k, why in _KEYS_READ_NOT_ACTED_ON.items() if _cfg_get(cfg, k) is not None]
        if ignored:
            say("config keys read and not acted on by the port: " + "; ".join(ignored), flush=True)
        seed = int(cfg.get("seed", 0))
        name = cfg["dataset_name"]
        if name.startswith("fake") and not dcfg.get("fake_mode"):
            say(f"dataset '{name}' implies data.fake_mode=True", flush=True)
            dcfg["fake_mode"] = True
        train_info = _load_dataset(name, "train", dcfg) if cfg.get("train", True) else None
        val_info = _load_dataset(name, "validation", dcfg)

        pipeline = dcfg.get("pipeline") or "host"
        aug_spec = dcfg.get("train_data_augmentor") or {}
        sampler = None
        if train_info is not None and dcfg.get("sampler"):
            sampler = instantiate(dcfg["sampler"])(train_info)
        host_aug = None
        if pipeline != "device":
            host_aug = instantiate(aug_spec) if aug_spec else ValidationSampleAugmentor()
        aug = instantiate(aug_spec["aug_params"]) if aug_spec.get("aug_params") else AugParams()

        ncfg, lcfg, acfg = mcfg["net"], mcfg["loss"], cfg.get("assigners") or {}
        ocfg, scfg, wcfg = mcfg["optimizer"], mcfg["scheduler"], mcfg.get("warmup")
        dtype = {"bfloat16": torch.bfloat16, "float32": None, None: None}[ncfg.get("dtype")]
        t = cls(
            train_info, val_info,
            size={"deepen_factor": float(ncfg.get("deepen_factor", 1.0)),
                  "widen_factor": float(ncfg.get("widen_factor", 1.0))},
            num_anchors_per_cell=int(ncfg.get("num_anchors_per_cell", 3)),
            dtype=dtype,
            image_size=int(dcfg["target_image_size"]),
            batch_size=int(dcfg["batch_size"]),
            aug_params=aug,
            optimizer=OptimizerConfig(
                lr0=float(ocfg["lr0"]),
                momentum=float(ocfg["momentum"]),
                nesterov=bool(ocfg.get("nesterov", True)),
                weight_decay=float(ocfg["weight_decay"]),
                schedule=scfg.get("name", "linear"),
                lrf=float(scfg.get("lrf", 0.01)),
                warmup=WarmupParams(float(wcfg["warmup_epochs"]), float(wcfg["warmup_bias_lr"]),
                                    float(wcfg["warmup_momentum"])) if wcfg else None,
            ),
            loss_params=LossParams(
                lambda_classification=lcfg["lambda_classification"],
                lambda_localization=lcfg["lambda_localization"],
                lambda_objectness=lcfg["lambda_objectness"],
                lambda_ll_objectness=lcfg["lambda_ll_objectness"],
                lambda_ml_objectness=lcfg["lambda_ml_objectness"],
                lambda_hl_objectness=lcfg["lambda_hl_objectness"],
                iou_type=lcfg.get("iou_type", "ciou"),
                eps=float(lcfg.get("eps", 1e-7)),
            ),
            use_loss_weights=bool(cfg.get("use_loss_weights")),
            max_targets=int(dcfg.get("max_targets", 120)),
            seed=seed,
            device=device,
            sampler=sampler,
            mixup_prob=float(dcfg.get("mixup_prob", 0.0)),
            use_mosaic=bool(dcfg.get("use_mosaic", True)),
            warp_precision=dcfg.get("warp_precision", "fast"),
            max_epochs=int(tcfg["max_epochs"]),
            pipeline=pipeline,
            device_cache=bool(dcfg.get("device_cache", False)),
            fake_mode=bool(dcfg.get("fake_mode")),
            enable_ram_cache=bool(dcfg.get("enable_ram_cache", False)),
            num_workers=int(dcfg.get("num_workers", 8)),
            train_augmentor=host_aug,
            anchors=_anchors_from_cfg(mcfg["anchor_info"]),
            assign_threshold=float(acfg.get("threshold", lcfg.get("assigner_threshold", THRESHOLD))),
            assign_offset_capacity=int(acfg.get("offset_capacity", 3)),
            assign_compact_slots=mcfg.get("assign_compact_slots", 128),
            val_conf_thres=float(mcfg.get("val_nms_conf_threshold", 0.001)),
            val_iou_thres=float(mcfg.get("val_nms_iou_threshold", 0.6)),
            val_max_nms=int(mcfg.get("val_nms_max_candidates", 2048)),
            val_device_cache=bool(dcfg.get("val_device_cache", True)),
            # the JAX trainer's defaults for keys a config leaves out (:537-554, :1019-1049)
            fused_epoch=bool(dcfg.get("fused_epoch", True)),
            fused_pipelined=bool(dcfg.get("fused_pipelined", False)),
            fused_dispatch_ahead=bool(dcfg.get("fused_dispatch_ahead", True)),
            mesh=mesh,
            corpus_sharding=dcfg.get("corpus_sharding") or "replicated",
            remat_policy=mcfg.get("remat_policy") or None,
            warp_pallas=dcfg.get("warp_pallas", "auto"),
            corpus_layout=dcfg.get("corpus_layout", "planar"),
        )
        t.loop = FitConfig(
            check_val_every_n_epoch=int(tcfg.get("check_val_every_n_epoch") or 1),
            limit_train_batches=tcfg.get("limit_train_batches"),
            limit_val_batches=tcfg.get("limit_val_batches"),
            fast_dev_run=bool(tcfg.get("fast_dev_run")),
            overfit_batches=tcfg.get("overfit_batches"),
            log_every_n_steps=int(tcfg.get("log_every_n_steps", 20)),
            profiler=tcfg.get("profiler"),
            profile_start_step=int(tcfg.get("profile_start_step", 5)),
            profile_steps=int(tcfg.get("profile_steps", 5)),
        )
        t.debug_nans = bool(tcfg.get("debug_nans"))
        t.verbose = t.is_main

        # ----- logging / checkpoints (JAX :427-481)
        t.out_dir = Path(cfg["paths"]["output_dir"])
        t.out_dir.mkdir(parents=True, exist_ok=True)
        t.loggers = build_loggers(cfg.get("logger")) if t.is_main else []
        t.progress = ProgressTable(interval=int(cfg.get("progress_interval", 20)))
        cb_all = cfg.get("callbacks") or {}
        cb = cb_all.get("model_checkpoint")
        if (cb is None and "model_checkpoint" in cb_all) or not t.is_main:
            t.ckpt = None  # callbacks=none: checkpointing disabled; under a mesh rank 0 writes
        else:
            cb = cb or {}
            t.ckpt = CheckpointManager(Path(cb.get("dirpath", t.out_dir / "checkpoints")),
                                       monitor=cb.get("monitor", "map"), mode=cb.get("mode", "max"))
        t.ckpt_every_n_epochs = max(int((cb or {}).get("every_n_epochs") or 1), 1)
        t.sampler_debug = bool(cb_all.get("sampler_debug")) and t.is_main
        ms = cb_all.get("model_summary")
        if ms and t.is_main:
            t.print_model_summary(int(ms.get("max_depth", 3)))
        t.rich_progress = (bool(cb_all.get("rich_progress_bar")) and not cfg.get("disable_progress_bar")
                           and sys.stdout.isatty())
        t.progress.enabled = not t.rich_progress and t.is_main
        es = cb_all.get("early_stopping") or {}
        t.early_stopping = EarlyStopping(
            monitor=es.get("monitor", "map"), mode=str(es.get("mode", "max")),
            patience=int(es.get("patience", 0)), min_delta=float(es.get("min_delta", 0.0)),
            check_finite=bool(es.get("check_finite", False)))

        n_params = sum(p.numel() for p in t.net.parameters())
        ranks = t.mesh.size if t.mesh is not None else 1
        say(f"model: yolov5 widen={ncfg.get('widen_factor', 1.0)} deepen={ncfg.get('deepen_factor', 1.0)} "
            f"nc={len(t.classes)} params={n_params:,} | device={t.device} x{ranks} ranks on {t.hosts} hosts | "
            f"dataset={name} "
            f"train={len(train_info.samples) if train_info else 0} val={len(val_info.samples)}",
            flush=True)
        if not t.is_main:
            if cfg.get("ckpt_path"):
                t.restore(cfg["ckpt_path"])
            return t
        (t.out_dir / "hparams.json").write_text(json.dumps({
            "num_params": n_params,
            "num_classes": len(t.classes),
            "widen_factor": float(ncfg.get("widen_factor", 1.0)),
            "deepen_factor": float(ncfg.get("deepen_factor", 1.0)),
            "batch_size": t.batch_size,
            "image_size": t.image_shape.width,
            "steps_per_epoch": t.steps_per_epoch,
            "dataset": name,
        }, indent=2))
        if cfg.get("ckpt_path"):
            t.restore(cfg["ckpt_path"])
        return t

    def restore(self, path: Path) -> None:
        """Load a checkpoint's parameters, BN statistics, momentum buffers and
        step count; ``fit`` goes on from epoch ``step_count // steps_per_epoch``
        (JAX :983-985). Under a mesh every rank reads it, after a barrier:
        over several hosts the path must be visible from every host."""
        barrier(self.mesh)
        restore_checkpoint(path, self.net, self.optimizer)
        self.epoch = self.optimizer.step_count // self.steps_per_epoch

    def print_model_summary(self, max_depth: int = 3) -> None:
        """Parameters per module path (the flax paths, ``models/convert.py``)
        to ``max_depth`` (RichModelSummary analog)."""
        groups: Dict[str, int] = {}
        for name, p in self.net.named_parameters():
            key = "/".join(name.split(".")[:max_depth])
            groups[key] = groups.get(key, 0) + p.numel()
        try:
            from rich.console import Console
            from rich.table import Table

            t = Table(title=f"model summary (depth {max_depth})")
            t.add_column("module")
            t.add_column("params", justify="right")
            for k, v in groups.items():
                t.add_row(k, f"{v:,}")
            t.add_row("TOTAL", f"{sum(groups.values()):,}")
            Console().print(t)
        except ImportError:
            for k, v in groups.items():
                print(f"  {k}: {v:,}")

    # -------------------------------------------------------------- validation
    def val_prefetcher(self):
        """The host validation feed: every val image once, letterboxed, in
        order, the last batch short (JAX ``_val_prefetcher``)."""
        from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher

        if self._val_dataset is None:
            self._val_dataset = DetectionDataset(
                self.val_info, SampleReader(self.image_shape.width, self.classes, self.fake_mode,
                                            self.root_dir),
                ValidationSampleAugmentor(), enable_ram_cache=self.enable_ram_cache)
        from object_detection_cib_torch.data.samplers import FixedSampler

        sampler = FixedSampler(self.val_indices) if self.mesh is not None else None
        return Prefetcher(self._val_dataset, self.evaluator.batch_size, self.max_targets, sampler=sampler,
                          num_threads=self.num_workers, drop_last=False, device=None)

    def _val_batches(self, total: int) -> int:
        """Validation batches to run of ``total`` (JAX :790-797, :911-917)."""
        if self.loop.fast_dev_run:
            return 1
        if self.loop.limit_val_batches:
            return _fraction_of(total, self.loop.limit_val_batches)
        return total

    def validate(self) -> Dict[str, float]:
        """mAP over the val set (or the part ``limit_val_batches`` or
        ``fast_dev_run`` leaves), through the feed the trainer chose."""
        if self.val_cache is not None:
            nb = max(-(-len(self.val_cache) // self.evaluator.batch_size), 1)
            metrics = self.evaluator.validate(self.val_cache, self._val_batches(nb))
        else:
            feed = self.val_prefetcher()
            batches = iter(feed)
            try:
                metrics = self.evaluator.validate_batches(
                    (b for _, b in zip(range(self._val_batches(len(feed))), batches)), self.val_indices)
            finally:
                batches.close()
        if self.verbose:
            _print_map_table(metrics)
        return metrics

    def predict(self, out_path: Optional[Path] = None) -> list:
        """Detections over the host validation feed as per-image dicts,
        optionally dumped as JSON (the JAX ``Trainer.predict``)."""
        return self.evaluator.predict_batches(self.val_prefetcher(), out_path)

    # ---------------------------------------------------------------- training
    def _train_batches(self, n_steps: int) -> Iterator[Tuple[Batch, Optional[torch.Tensor]]]:
        """``(batch, overflow)`` for ``n_steps`` steps of one epoch; the
        overflow is a device scalar from the device pipeline (not added to
        its total: ``fit`` fetches it with the losses) and None from the
        host feed, which counts its own."""
        if self.pipeline is not None:
            yield from self.pipeline.epoch(n_steps, track_overflow=False)
            return
        batches = iter(self.prefetcher)
        try:
            for _, batch in zip(range(n_steps), batches):
                yield batch, None
        finally:
            batches.close()

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log(metrics, step)

    def fit(self, max_epochs: Optional[int] = None, epoch_steps: Optional[int] = None,
            on_step: Optional[Callable[[int, int, StepMetrics], None]] = None) -> Dict[str, float]:
        """Train on to epoch ``max_epochs`` (by default the trainer's
        ``max_epochs``, the lr schedule's horizon, which it may not pass; one
        epoch under ``fast_dev_run``), validating every
        ``loop.check_val_every_n_epoch`` epochs; returns the last mAP dict.

        Epochs count on from earlier calls and from a restored checkpoint,
        as the JAX trainer's loop runs ``range(start_epoch, max_epochs)``.
        Where ``_fused_config`` selects it, and neither ``on_step`` nor
        ``debug_nans`` asks for per-step control, an epoch is the fused
        epoch (``_fused_epoch``); otherwise the step loop, whose steps are
        ``steps_per_epoch``, one under ``fast_dev_run``, else
        ``max(int(steps * limit_train_batches), 1)``. ``epoch_steps`` caps
        the steps of either loop (an integer, the port's own knob).
        ``on_step(epoch, step, metrics)`` runs after each step is enqueued.
        Per epoch, the images (the fused epoch's global batches, the step
        loop's host batches: the JAX rule) and the wall time (host clock,
        ending in the host fetch of the epoch's metrics; fetch to fetch in
        the fused loop) are recorded, and the per-step metrics and the targets dropped by
        ``max_targets`` come back to the host in one copy of one
        ``f32[7, steps]`` matrix (``METRIC_ROWS``, overflow last):
        ``epoch_metrics`` holds per step ``total``, ``box``, ``obj``,
        ``cls``, ``lr`` and ``assign_drop``, and the epoch's
        ``targets_dropped`` (and on the fused loop ``stage_ms``, from the
        stage stamps copied with the matrix). The loggers and the progress
        table get every ``log_every_n_steps``-th step's losses from that
        copy; each validation's call also carries ``images_per_sec`` and
        the stage ms (``stage_ms.<stage>``).
        """
        if self.train_info is None:
            raise RuntimeError("this trainer was built without a training set (train=False)")
        loop = self.loop
        stop = 1 if loop.fast_dev_run else (self.max_epochs if max_epochs is None else int(max_epochs))
        if stop > self.max_epochs:
            raise ValueError(f"fit(max_epochs={stop}) would train past the lr schedule's horizon, "
                             f"Trainer(max_epochs={self.max_epochs})")
        with torch.autograd.set_detect_anomaly(self.debug_nans):
            return self._fit(stop, epoch_steps, on_step)

    def _fit(self, stop: int, epoch_steps: Optional[int], on_step) -> Dict[str, float]:
        loop = self.loop
        val_every = max(int(loop.check_val_every_n_epoch), 1)
        log_every = max(int(loop.log_every_n_steps), 1)
        fused = self._fused_config() and on_step is None and not self.debug_nans
        n_steps = self.steps_per_epoch
        if loop.fast_dev_run:
            n_steps = 1
        elif loop.limit_train_batches:
            n_steps = _fraction_of(n_steps, loop.limit_train_batches)
        if epoch_steps:
            n_steps = min(int(epoch_steps), n_steps)
        self._prof = None
        self._overfit_cache = None
        self._es_best, self._es_bad = None, 0
        # a fit interrupted mid-epoch must not leave an epoch for the next fit
        self._fused_inflight = self._fused_prev_fetch = None
        last_val: Dict[str, float] = {}
        for epoch in range(self.epoch, stop):
            t0 = time.perf_counter()
            boundary_snap = None  # the state at this epoch's end, when the next is already enqueued
            stamps = None
            if fused:
                flat, stamps, step0, boundary_snap, prev_fetch = self._fused_epoch(
                    epoch, stop, val_every, epoch_steps)
                host_dropped = 0
                if prev_fetch is not None:
                    t0 = prev_fetch
                if self._profile_ends(step0 + flat.shape[1]):
                    self._end_profile()
            else:
                step0 = self.optimizer.step_count
                flat, host_dropped = self._step_epoch(epoch, n_steps, on_step)
            n = flat.shape[1]
            self.epoch_walls.append(time.perf_counter() - t0)
            # the JAX rule (:1101-1103): the fused epoch's global batch, the step loop's host batch
            self.epoch_imgs.append(n * self.batch_size * (self.hosts if fused else 1))
            metrics = {k: flat[j] for j, k in enumerate(METRIC_ROWS)}
            if self._overfit_cache is not None:
                dropped = 0  # replayed batches: counted where they were made
            elif self.pipeline is not None:
                dropped = int(flat[-1].sum())
                self.pipeline.add_overflow(dropped)
            else:
                dropped = host_dropped
            metrics["targets_dropped"] = np.int64(dropped)
            if stamps is not None:
                self._epoch_stamps[epoch] = stamps
                metrics["stage_ms"] = tracing.stage_ms(stamps)
            self.epoch_metrics.append(metrics)
            self.epoch = epoch + 1
            for i in range(n):
                gstep = step0 + i + 1
                if gstep % log_every == 0:
                    logged = {k: float(metrics[k][i]) for k in ("box", "obj", "cls", "total", "lr")}
                    self._log(logged, gstep)
                    self.progress.update(epoch, gstep, logged)
            gstep = step0 + n
            seconds = self._epoch_seconds(epoch)
            ips = self.epoch_imgs[-1] / seconds
            stage = metrics.get("stage_ms", {})
            self._warn_overflow(epoch, int(metrics["assign_drop"].sum()), dropped, gstep)
            if self.verbose:
                print(f"[epoch {epoch}] train ips={ips:.1f} ({self.epoch_imgs[-1]} imgs in {seconds:.2f}s)"
                      + (", device ms a step: " + " ".join(f"{k} {v:.2f}" for k, v in stage.items())
                         if stage else ""), flush=True)

            if (epoch + 1) % val_every == 0 or loop.fast_dev_run:
                before = tracing.counters()
                last_val = self.validate()
                spans = {k: tracing.ms_per_call(before, tracing.counters(), f"infer.{k}")
                         for k in ("forward", "decode", "nms")}
                last_val["images_per_sec"] = ips
                self._log({**last_val, **{f"stage_ms.{k}": v for k, v in stage.items()}}, gstep)
                if self.verbose:
                    print(f"[epoch {epoch}] map={last_val.get('map', 0):.4f} "
                          f"map50={last_val.get('map50', 0):.4f} ips={ips:.1f}; host ms a batch: "
                          + " ".join(f"{k} {v:.2f}" for k, v in spans.items() if v is not None), flush=True)
                if self.ckpt:
                    self.ckpt.maybe_save_best(Snapshot(self.net, self.optimizer), last_val)
                reason = self._early_stop_reason(last_val)
                if reason is not None:
                    if self.is_main:
                        print(f"early stopping: {reason}", flush=True)
                    if self.ckpt:
                        self.ckpt.save_last(Snapshot(self.net, self.optimizer))
                        # saves are off-thread: drain, so that a caller reading
                        # the checkpoint right after fit sees a complete 'last'
                        self.ckpt.wait_until_finished()
                    barrier(self.mesh)
                    return last_val
            if self.ckpt and (epoch + 1) % self.ckpt_every_n_epochs == 0:
                self.ckpt.save_last(boundary_snap or Snapshot(self.net, self.optimizer))
            if self.sampler_debug:
                self._dump_sampler_stats(epoch, n)

        if self._prof:
            self._end_profile()
        if self.ckpt and stop % self.ckpt_every_n_epochs != 0:
            # the cadence skipped the final epoch's save: 'last' must still be
            # the end-of-fit state
            self.ckpt.save_last(Snapshot(self.net, self.optimizer))
        if self.ckpt:
            self.ckpt.wait_until_finished()
        barrier(self.mesh)  # rank 0's checkpoint is whole before any rank goes on
        return last_val

    def _step_epoch(self, epoch: int, n_steps: int, on_step):
        """One epoch of the step loop: -> (the f32[7, steps] metric matrix on
        the host, the targets the host feed dropped).
        Under ``overfit_batches`` the first epoch's batches are kept in
        ``_overfit_cache`` and replayed."""
        loop = self.loop
        if loop.overfit_batches:
            if self._overfit_cache is None:  # the first k batches of one epoch, replayed
                self._overfit_cache = [(b, None) for b, _ in self._train_batches(int(loop.overfit_batches))]
            batches = iter(self._overfit_cache[:n_steps])
        else:
            batches = self._train_batches(n_steps)
        host_dropped = self.prefetcher.overflow_total if self.prefetcher is not None else 0
        bar = None
        if self.rich_progress:
            from object_detection_cib_torch.utils.loggers import RichEpochProgress

            bar = RichEpochProgress(epoch, n_steps)
        table = self.optimizer.hyper_table(self.optimizer.step_count, n_steps, self.device)
        no_overflow = torch.zeros((), dtype=torch.int32, device=self.device)  # the host feed counts its own
        cols = []
        for i, (batch, ovf) in enumerate(batches):
            self._maybe_start_profile(self.optimizer.step_count, self.optimizer.step_count + 1)
            m = self.train_step(batch, table[i])
            cols.append(metric_column(m, no_overflow if ovf is None else ovf))
            if self._profile_ends(self.optimizer.step_count):
                self._end_profile()
            if bar is not None:
                bar.advance()
            if on_step is not None:
                on_step(epoch, i, m)
        if bar is not None:
            bar.close()
        flat = self._sum_over_ranks(torch.stack(cols, 1)).cpu().numpy()
        if self.prefetcher is not None:
            host_dropped = self.prefetcher.overflow_total - host_dropped
        return flat, host_dropped

    # ------------------------------------------------------- the fused epoch
    def _fused_config(self) -> bool:
        """True when the configuration selects the fused epoch, by the JAX
        trainer's rule (:537-554): the device pipeline with the corpus on
        the card and ``fused_epoch``, and none of ``fast_dev_run``,
        ``overfit_batches`` or ``limit_train_batches`` (per-step control
        flow, which the step loop runs). The JAX rule also takes the step
        loop for ``profiler``; here the profiler traces whichever loop runs
        (``_maybe_start_profile``), so a trace shows the loop users run.
        ``fit`` also takes the step loop for its own per-step knobs,
        ``on_step`` and ``debug_nans`` (anomaly mode checks every backward
        on the host)."""
        loop = self.loop
        return (self.pipeline_name == "device" and self.device_cache and self.fused_epoch
                and not (loop.fast_dev_run or loop.overfit_batches or loop.limit_train_batches))

    def _fused_epoch(self, epoch: int, stop: int, val_every: int, epoch_steps: Optional[int]):
        """One epoch of the fused loop (the JAX trainer's :1019-1131):
        -> (the f32[7, steps] metric matrix on the host, the epoch's first
        global step, the boundary ``Snapshot`` or None, the previous fetch's
        host time or None).

        The epoch is ``pipeline.build_fused_epoch_fn`` over the whole plan
        (cut by ``epoch_steps``), with SmartSGD's hyperparameter table; on
        the card one captured CUDA graph a step. Dispatch-ahead: when nothing
        at this epoch's boundary reads the state (validation, and with it
        early stopping and the best checkpoint, or the end of ``fit``), the
        next epoch is enqueued before this one's metrics are fetched, after
        a ``Snapshot`` for a ``save_last`` due at this boundary."""
        if self._fused_fn is None:
            self._fused_fn = self.pipeline.build_fused_epoch_fn(
                lambda batch, hp: self.train_step(batch, hp), pipelined=self.fused_pipelined,
                stack_metrics=True, graph=False if self.mesh is not None and self.mesh.backend == "gloo" else None)
        pending, self._fused_inflight = self._fused_inflight, None
        if pending is None:
            pending = self._enqueue_epoch(epoch, epoch_steps)
        host, stamps, event, step0 = pending
        boundary_snap = None
        # the trace's end reads the card too (a synchronize before it is written)
        reads_state = ((epoch + 1) % val_every == 0 or epoch + 1 >= stop
                       or self._profile_ends(step0 + host.shape[1]))
        if self.fused_dispatch_ahead and not reads_state:
            if self.ckpt and (epoch + 1) % self.ckpt_every_n_epochs == 0:
                boundary_snap = Snapshot(self.net, self.optimizer)
            self._fused_inflight = self._enqueue_epoch(epoch + 1, epoch_steps)
        with tracing.span("train.fetch"):
            if event is not None:
                event.synchronize()
        prev, self._fused_prev_fetch = self._fused_prev_fetch, time.perf_counter()
        return host.numpy(), stamps.numpy(), step0, boundary_snap, prev

    def _enqueue_epoch(self, epoch: int, epoch_steps: Optional[int]):
        """Enqueue one fused epoch and the copies of its metric matrix and
        its stage stamps into pinned memory: -> (host matrix, host stamps,
        the CUDA event behind both copies or None on the CPU, the epoch's
        first global step). ``step_count`` moves to the epoch's end: the
        steps are enqueued. The profiler starts here for an epoch that
        holds a step of its window."""
        step0 = self.optimizer.step_count
        with tracing.span("train.plan"):
            xs = self.pipeline.epoch_host_arrays(epoch_steps)
        n = int(xs[0].shape[0])
        self._maybe_start_profile(step0, step0 + n)
        flat = self._sum_over_ranks(self._fused_fn(xs, self.optimizer.hyper_table(step0, n)))
        stamps = self._fused_fn.stamps
        self.optimizer.step_count = step0 + n
        if not flat.is_cuda:
            return flat, stamps, None, step0
        host, host_stamps = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (flat, stamps))
        host.copy_(flat, non_blocking=True)
        host_stamps.copy_(stamps, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, host_stamps, event, step0

    def _sum_over_ranks(self, flat: torch.Tensor) -> torch.Tensor:
        """An epoch's metric matrix on the device summed over the mesh's
        ranks in place, the ``lr`` row (every rank's) kept: one all-reduce
        an epoch. Unchanged without a mesh."""
        if self.mesh is None:
            return flat
        lr = flat[LR_ROW].clone()
        all_reduce_sum_(flat, self.mesh.group)
        flat[LR_ROW] = lr
        return flat

    def device_epoch_walls(self) -> Dict[int, float]:
        """The fused epochs' device times, ``{epoch: seconds}``: between the
        last stage stamps (``utils/tracing.py:mark``) of consecutive fetched
        epochs, on the card's clock (the JAX trainer's readiness stamps,
        :570-633, with neither a thread nor an environment variable; the
        host's clock on the CPU). An epoch whose predecessor has no stamps
        (the first) is left out; a gap between the two (a validation, the
        host's wait) counts in."""
        last = {e: b[1] for e, s in self._epoch_stamps.items() if (b := tracing.epoch_bounds(s))}
        return {e: (t - last[e - 1]) / 1e9 for e, t in last.items() if e - 1 in last}

    def _epoch_seconds(self, epoch: int) -> float:
        """The time ``images_per_sec`` rates the epoch by: on the fused epoch
        its stamps' span, from the later of the previous epoch's last stamp
        and its own first to its own last (the card's clock, the host's on
        the CPU), which holds neither the next epoch's time, which the host
        window holds under dispatch-ahead, nor a validation between; the
        host window otherwise."""
        own, before = (tracing.epoch_bounds(self._epoch_stamps.get(e)) for e in (epoch, epoch - 1))
        if own is None:
            return self.epoch_walls[-1]
        start = own[0] if before is None else max(own[0], before[1])
        return (own[1] - start) / 1e9 if own[1] > start else self.epoch_walls[-1]

    # ------------------------------------------------------------- profiler
    def _profile_window(self) -> Tuple[int, int]:
        return self.loop.profile_start_step, self.loop.profile_start_step + self.loop.profile_steps

    def _maybe_start_profile(self, first: int, end: int) -> None:
        """Start ``trainer.profiler``'s trace before steps [first, end) are
        enqueued when they hold a step of its window (main rank, once a fit)."""
        a, b = self._profile_window()
        if self.loop.profiler and self.is_main and self._prof is None and first < b and end > a:
            self._prof = _start_profiler(self.device)

    def _profile_ends(self, steps_done: int) -> bool:
        """Whether a running trace's window is over once ``steps_done`` steps
        have run."""
        return bool(self._prof) and steps_done >= self._profile_window()[1]

    def _end_profile(self) -> None:
        _stop_profiler(self._prof, self.device, self._profile_dir(), self._profile_window())
        self._prof = False

    def _warn_overflow(self, epoch: int, adrop: int, dropped: int, step: int) -> None:
        """The JAX trainer's warnings for the epoch's compaction drops and the
        targets beyond ``max_targets`` (:1196-1212)."""
        if adrop and self.is_main:
            print(f"[epoch {epoch}] WARNING: {adrop} valid assignment slots dropped by loss-table "
                  "compaction this epoch; raise model.assign_compact_slots", flush=True)
        if dropped:
            if self.is_main:
                print(f"[epoch {epoch}] WARNING: {dropped} targets dropped by max_targets={self.max_targets} "
                      "capacity this epoch", flush=True)
            self._log({"targets_dropped": float(dropped)}, step)

    def _early_stop_reason(self, last_val: Dict[str, float]) -> Optional[str]:
        """Lightning ``EarlyStopping``: improvement is ``sign * (cur - best) >
        min_delta``; a stop after ``patience`` checks without one, or at once
        on a non-finite value with ``check_finite`` (JAX :1240-1273)."""
        es = self.early_stopping
        cur = last_val.get(es.monitor)
        if not es.patience or cur is None:
            return None
        if es.check_finite and not math.isfinite(cur):
            return f"{es.monitor} = {cur} is not finite"
        sign = -1.0 if es.mode == "min" else 1.0
        if self._es_best is None or sign * (cur - self._es_best) > es.min_delta:
            self._es_best, self._es_bad = cur, 0
            return None
        self._es_bad += 1
        if self._es_bad >= es.patience:
            return (f"no {es.monitor} improvement (mode={es.mode}, min_delta={es.min_delta}) "
                    f"for {es.patience} epochs")
        return None

    def _profile_dir(self) -> Path:
        return (self.out_dir or Path(".")) / "profile"

    def sampler_stats(self, consumed_steps: Optional[int] = None) -> Optional[Dict[str, int]]:
        """Instances per class that the oldest epoch not yet counted fed to
        the augment (the JAX trainer's ``_dump_sampler_stats``, :1299-1330).

        Counted from the pipeline's ``consumed_plan_log`` (first in, first
        out), trimmed to the ``consumed_steps`` actually trained; mosaic
        co-samples and mixup partners count. The sampler is never drawn, so
        asking does not change the training stream. With the log empty the
        last plan counted is used again; None when no epoch was planned.
        """
        feed = self.pipeline if self.pipeline is not None else self.prefetcher
        log = feed.consumed_plan_log
        if log:
            self._last_sampler_plan = log.popleft()
        if self._last_sampler_plan is None:
            return None
        return plan_instance_counts(self.train_info, self._last_sampler_plan[:consumed_steps])

    def _dump_sampler_stats(self, epoch: int, consumed_steps: int) -> None:
        """``sampler_stats_epoch{N}.json`` in the output directory."""
        counts = self.sampler_stats(consumed_steps)
        if counts is not None:
            out = (self.out_dir or Path(".")) / f"sampler_stats_epoch{epoch}.json"
            out.write_text(json.dumps(counts, indent=2))


def plan_instance_counts(info: DatasetInfo, rows: np.ndarray) -> Dict[str, int]:
    """Instances per class over the corpus rows ``rows`` of an epoch plan."""
    per_image = np.zeros((len(info.samples), len(info.classes)), np.int64)
    index = {c: i for i, c in enumerate(info.classes)}
    for i, s in enumerate(info.samples):
        for t in s.targets:
            per_image[i, index[t.class_name]] += 1
    total = per_image[np.asarray(rows, np.int64).ravel()].sum(0)
    return {c: int(total[i]) for i, c in enumerate(info.classes)}


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, device: torch.device, out_dir: Path, window: Tuple[int, int]) -> Path:
    """End the trace of steps [window) and write it as a Chrome trace."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    prof.stop()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"steps_{window[0]}-{window[1]}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    return path


def _print_map_table(metrics: Dict[str, float]) -> None:
    """mAP summary table (parity: ref pycoco_map_eval.py:108-138)."""
    try:
        from rich.console import Console
        from rich.table import Table

        table = Table(title="MAP", show_header=False, show_lines=False)
        for k, v in metrics.items():
            table.add_row(k, f"{v:.4f}")
        Console().print(table)
    except ImportError:
        for k, v in metrics.items():
            print(f"  {k}: {v:.4f}")


# ---------------------------------------------------------------- the config

# keys the port reads and does not act on, and why (named at start-up)
_KEYS_READ_NOT_ACTED_ON = {
    "model.net.stem_space_to_depth": "a TPU rewrite of the same 6x6/2 stem function",
    "trainer.compile_cache": "XLA's compile cache",
    "trainer.deterministic": "the JAX trainer ignores it too",
    "trainer.min_epochs": "the JAX trainer reads it nowhere; a fit stops at max_epochs or early stopping",
    "model.scheduler.step_size": "neither trainer passes it on: the step schedule halves every 100 epochs, "
                                 "make_schedule's default",
    "model.scheduler.gamma": "neither trainer passes it on: the step schedule's factor is 0.5, "
                             "make_schedule's default",
}


def _cfg_get(cfg: dict, dotted: str):
    node = cfg
    for k in dotted.split("."):
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def device_from_cfg(tcfg: dict) -> torch.device:
    """``trainer.platform``: null is the card (no fallback), "cpu" the CPU."""
    platform = tcfg.get("platform")
    if platform in (None, "cuda", "gpu"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"trainer.platform={platform or 'null'} runs on the card, and "
                               "torch.cuda.is_available() is False: trainer=cpu runs on the CPU (device='cpu')")
        return resolve_device("cuda")
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"trainer.platform={platform!r}: the port runs on 'cuda' (null) or 'cpu'")


def _refuse_unported(cfg: dict) -> None:
    """Raise, naming the key, for what the port does not run."""
    tcfg, dcfg, mcfg = cfg["trainer"], cfg["data"], cfg["model"]
    if mcfg.get("remat_policy") and mcfg["remat_policy"] not in REMAT_SAVES:
        raise ValueError(f"model.remat_policy={mcfg['remat_policy']!r}: one of {sorted(REMAT_SAVES)} or null")
    sharding = dcfg.get("corpus_sharding") or "replicated"
    if sharding not in ("replicated", "sharded"):
        raise ValueError(f"data.corpus_sharding={sharding!r}: 'replicated' or 'sharded'")
    if sharding == "sharded" and not (dcfg.get("pipeline") == "device" and dcfg.get("device_cache")):
        raise ValueError("data.corpus_sharding=sharded spreads the corpus on the card over the ranks: it needs "
                         "data.pipeline=device data.device_cache=True")
    layout = dcfg.get("corpus_layout", "planar")
    if layout not in LAYOUTS:
        raise ValueError(f"data.corpus_layout={layout!r}: one of {LAYOUTS}")


def num_devices_from_cfg(tcfg: dict) -> int:
    """The ranks ``trainer.num_devices`` asks for: null is every visible
    card (JAX: every visible device), or one process on the CPU; more than
    the cards visible raises."""
    n = tcfg.get("num_devices")
    if n is not None and int(n) < 1:
        raise ValueError(f"trainer.num_devices={n}")
    if tcfg.get("platform") == "cpu":
        return 1 if n is None else int(n)
    visible = torch.cuda.device_count()
    if n is None:
        if not visible:
            raise RuntimeError("trainer.num_devices=null takes every visible card, and none is visible; "
                               "trainer=cpu runs on the CPU")
        return visible
    if int(n) > visible:
        raise ValueError(f"trainer.num_devices={n} but {visible} cards are visible")
    return int(n)


def _check_mesh(tcfg: dict, device: torch.device, mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    """The mesh a trainer of this config is built on, a group joined from
    the environment included (``join_torchrun`` and ``launch`` hand over
    theirs); its ranks on a host against the config's
    ``trainer.num_devices``. A group joined with no mesh handed over
    raises: its hosts are the caller's to say."""
    import torch.distributed as dist

    if mesh is None and dist.is_available() and dist.is_initialized():
        raise ValueError("this process joined a process group but no DataMesh was handed over: pass the mesh "
                         "(join_torchrun returns one; after initialize_multihost, make_mesh(device=..., "
                         "hosts=num_processes)) to Trainer.from_config or train")
    n = num_devices_from_cfg(tcfg)
    grouped = mesh is not None and mesh.group is not None
    ranks = mesh.local_size if grouped else 1
    if n != ranks:
        raise ValueError(f"trainer.num_devices resolves to {n} ranks a host but this trainer is built on {ranks} "
                         f"(of {mesh.size if grouped else 1} over {mesh.hosts if grouped else 1} hosts): cli.train "
                         "launches the ranks (parallel.distributed.launch)")
    if grouped and mesh.device.type != device.type:
        raise ValueError(f"the mesh is on {mesh.device} but trainer.platform selects {device.type}")
    return mesh


def _anchors_from_cfg(anchor_cfg: dict) -> LevelAnchors:
    def info(d):
        return AnchorBoxInfo(stride=d["stride"], boxes_wh=[FeatureShape(w, h) for w, h in d["boxes_wh"]])

    return LevelAnchors(ll=info(anchor_cfg["ll"]), ml=info(anchor_cfg["ml"]), hl=info(anchor_cfg["hl"]))


def _load_dataset(name: str, split: str, cfg: dict) -> DatasetInfo:
    """Resolve a dataset by name (the JAX trainer's ``_load_dataset``): fake
    names build a manifest, a cached manifest comes next, ``synthetic*``
    names are built and cached when missing or stale against the genparams
    sidecar; an unknown name that is not cached raises ``ValueError``."""
    from object_detection_cib_torch.data.enums import DatasetName

    known = {d.value for d in DatasetName}
    registered = name in known or name.startswith(("fake", "synthetic"))
    if name.startswith("fake"):
        return build_fake_manifest(
            name=name,
            num_classes=int(cfg.get("fake_num_classes", 10)),
            num_images=int(cfg.get("fake_num_images", 64 if split == "train" else 16)),
            seed=0 if split == "train" else 1,
        )
    cache_dir = cfg.get("dataset_cache_dir")

    def synth_genparams():
        n = (cfg.get("synthetic_images", 400) if split == "train"
             else cfg.get("synthetic_val_images", cfg.get("synthetic_images", 100)))
        return {"num_images": int(n), "seed": 0 if split == "train" else 1}

    try:
        info = deserialize_cached_dataset(name, split, cache_dir)
        if name.startswith("synthetic"):
            # an explicit size wins over a stale cache, and a cache built with
            # other generation parameters is not reused (the sidecar)
            explicit = (cfg.get("synthetic_images") if split == "train"
                        else cfg.get("synthetic_val_images", cfg.get("synthetic_images")))
            if explicit is not None:
                want = synth_genparams()
                recorded = _read_genparams(name, split, cache_dir)
                if recorded is not None and recorded != want:
                    raise FileNotFoundError(f"cached {name}-{split} was generated with {recorded}, "
                                            f"requested {want}; rebuilding")
                if len(info.samples) != int(explicit):
                    raise FileNotFoundError(f"cached {name}-{split} has {len(info.samples)} samples, "
                                            f"requested {explicit}; rebuilding")
        return info
    except FileNotFoundError as e:
        if not name.startswith("synthetic"):
            if not registered:
                raise ValueError(f"unknown dataset {name!r}: not in the DatasetName registry "
                                 f"{sorted(known)} and no cached manifest found ({e})") from e
            raise
        from object_detection_cib_torch.data.cache import serialize_cached_dataset
        from object_detection_cib_torch.utils.fs import get_root_dir

        out_dir = get_default_datasets_dir()
        gen = synth_genparams()
        info = build_synthetic_dataset(out_dir, name=f"{name}-{split}", num_images=gen["num_images"],
                                       seed=gen["seed"], path_prefix=str(out_dir.relative_to(get_root_dir())))
        info = info._replace(name=name)
        serialize_cached_dataset(info, split, cache_dir)
        _write_genparams(name, split, cache_dir, gen)
        return info


def _genparams_path(name: str, split: str, cache_dir) -> Path:
    base = Path(cache_dir) if cache_dir else get_default_dataset_cache_dir()
    return base / f"kod-{name}-{split}.genparams.json"


def _read_genparams(name: str, split: str, cache_dir):
    try:
        return json.loads(_genparams_path(name, split, cache_dir).read_text())
    except (OSError, ValueError):
        return None


def _write_genparams(name: str, split: str, cache_dir, gen: dict) -> None:
    p = _genparams_path(name, split, cache_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(gen))


def get_metric_value(metric_dict: Dict[str, float], metric_name) -> Optional[float]:
    """The sweep-optimized metric of a task's metric dict (parity:
    kod/lightning/hydra_utils/misc.py:108-128): None when no name is asked
    for; a name absent from the metrics raises ``KeyError``."""
    if not metric_name:
        return None
    if metric_name not in metric_dict:
        raise KeyError(f"Metric value not found! <metric_name={metric_name}>. Available: "
                       f"{sorted(metric_dict)}. Make sure the `optimized_metric` name matches a logged metric.")
    return float(metric_dict[metric_name])


def train(cfg: dict, mesh: Optional[DataMesh] = None) -> Dict[str, float]:
    """The entry task (parity: kod/lightning/tasks/trainer.py train()): fit,
    then test, then predict, then finalize the loggers; with ``mesh``, this
    rank's part (every rank returns the same metrics)."""
    trainer = Trainer.from_config(cfg, mesh)
    metrics: Dict[str, float] = {}
    if cfg.get("train", True):
        metrics = trainer.fit()
    if cfg.get("test", False):
        metrics = trainer.validate()
        if trainer.is_main:
            print(json.dumps(metrics, indent=2))
    if cfg.get("predict", False):
        trainer.predict(trainer.out_dir / "predictions.json")
    for lg in trainer.loggers:  # close run-scoped backends (tensorboard/wandb/mlflow)
        getattr(lg, "finalize", lambda: None)()
    return metrics
