"""The training loop, and validation and prediction over the val set.

The counterpart of ``object_detection_cib_tpu/train/trainer.py`` in two
parts. ``Trainer`` runs the training loop from plain arguments through one
of the JAX package's three feeds (its ``__init__`` and
``_train_prefetcher``, :263-284, :635-701): the device pipeline with the
corpus on the card (per step K2, K5, K4 and the train step; the production
loop), the device pipeline fed per step by the host (K5, K4), or the host
pipeline (``data/pipeline.py``: reader, mosaic, affine, HSV and flip in
numpy and cv2, a ``Prefetcher`` of worker threads), over fake draws or
JPEG files. The imbalance recipes are arguments: a sampler, ``mixup_prob``,
``use_mosaic``, ``warp_precision`` and, through ``aug_params``, a general
affine. Per epoch it validates.

``Evaluator.validate`` is the counterpart of ``Trainer._validate_device``
(train/trainer.py:832-956 of the JAX package) and ``Evaluator.
validate_batches`` of ``Trainer.validate``'s host feed (:787-830);
``Evaluator.predict`` of ``Trainer.predict``'s per-image dicts
(:1333-1382). The uint8 canvases of a ``ValDeviceCache`` go to the card
once, as one (nb, B, S, S, 3) tensor padded with zero images; each block is
sliced, scaled by 1/255 and run through the eval step. The host feed copies
each batch up, the last one padded to B with zero images. Either way the
host converts and scores batch i-1 while the card runs batch i (a one-deep
pipeline: results come back by a non-blocking copy into pinned memory, and
the host waits on that copy's event only).

Not here yet: config composition and the CLI (ROADMAP A6), checkpoints,
loggers, early stopping, ``check_val_every_n_epoch`` and
``limit_val_batches``, the sampler-statistics file (``sampler_stats``
returns the counts), the software-pipelined or CUDA-graph epoch (A5), and
the multi-host feed and mAP merge (A7).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.core.nms import NMSResult
from object_detection_cib_torch.core.types import FeatureShape, LevelAnchors, default_anchors
from object_detection_cib_torch.data.cache import DatasetInfo
from object_detection_cib_torch.data.device_pipeline import DeviceCorpus, DeviceDataPipeline
from object_detection_cib_torch.data.host_augment import (
    AugParams,
    TrainSampleAugmentor,
    ValidationSampleAugmentor,
)
from object_detection_cib_torch.data.reader import SampleReader
from object_detection_cib_torch.data.val_cache import ValDeviceCache
from object_detection_cib_torch.eval.coco_map import MeanAveragePrecisionEvaluator
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.train.loss import LossParams
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import Batch, StepMetrics, make_eval_step, make_train_step
from object_detection_cib_torch.utils.device import resolve_device, to_unit


class Evaluator:
    """Runs the eval step over a ``ValDeviceCache`` for mAP or predictions."""

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
    ):
        self.device = resolve_device(device)
        net_device = next(net.parameters()).device
        if net_device.type != self.device.type:
            raise ValueError(f"net is on {net_device}, evaluator on {self.device}")
        self.classes = list(classes)
        self.batch_size = batch_size
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
            canv = cache.canvases
            pad = nb * B - n
            if pad:
                canv = np.concatenate([canv, np.zeros((pad,) + canv.shape[1:], canv.dtype)])
            S = cache.S
            ds = torch.from_numpy(canv.reshape(nb, B, S, S, 3)).to(self.device)
            self._blocks = (cache, ds)
        return self._blocks[1]

    def run_blocks(self, cache: ValDeviceCache) -> Iterator[Tuple[int, NMSResult]]:
        """Yield (block index, numpy NMSResult trimmed to the block's real rows).

        Block i's result is yielded after block i+1 has been enqueued.
        """
        ds = self.device_blocks(cache)
        n = len(cache)
        B = self.batch_size
        pending = None
        for bi in range(ds.shape[0]):
            res = self.eval_step(to_unit(ds[bi]))
            fetched = _fetch(res)
            if pending is not None:
                yield _trimmed(*pending, B, n)
            pending = (bi, fetched)
        if pending is not None:
            yield _trimmed(*pending, B, n)

    def validate(self, cache: ValDeviceCache) -> Dict[str, float]:
        """mAP over every image of the cache."""
        evaluator = MeanAveragePrecisionEvaluator(len(self.classes), class_names=self.classes)
        B = self.batch_size
        for bi, res in self.run_blocks(cache):
            sl = slice(bi * B, bi * B + res.boxes.shape[0])
            evaluator.add_batch(res, cache.gt_boxes[sl], cache.gt_labels[sl], cache.gt_mask[sl])
        return evaluator.results_dict()

    def validate_batches(self, batches: Iterable[Batch]) -> Dict[str, float]:
        """mAP over host batches (uint8 images, as ``Prefetcher(device=None)``
        yields them): each is copied up, the last padded to B with zero
        images, and scored on the host while the card runs the next."""
        evaluator = MeanAveragePrecisionEvaluator(len(self.classes), class_names=self.classes)
        B = self.batch_size
        pending = None
        for batch in batches:
            n = batch.images.shape[0]
            images = batch.images.to(self.device, non_blocking=True)
            if n < B:
                images = torch.cat([images, images.new_zeros((B - n,) + images.shape[1:])])
            fetched = _fetch(self.eval_step(to_unit(images)))
            if pending is not None:
                _score(evaluator, *pending)
            pending = (fetched, n, batch)
        if pending is not None:
            _score(evaluator, *pending)
        return evaluator.results_dict()

    def predict(self, cache: ValDeviceCache, out_path: Optional[Path] = None) -> list:
        """Per-image {"boxes", "scores", "classes"} dicts, optionally dumped as JSON."""
        results = []
        for _, res in self.run_blocks(cache):
            for i in range(res.boxes.shape[0]):
                n = int(res.num_valid[i])
                results.append(
                    {
                        "boxes": res.boxes[i][:n].tolist(),
                        "scores": res.scores[i][:n].tolist(),
                        "classes": [self.classes[int(c)] for c in res.classes[i][:n]],
                    }
                )
        if out_path is not None:
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


def _score(evaluator: MeanAveragePrecisionEvaluator, fetched, rows: int, batch: Batch) -> None:
    evaluator.add_batch(_waited(fetched, rows), batch.boxes.numpy(), batch.labels.numpy(),
                        batch.mask.numpy())


def _compute_loss_weights(info: DatasetInfo) -> np.ndarray:
    """sum(n)/n_c per class (ref tasks/trainer.py:54-60)."""
    counts = info.get_instance_count()
    total = sum(counts.values())
    return np.asarray([total / max(counts[c], 1) for c in info.classes], np.float32)


class Trainer:
    """The training loop on one card, built from plain arguments.

    The network (random weights from ``seed``); the training feed, chosen
    as the JAX trainer chooses it: ``pipeline="device"`` is the device
    pipeline (corpus on the card with ``device_cache``, else host-fed),
    ``pipeline="host"`` the host pipeline (``train_augmentor``, by default
    ``TrainSampleAugmentor(aug_params)``, what ``configs/data/default.yaml``
    selects) under a ``Prefetcher`` of ``num_workers`` threads, drawing from
    ``sampler`` or a ``ShuffleSampler``; images are fake draws with
    ``fake_mode`` (implied by a dataset name starting with "fake") or JPEG
    files under ``root_dir``. SmartSGD with ``steps_per_epoch = len(train)
    // batch_size`` and the lr schedule's horizon ``max_epochs``, the one
    source of that number; the train step; and the ``Evaluator`` over a
    ``ValDeviceCache`` of ``val_info`` with the corpus on the card, over the
    host feed otherwise. ``sampler`` is any object with ``epoch_indices()``
    (``data/samplers.py``); ``corpus`` shares one ``DeviceCorpus`` between
    trainers over the same dataset. Config composition and the CLI are
    ROADMAP item A6.
    """

    def __init__(
        self,
        train_info: DatasetInfo,
        val_info: DatasetInfo,
        size: str = "s",
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
        self.device = resolve_device(device)
        self.train_info, self.val_info = train_info, val_info
        self.classes = list(train_info.classes)
        self.batch_size = batch_size
        self.max_targets = max_targets
        self.max_epochs = int(max_epochs)
        self.image_shape = FeatureShape(image_size, image_size)
        self.anchors = default_anchors()
        # a dataset named fake* lists files that do not exist (JAX :237-241)
        self.fake_mode = fake_mode or train_info.name.startswith("fake")
        self.root_dir = root_dir
        self.enable_ram_cache = enable_ram_cache
        self.num_workers = max(int(num_workers), 1)
        self.net = build_network(len(self.classes), size, dtype=dtype, device=self.device, seed=seed)
        feed_dtype = torch.float32 if dtype is None else dtype
        self.pipeline: Optional[DeviceDataPipeline] = None
        self.prefetcher = None
        if pipeline == "device":
            self.pipeline = DeviceDataPipeline(
                train_info, image_size, batch_size, aug_params, max_targets=max_targets,
                mixup_prob=mixup_prob, use_mosaic=use_mosaic, warp_precision=warp_precision,
                sampler=sampler, seed=seed, fake_mode=self.fake_mode, device_cache=device_cache,
                feed_dtype=feed_dtype, device=self.device, corpus=corpus, root_dir=root_dir,
                enable_ram_cache=enable_ram_cache,
            )
        else:
            # cv2 and Pillow are needed only here: the host pipeline is imported when asked for
            from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher
            from object_detection_cib_torch.data.samplers import ShuffleSampler

            train_ds = DetectionDataset(
                train_info, SampleReader(image_size, self.classes, self.fake_mode, root_dir),
                train_augmentor or TrainSampleAugmentor(aug_params), enable_ram_cache=enable_ram_cache,
                use_mosaic=use_mosaic, mosaic_target_size=image_size, mixup_prob=mixup_prob,
                sampler=sampler, seed=seed)
            self.prefetcher = Prefetcher(
                train_ds, batch_size, max_targets, sampler=sampler or ShuffleSampler(train_info, seed=seed),
                num_threads=self.num_workers, device=self.device, feed_dtype=feed_dtype)
        self.steps_per_epoch = max(len(train_info.samples) // batch_size, 1)
        self.optimizer = SmartSGD(self.net, optimizer._replace(max_epochs=self.max_epochs),
                                  self.steps_per_epoch)
        class_weights = None
        if use_loss_weights:
            class_weights = torch.from_numpy(_compute_loss_weights(train_info)).to(self.device)
        self.train_step = make_train_step(self.net, self.anchors, self.image_shape,
                                          self.optimizer, loss_params, class_weights)
        # validation feed (JAX :781-786): the val set on the card beside the
        # corpus on the card, else the host feed, built at its first use
        self.val_cache: Optional[ValDeviceCache] = None
        if pipeline == "device" and device_cache:
            self.val_cache = ValDeviceCache(val_info, range(len(val_info.samples)), image_size,
                                            max_targets, fake_mode=self.fake_mode, root_dir=root_dir)
        self._val_dataset = None
        self.evaluator = Evaluator(self.net, self.anchors, val_info.classes,
                                   batch_size=batch_size, device=self.device)
        self.epoch = 0  # epochs trained so far
        self.epoch_imgs: List[int] = []
        self.epoch_walls: List[float] = []
        self.epoch_metrics: List[Dict[str, np.ndarray]] = []
        self._last_sampler_plan: Optional[np.ndarray] = None

    def val_prefetcher(self):
        """The host validation feed: every val image once, letterboxed, in
        order, the last batch short (JAX ``_val_prefetcher``)."""
        from object_detection_cib_torch.data.pipeline import DetectionDataset, Prefetcher

        if self._val_dataset is None:
            self._val_dataset = DetectionDataset(
                self.val_info, SampleReader(self.image_shape.width, self.classes, self.fake_mode,
                                            self.root_dir),
                ValidationSampleAugmentor(), enable_ram_cache=self.enable_ram_cache)
        return Prefetcher(self._val_dataset, self.batch_size, self.max_targets,
                          num_threads=self.num_workers, drop_last=False, device=None)

    def validate(self) -> Dict[str, float]:
        """mAP over the val set, through the feed the trainer chose."""
        if self.val_cache is not None:
            return self.evaluator.validate(self.val_cache)
        return self.evaluator.validate_batches(self.val_prefetcher())

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

    def fit(self, max_epochs: Optional[int] = None, limit_train_batches: Optional[int] = None,
            on_step: Optional[Callable[[int, int, StepMetrics], None]] = None) -> Dict[str, float]:
        """Train on to epoch ``max_epochs`` (by default the trainer's
        ``max_epochs``, the lr schedule's horizon, which it may not pass),
        validating after each epoch; returns the last mAP dict.

        Epochs count on from earlier calls, as the JAX trainer's loop runs
        ``range(start_epoch, max_epochs)``. ``limit_train_batches`` caps the
        steps per epoch (the JAX trainer's knob, :978, in its integer form).
        ``on_step(epoch, step, metrics)`` runs after each step is enqueued.
        Per epoch, the images and the wall time (host clock, ending in the
        host fetch of the epoch's metrics) are recorded, and the per-step
        losses, ``assign_drop`` and the targets dropped by ``max_targets``
        come back to the host in one copy: ``epoch_metrics`` holds per step
        ``total``, ``box``, ``obj``, ``cls``, ``assign_drop`` and ``lr``, and
        the epoch's ``targets_dropped``.
        """
        stop = self.max_epochs if max_epochs is None else int(max_epochs)
        if stop > self.max_epochs:
            raise ValueError(f"fit(max_epochs={stop}) would train past the lr schedule's horizon, "
                             f"Trainer(max_epochs={self.max_epochs})")
        n_steps = self.steps_per_epoch
        if limit_train_batches:
            n_steps = min(int(limit_train_batches), n_steps)
        last_val: Dict[str, float] = {}
        for epoch in range(self.epoch, stop):
            t0 = time.perf_counter()
            host_dropped = self.prefetcher.overflow_total if self.prefetcher is not None else 0
            rows, lrs = [], []
            for i, (batch, ovf) in enumerate(self._train_batches(n_steps)):
                m = self.train_step(batch)
                cols = [m.total, m.box, m.obj, m.cls, m.assign_drop.float()]
                rows.append(torch.stack(cols if ovf is None else cols + [ovf.float()]))
                lrs.append(m.lr)
                if on_step is not None:
                    on_step(epoch, i, m)
            stacked = torch.stack(rows).cpu().numpy()
            self.epoch_walls.append(time.perf_counter() - t0)
            self.epoch_imgs.append(len(rows) * self.batch_size)
            metrics = {k: stacked[:, j] for j, k in enumerate(("total", "box", "obj", "cls", "assign_drop"))}
            metrics["lr"] = np.asarray(lrs, np.float32)
            if self.pipeline is not None:
                dropped = int(stacked[:, 5].sum())
                self.pipeline.add_overflow(dropped)
            else:
                dropped = self.prefetcher.overflow_total - host_dropped
            metrics["targets_dropped"] = np.int64(dropped)
            self.epoch_metrics.append(metrics)
            self.epoch = epoch + 1
            last_val = self.validate()
            last_val["images_per_sec"] = self.epoch_imgs[-1] / self.epoch_walls[-1]
        return last_val

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


def plan_instance_counts(info: DatasetInfo, rows: np.ndarray) -> Dict[str, int]:
    """Instances per class over the corpus rows ``rows`` of an epoch plan."""
    per_image = np.zeros((len(info.samples), len(info.classes)), np.int64)
    index = {c: i for i, c in enumerate(info.classes)}
    for i, s in enumerate(info.samples):
        for t in s.targets:
            per_image[i, index[t.class_name]] += 1
    total = per_image[np.asarray(rows, np.int64).ravel()].sum(0)
    return {c: int(total[i]) for i, c in enumerate(info.classes)}
