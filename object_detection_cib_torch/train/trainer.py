"""The training loop, and validation and prediction over the val corpus.

The counterpart of ``object_detection_cib_tpu/train/trainer.py`` in two
parts. ``Trainer`` runs the production training loop (the fused-epoch
mode of ``Trainer.fit``, :974): per step the device pipeline's gather and
augment (K2, K5, K4) and the train step; per epoch the validation. The
imbalance recipes are arguments: a sampler, ``mixup_prob``, ``use_mosaic``,
``warp_precision`` and, through ``aug_params``, a general affine.
``Evaluator.validate`` is the counterpart of ``Trainer._validate_device``
(train/trainer.py:832-956 of the JAX package) and ``Evaluator.predict`` of
``Trainer.predict``'s per-image dicts (:1333-1382). The uint8 canvases of a
``ValDeviceCache`` go to the card once, as one (nb, B, S, S, 3) tensor padded
with zero images; each block is sliced, scaled by 1/255 and run through the
eval step. The host converts and scores block i-1 while the card runs block
i (a one-deep pipeline: results come back by a non-blocking copy into pinned
memory, and the host waits on that copy's event only).

Not here yet: config composition and the CLI (ROADMAP A6), checkpoints,
loggers, early stopping, the sampler-statistics file (``sampler_stats``
returns the counts), the software-pipelined or
CUDA-graph epoch, and the multi-host mAP merge (A7).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.core.nms import NMSResult
from object_detection_cib_torch.core.types import FeatureShape, LevelAnchors, default_anchors
from object_detection_cib_torch.data.cache import DatasetInfo
from object_detection_cib_torch.data.device_pipeline import DeviceCorpus, DeviceDataPipeline
from object_detection_cib_torch.data.host_augment import AugParams
from object_detection_cib_torch.data.val_cache import ValDeviceCache
from object_detection_cib_torch.eval.coco_map import MeanAveragePrecisionEvaluator
from object_detection_cib_torch.models.yolov5 import build_network
from object_detection_cib_torch.train.loss import LossParams
from object_detection_cib_torch.train.optim import OptimizerConfig, SmartSGD
from object_detection_cib_torch.train.steps import StepMetrics, make_eval_step, make_train_step
from object_detection_cib_torch.utils.device import resolve_device


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
            res = self.eval_step(ds[bi].to(torch.float32) / 255.0)
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


def _trimmed(bi: int, fetched, B: int, n: int) -> Tuple[int, NMSResult]:
    host, event = fetched
    if event is not None:
        event.synchronize()
    rows = min(n - bi * B, B)
    return bi, NMSResult(*(t.numpy()[:rows] for t in host))


def _compute_loss_weights(info: DatasetInfo) -> np.ndarray:
    """sum(n)/n_c per class (ref tasks/trainer.py:54-60)."""
    counts = info.get_instance_count()
    total = sum(counts.values())
    return np.asarray([total / max(counts[c], 1) for c in info.classes], np.float32)


class Trainer:
    """The production training loop on one card, built from plain arguments.

    The network (random weights from ``seed``), the device pipeline over
    ``train_info`` (corpus on the card, fake mode, planar), SmartSGD with
    ``steps_per_epoch = len(train) // batch_size``, the train step, and the
    ``Evaluator`` over a ``ValDeviceCache`` of ``val_info``. ``sampler`` is
    any object with ``epoch_indices()`` (``data/samplers.py``); ``corpus``
    shares one ``DeviceCorpus`` between trainers over the same dataset.
    Config composition and the CLI are ROADMAP item A6.
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
    ):
        self.device = resolve_device(device)
        self.train_info = train_info
        self.classes = list(train_info.classes)
        self.batch_size = batch_size
        self.image_shape = FeatureShape(image_size, image_size)
        self.anchors = default_anchors()
        self.net = build_network(len(self.classes), size, dtype=dtype, device=self.device, seed=seed)
        self.pipeline = DeviceDataPipeline(
            train_info, image_size, batch_size, aug_params, max_targets=max_targets,
            mixup_prob=mixup_prob, use_mosaic=use_mosaic, warp_precision=warp_precision,
            sampler=sampler, seed=seed, feed_dtype=torch.float32 if dtype is None else dtype,
            device=self.device, corpus=corpus,
        )
        self.steps_per_epoch = max(len(train_info.samples) // batch_size, 1)
        self.optimizer = SmartSGD(self.net, optimizer, self.steps_per_epoch)
        class_weights = None
        if use_loss_weights:
            class_weights = torch.from_numpy(_compute_loss_weights(train_info)).to(self.device)
        self.train_step = make_train_step(self.net, self.anchors, self.image_shape,
                                          self.optimizer, loss_params, class_weights)
        self.val_cache = ValDeviceCache(val_info, range(len(val_info.samples)), image_size,
                                        max_targets, fake_mode=True)
        self.evaluator = Evaluator(self.net, self.anchors, val_info.classes,
                                   batch_size=batch_size, device=self.device)
        self.epoch_imgs: List[int] = []
        self.epoch_walls: List[float] = []
        self.epoch_metrics: List[Dict[str, np.ndarray]] = []
        self._last_sampler_plan: Optional[np.ndarray] = None

    def fit(self, max_epochs: int, limit_train_batches: Optional[int] = None,
            on_step: Optional[Callable[[int, int, StepMetrics], None]] = None) -> Dict[str, float]:
        """Train ``max_epochs`` epochs, validating after each; returns the last mAP dict.

        ``limit_train_batches`` caps the steps per epoch (the JAX trainer's
        knob, :978, in its integer form).
        ``on_step(epoch, step, metrics)`` runs after each step is enqueued.
        Per epoch, the images and the wall time (host clock, ending in the
        host fetch of the epoch's metrics) are recorded, and the per-step
        losses come back to the host in one copy.
        """
        n_steps = self.steps_per_epoch
        if limit_train_batches:
            n_steps = min(int(limit_train_batches), n_steps)
        last_val: Dict[str, float] = {}
        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            rows = []
            for i, (batch, _) in enumerate(self.pipeline.epoch(n_steps)):
                m = self.train_step(batch)
                rows.append(torch.stack([m.total, m.box, m.obj, m.cls, m.assign_drop.float()]))
                if on_step is not None:
                    on_step(epoch, i, m)
            stacked = torch.stack(rows).cpu().numpy()
            self.epoch_walls.append(time.perf_counter() - t0)
            self.epoch_imgs.append(len(rows) * self.batch_size)
            self.epoch_metrics.append({k: stacked[:, j] for j, k in
                                       enumerate(("total", "box", "obj", "cls", "assign_drop"))})
            last_val = self.evaluator.validate(self.val_cache)
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
        log = self.pipeline.consumed_plan_log
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
