"""Validation and prediction over the device-resident val corpus.

The serving/validation slice of ``object_detection_cib_tpu/train/trainer.py``:
``Evaluator.validate`` is the counterpart of ``Trainer._validate_device``
(train/trainer.py:832-956 of the JAX package) and ``Evaluator.predict`` of
``Trainer.predict``'s per-image dicts (:1333-1382). The uint8 canvases of a
``ValDeviceCache`` go to the card once, as one (nb, B, S, S, 3) tensor padded
with zero images; each block is sliced, scaled by 1/255 and run through the
eval step. The host converts and scores block i-1 while the card runs block
i (a one-deep pipeline: results come back by a non-blocking copy into pinned
memory, and the host waits on that copy's event only).

Not here yet: config composition, the CLI, checkpoints, loggers, ``fit``,
and the multi-host mAP merge; they come with later slices.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from object_detection_cib_torch.core.nms import NMSResult
from object_detection_cib_torch.core.types import LevelAnchors
from object_detection_cib_torch.data.val_cache import ValDeviceCache
from object_detection_cib_torch.eval.coco_map import MeanAveragePrecisionEvaluator
from object_detection_cib_torch.train.steps import make_eval_step
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
