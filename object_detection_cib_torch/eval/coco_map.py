"""COCO-style mean-average-precision evaluator (numpy, pycocotools-free).

A copy of ``object_detection_cib_tpu/eval/coco_map.py``. ``add_batch`` takes
the port's ``NMSResult`` after ``.cpu().numpy()`` of each field.
``sync_across_processes`` merges the ranks' records of a validation sharded
by rank in the order one process would have added them (by each rank's
global image ids), so the merged ``results_dict`` is the one-process dict
exactly; the JAX function appends them rank by rank, which may break ties
between equal scores differently.

Capability parity: kod/lightning/callbacks/pycoco_map_eval.py:45-144, which
wraps vision_evaluation's CocoMeanAveragePrecisionEvaluator with
ious=[0.3, 0.5, 0.75, 0.9] and per-class AP at 0.5. The headline ``mAP`` of
the reference README is the **average over those four IoU thresholds**, not
COCO's 0.5:0.95 (BASELINE.md).

Implementation follows pycocotools COCOeval semantics:
  * greedy matching of score-sorted detections to the best remaining GT with
    IoU >= threshold
  * precision envelope (running max from the right)
  * 101-point recall interpolation [0:0.01:1]
  * maxDets=100, all areas, no crowd handling (the reference datasets carry
    no iscrowd flags)
"""

from __future__ import annotations

import pickle
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from object_detection_cib_torch.parallel.distributed import allgather_bytes

RECALL_THRS = np.linspace(0.0, 1.0, 101)


def _pairwise_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class _ImageEval(NamedTuple):
    scores: np.ndarray  # (D,) detection scores, per class per image
    matched: np.ndarray  # (T, D) bool — matched at iou_thr[t]
    num_gt: int


class MeanAveragePrecisionEvaluator:
    """Streaming evaluator: add_batch per validation step, report at end."""

    def __init__(
        self,
        num_classes: int,
        ious: Sequence[float] = (0.3, 0.5, 0.75, 0.9),
        max_dets: int = 100,
        class_names: Optional[Sequence[str]] = None,
    ):
        self.num_classes = num_classes
        self.ious = np.asarray(ious, np.float64)
        self.max_dets = max_dets
        self.class_names = class_names
        self.reset()

    def reset(self):
        # per class: list of _ImageEval, and the ordinal of each one's image
        # among the images added (for the ordered merge across ranks)
        self._evals: List[List[_ImageEval]] = [[] for _ in range(self.num_classes)]
        self._image_of: List[List[int]] = [[] for _ in range(self.num_classes)]
        self.n_images = 0  # images added

    def add_image(
        self,
        pred_boxes: np.ndarray,
        pred_scores: np.ndarray,
        pred_classes: np.ndarray,
        gt_boxes: np.ndarray,
        gt_classes: np.ndarray,
    ):
        """Add one image's detections + ground truths (xyxy pixel boxes)."""
        T = len(self.ious)
        image = self.n_images
        self.n_images += 1
        for c in range(self.num_classes):
            before = len(self._evals[c])
            self._add_class(c, T, pred_boxes, pred_scores, pred_classes, gt_boxes, gt_classes)
            self._image_of[c].extend([image] * (len(self._evals[c]) - before))

    def _add_class(self, c: int, T: int, pred_boxes, pred_scores, pred_classes, gt_boxes, gt_classes):
        """One class of one image: its record, if the image has a detection or a target of it."""
        dmask = pred_classes == c
        gmask = gt_classes == c
        n_gt = int(gmask.sum())
        if not dmask.any():
            if n_gt:
                self._evals[c].append(
                    _ImageEval(np.zeros((0,)), np.zeros((T, 0), bool), n_gt)
                )
            return
        d_boxes = pred_boxes[dmask]
        d_scores = pred_scores[dmask]
        order = np.argsort(-d_scores, kind="mergesort")[: self.max_dets]
        d_boxes, d_scores = d_boxes[order], d_scores[order]
        g_boxes = gt_boxes[gmask]

        D = len(d_scores)
        matched = np.zeros((T, D), bool)
        if n_gt:
            iou = _pairwise_iou(d_boxes, g_boxes)  # (D, G)
            for t, thr in enumerate(self.ious):
                taken = np.zeros(n_gt, bool)
                for di in range(D):
                    # best remaining gt (pycocotools greedy match)
                    best, best_iou = -1, thr
                    for gi in range(n_gt):
                        if taken[gi]:
                            continue
                        if iou[di, gi] >= best_iou:
                            best, best_iou = gi, iou[di, gi]
                    if best >= 0:
                        taken[best] = True
                        matched[t, di] = True
        self._evals[c].append(_ImageEval(d_scores, matched, n_gt))

    def add_batch(self, nms_result, gt_boxes, gt_classes, gt_mask):
        """Convenience: consume device NMSResult + padded GT arrays."""
        boxes = np.asarray(nms_result.boxes)
        scores = np.asarray(nms_result.scores)
        classes = np.asarray(nms_result.classes)
        valid = np.asarray(nms_result.valid)
        gt_boxes = np.asarray(gt_boxes)
        gt_classes = np.asarray(gt_classes)
        gt_mask = np.asarray(gt_mask)
        for i in range(boxes.shape[0]):
            v = valid[i]
            g = gt_mask[i]
            self.add_image(
                boxes[i][v], scores[i][v], classes[i][v],
                gt_boxes[i][g], gt_classes[i][g],
            )

    def sync_across_processes(self, image_ids: Sequence[int], mesh=None) -> None:
        """Merge every rank's records into this evaluator (a rank-sharded
        validation; no-op without a process group).

        ``image_ids`` are the global ids of the images this rank added, in
        the order added (its ``shard_indices``); the merged records are
        ordered by image id, as one process adding every image in id order
        would hold them. The pickles exchanged are the ranks' own."""
        if mesh is None or mesh.group is None:
            return
        if len(image_ids) != self.n_images:
            raise ValueError(f"{len(image_ids)} image ids for {self.n_images} images added")
        ids = [[int(image_ids[k]) for k in ks] for ks in self._image_of]
        parts = [pickle.loads(b) for b in allgather_bytes(pickle.dumps((self._evals, ids)), mesh)]
        for c in range(self.num_classes):
            merged = sorted(((i, e) for evals, ids_r in parts for i, e in zip(ids_r[c], evals[c])),
                            key=lambda t: t[0])
            self._evals[c] = [e for _, e in merged]
            self._image_of[c] = []

    def _ap_for_class(self, c: int) -> np.ndarray:
        """AP per IoU threshold for one class; NaN when the class has no GT."""
        evals = self._evals[c]
        T = len(self.ious)
        total_gt = sum(e.num_gt for e in evals)
        if total_gt == 0:
            return np.full((T,), np.nan)
        scores = np.concatenate([e.scores for e in evals]) if evals else np.zeros(0)
        if len(scores) == 0:
            return np.zeros((T,))
        order = np.argsort(-scores, kind="mergesort")
        aps = np.zeros((T,))
        for t in range(T):
            m = np.concatenate([e.matched[t] for e in evals])[order]
            tp = np.cumsum(m)
            fp = np.cumsum(~m)
            recall = tp / total_gt
            precision = tp / np.maximum(tp + fp, 1e-12)
            # precision envelope
            precision = np.maximum.accumulate(precision[::-1])[::-1]
            # 101-point interpolation
            idx = np.searchsorted(recall, RECALL_THRS, side="left")
            p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
            aps[t] = p.mean()
        return aps

    def get_report(self) -> Dict:
        """Parity with the reference's report keys (pycoco_map_eval.py:108-127):
        avg_mAP, mAP_{30,50,75,90}, tag_wise_AP_50."""
        per_class = np.stack(
            [self._ap_for_class(c) for c in range(self.num_classes)]
        )  # (C, T)
        mean_per_iou = np.nanmean(per_class, axis=0)  # (T,)
        report = {"avg_mAP": float(np.nanmean(mean_per_iou))}
        for t, thr in enumerate(self.ious):
            report[f"mAP_{int(round(thr * 100))}"] = float(mean_per_iou[t])
        if 0.5 in self.ious.tolist():
            t50 = self.ious.tolist().index(0.5)
            report["tag_wise_AP_50"] = {
                c: float(per_class[c, t50]) for c in range(self.num_classes)
            }
        return report

    def results_dict(self) -> Dict[str, float]:
        """Flat metrics dict (keys match ref logging: map, map30/50/75/90,
        map50_{class})."""
        rep = self.get_report()
        out = {"map": rep["avg_mAP"]}
        for thr in self.ious:
            k = int(round(thr * 100))
            out[f"map{k}"] = rep[f"mAP_{k}"]
        if "tag_wise_AP_50" in rep and self.class_names:
            for c, v in rep["tag_wise_AP_50"].items():
                out[f"map50_{self.class_names[c]}"] = v
        return out
