"""The numbers that decide ``correct``, each held to a limit of its cell.

Training (the program's first steps against the reference's):
  * ``loss_gap``: the widest relative gap between the program's and the
    reference's total loss over the judged steps;
  * ``grad_gap``: over the leaves, the widest gap between the norms of
    the first gradient as SmartSGD takes it (its momentum after step 1),
    relative to the reference's norm of that leaf or of the median leaf,
    whichever is larger;
  * ``update_gap``: the same for each leaf's change over the judged steps;
  * ``first_loss_gap``: the relative gap of the first step's total loss, a
    number steady from seed to seed where the later steps' losses are not
    (a cell compares it where its limits name it).
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding) are left out of both.

Inference (the detections the program fetched, on a sample of requests):
  * ``det_gap``: each detection against the reference's decoded anchor
    that explains it best: the larger of the relative box distance and the
    relative gap of that anchor's score for the detection's class, at the
    anchor where it is least; the widest over the detections;
  * ``set_miss``: each image's kept set against the reference NMS's: the
    share of the program's detections with no reference detection of the
    same class at IoU ``MATCH_IOU`` or more, or the share of the
    reference's with none among the program's, whichever is larger; the
    widest over the images. It is what holds candidate selection and K1 to
    the reference: a selection that keeps the wrong candidates, or NMS that
    suppresses too much or across classes, keeps another set;
  * ``overlap``: the largest IoU between two detections of one class in an
    image, which greedy NMS at the configuration's IoU keeps at or under it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

NOUGHT = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's is left out
NO_SUCH_CLASS = 1e9  # the score gap of a detection whose class the configuration does not have
MATCH_IOU = 0.9  # a detection matches one of the same class at this IoU or more (kept boxes overlap at most 0.6)


def _leaves(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], grad_ref: Dict[str, torch.Tensor]):
    """Per leaf |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) over the counted
    leaves: -> (names, gaps, counted mask, the median ‖ref‖)."""
    names = sorted(ref)
    g = torch.stack([grad_ref[n].double().norm() for n in names])
    keep = g >= NOUGHT * float(g.median())
    r = torch.stack([ref[n].double().norm() for n in names])
    p = torch.stack([prog[n].double().to(ref[n].device).norm() for n in names])
    floor = float(r[keep].median())
    return names, torch.where(keep, (p - r).abs() / torch.clamp(r, min=floor), torch.zeros_like(r)), keep, floor


def leaf_gap(prog, ref, grad_ref) -> float:
    """The widest counted leaf's gap."""
    return float(_leaves(prog, ref, grad_ref)[1].max())


def worst_leaves(prog, ref, grad_ref, k: int = 5) -> List[list]:
    """The ``k`` counted leaves with the widest gaps, [name, gap], and the
    median leaf's norm last: what a look at a cell's readings starts from."""
    names, gap, _, floor = _leaves(prog, ref, grad_ref)
    return [[names[i], float(gap[i])] for i in gap.argsort(descending=True)[:k].tolist()] + [["median", floor]]


def train_numbers(loss_p: Sequence[float], loss_r: Sequence[float], first_p, first_r, delta_p, delta_r) -> Dict[str, float]:
    if len(loss_p) != len(loss_r):
        raise ValueError(f"{len(loss_p)} program losses against {len(loss_r)} reference losses")
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(loss_p, loss_r)),
            "grad_gap": leaf_gap(first_p, first_r, first_r), "update_gap": leaf_gap(delta_p, delta_r, first_r),
            "first_loss_gap": abs(loss_p[0] - loss_r[0]) / abs(loss_r[0])}


def _pair_iou(b: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = b.unbind(-1)
    iw = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    ih = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = iw * ih
    area = (x2 - x1) * (y2 - y1)
    return inter / (area[:, None] + area[None] - inter + 1e-7)


def _set_miss(b: torch.Tensor, c: torch.Tensor, rb: torch.Tensor, rc: torch.Tensor) -> float:
    """The larger share of either kept set with no match in the other."""
    if b.shape[0] == 0 or rb.shape[0] == 0:
        return float(b.shape[0] != rb.shape[0])
    iw = (torch.minimum(b[:, None, 2], rb[None, :, 2]) - torch.maximum(b[:, None, 0], rb[None, :, 0])).clamp(min=0)
    ih = (torch.minimum(b[:, None, 3], rb[None, :, 3]) - torch.maximum(b[:, None, 1], rb[None, :, 1])).clamp(min=0)
    inter = iw * ih
    area = lambda x: (x[:, 2] - x[:, 0]) * (x[:, 3] - x[:, 1])  # noqa: E731
    iou = inter / (area(b)[:, None] + area(rb)[None] - inter + 1e-7)
    match = (iou >= MATCH_IOU) & (c[:, None] == rc[None])
    return max(float((~match.any(1)).float().mean()), float((~match.any(0)).float().mean()))


def detection_numbers(prog, decoded, ref) -> Dict[str, float]:
    """``prog``: the program's (boxes (B, D, 4), scores (B, D), classes (B,
    D), num (B,)) as tensors; ``decoded``: the reference's (boxes (B, N,
    4), obj (B, N), cls (B, N, nc)) on one device; ``ref``: the reference
    NMS's kept detections (boxes, scores, classes, num) on that device."""
    boxes, scores, classes, num = prog
    dev = decoded.boxes.device
    det_gap, overlap, set_miss = 0.0, 0.0, 0.0
    for i in range(boxes.shape[0]):
        n, nr = int(num[i]), int(ref.num[i])
        b = boxes[i, :n].to(dev).float()
        c = classes[i, :n].to(dev).long()
        set_miss = max(set_miss, _set_miss(b, c, ref.boxes[i, :nr].float(), ref.classes[i, :nr].long()))
        if n == 0:
            continue
        s = scores[i, :n].to(dev).float()
        R = decoded.boxes[i]
        size = torch.clamp(torch.maximum(R[:, 2] - R[:, 0], R[:, 3] - R[:, 1]), min=1.0)
        nc = decoded.cls.shape[-1]
        best = []
        for k in range(0, n, 64):
            ck = c[k:k + 64].clamp(0, nc - 1)
            box = (b[k:k + 64, None, :] - R[None]).abs().amax(-1) / size[None]  # (chunk, N)
            ref_s = (decoded.obj[i][:, None] * decoded.cls[i][:, ck]).T  # (chunk, N): each anchor's score of the class
            gap = torch.maximum(box, (s[k:k + 64, None] - ref_s).abs() / ref_s)
            best.append(gap.min(1).values)
        worst = torch.cat(best)
        worst = torch.where((c < 0) | (c >= nc), torch.full_like(worst, NO_SUCH_CLASS), worst)
        det_gap = max(det_gap, float(worst.max()))
        iou = _pair_iou(b)
        same = (c[:, None] == c[None]) & ~torch.eye(n, dtype=torch.bool, device=dev)
        if bool(same.any()):
            overlap = max(overlap, float(iou[same].max()))
    return {"det_gap": det_gap, "set_miss": set_miss, "overlap": overlap}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing or non-finite one fails)."""
    return all(k in numbers and numbers[k] == numbers[k] and numbers[k] <= v for k, v in limits.items())
