"""Faults planted under the timed path, to show that ``correct`` catches
them: each is a hook that a cell's ``run`` applies to the program object it
built (the trainer or the evaluator) before its first step."""

from __future__ import annotations

import contextlib

import torch

LOOSE_IOU = 0.3  # the IoU at which the over-suppressing fault's K1 suppresses


def unchanged_state(trainer) -> None:
    """Every step computes its losses and returns the state unchanged."""
    trainer.optimizer.step = lambda hp=None: hp[1]


def half_batch(trainer) -> None:
    """Every step trains on the first half of its batch, the mean over it."""
    step = trainer.train_step

    def half(batch, hp=None):
        return step(type(batch)(*(t[: t.shape[0] // 2] for t in batch)), hp)

    trainer.train_step = half


def altered_answer(evaluator) -> None:
    """The first detection of each request's first image changes class."""
    step = evaluator.eval_step

    def altered(images):
        res = step(images)
        classes = res.classes.clone()
        nc = len(evaluator.classes)
        classes[0, 0] = torch.where(res.valid[0, 0], (classes[0, 0] + 1) % nc, classes[0, 0])
        return res._replace(classes=classes)

    evaluator.eval_step = altered


def half_answers(evaluator) -> None:
    """Each request answers the first half of its images; the rest come
    back empty."""
    step = evaluator.eval_step

    def half(images):
        res = step(images)
        keep = torch.arange(images.shape[0], device=images.device) < images.shape[0] // 2
        valid = res.valid & keep[:, None]
        return res._replace(boxes=res.boxes * valid[..., None], scores=res.scores * valid,
                            classes=torch.where(valid, res.classes, torch.full_like(res.classes, -1)),
                            valid=valid, num_valid=valid.sum(1).to(res.num_valid.dtype))

    evaluator.eval_step = half


@contextlib.contextmanager
def _swapped(module, name: str, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def _inside_eval(evaluator, name: str, make) -> None:
    """Each eval step calls ``make(original)`` in place of the program's
    ``core/nms.py`` function ``name``."""
    from object_detection_cib_torch.core import nms as core_nms

    step, original = evaluator.eval_step, getattr(core_nms, name)

    def faulty(images):
        with _swapped(core_nms, name, make(original)):
            return step(images)

    evaluator.eval_step = faulty


def loose_suppression(evaluator) -> None:
    """K1 suppresses at IoU ``LOOSE_IOU``, not the configured one."""
    _inside_eval(evaluator, "greedy_nms_mask", lambda mask: lambda boxes, live, iou: mask(boxes, live, LOOSE_IOU))


def class_blind_suppression(evaluator) -> None:
    """K1 suppresses across classes: it gets the boxes without their class
    offsets."""
    def make(select):
        def blind(*a, **k):
            c = select(*a, **k)
            return c._replace(offset_boxes=c.boxes.contiguous())
        return blind

    _inside_eval(evaluator, "select_candidates", make)


def wrong_candidates(evaluator) -> None:
    """Candidate selection keeps the next ``max_nms`` candidates by score,
    not the top ones."""
    def make(select):
        def next_ones(detections, conf_thres, classes, max_nms, multi_label):
            c = select(detections, conf_thres, classes, 2 * max_nms, multi_label)
            return type(c)(*(t[:, max_nms:2 * max_nms].contiguous() for t in c))
        return next_ones

    _inside_eval(evaluator, "select_candidates", make)


def no_exchange(trainer) -> None:
    """Every step leaves out the exchange of gradients between the ranks:
    each rank updates with the gradient of its own rows alone."""
    from object_detection_cib_torch.train import steps

    step = trainer.train_step

    def alone(batch, hp=None):
        with _swapped(steps, "_all_reduce_gradients", lambda params, group: None):
            return step(batch, hp)

    trainer.train_step = alone


def local_batchnorm(trainer) -> None:
    """Every step leaves out the exchange of BatchNorm's statistics between
    the ranks: each rank normalises over its own rows alone."""
    from object_detection_cib_torch.models import layers

    step, synced = trainer.train_step, layers._GlobalBatchNorm

    class Local:
        @staticmethod
        def apply(x, weight, bias, group, ranks, eps, stats=None):
            return synced.apply(x, weight, bias, None, 1, eps, stats)

    def alone(batch, hp=None):
        with _swapped(layers, "_GlobalBatchNorm", Local):
            return step(batch, hp)

    trainer.train_step = alone


TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
MESH = {"no_exchange": no_exchange, "local_batchnorm": local_batchnorm}  # a training cell's faults over several cards
INFER = {"altered_answer": altered_answer, "half_answers": half_answers, "loose_suppression": loose_suppression,
         "class_blind_suppression": class_blind_suppression, "wrong_candidates": wrong_candidates}
