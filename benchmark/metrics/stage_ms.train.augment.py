"""stage_ms.train.augment (ms): the device time a step of the augment stage:
the draws, K2's gather, K5's warp, K4's HSV, the flip and the targets, made
on the forked stream beside the train step: from the end of the program's
mark_augment_begin_kernel to the start of the next mark_augment_end_kernel,
the median over the whole steps of the traced window (counts/stages.py).
None for a program without the marks."""

from counts.stages import stage_ms


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return stage_ms(record, ("augment_begin",), "augment_end")
