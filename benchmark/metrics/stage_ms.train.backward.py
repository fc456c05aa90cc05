"""stage_ms.train.backward (ms): the device time a step of the backward: from
the end of the program's mark_loss_end_kernel to the start of the next
mark_backward_end_kernel, the median over the whole steps of the traced
window (counts/stages.py). None for a program without the marks."""

from counts.stages import stage_ms


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return stage_ms(record, ("loss_end",), "backward_end")
