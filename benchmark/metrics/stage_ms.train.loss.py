"""stage_ms.train.loss (ms): the device time a step of the assignment, the
compaction and the loss: from the end of the program's
mark_forward_end_kernel to the start of the next mark_loss_end_kernel, the
median over the whole steps of the traced window (counts/stages.py). None
for a program without the marks."""

from counts.stages import stage_ms


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return stage_ms(record, ("forward_end",), "loss_end")
