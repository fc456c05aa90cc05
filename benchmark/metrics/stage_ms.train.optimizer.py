"""stage_ms.train.optimizer (ms): the device time a step of SmartSGD's update
and the step's metric column: from the end of the program's
mark_allreduce_end_kernel (on a mesh; else mark_backward_end_kernel) to the
start of the next mark_optimizer_end_kernel, the median over the whole steps
of the traced window (counts/stages.py). None for a program without the
marks."""

from counts.stages import stage_ms


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return stage_ms(record, ("allreduce_end", "backward_end"), "optimizer_end")
