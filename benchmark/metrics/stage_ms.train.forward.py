"""stage_ms.train.forward (ms): the device time a step of the training forward
(the network in train mode): from the end of the program's
mark_forward_begin_kernel to the start of the next mark_forward_end_kernel,
the median over the whole steps of the traced window (counts/stages.py).
None for a program without the marks."""

from counts.stages import stage_ms


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return stage_ms(record, ("forward_begin",), "forward_end")
