"""stage_ms.train.allreduce (ms): the device time a step of the gradient's
exchange between the ranks of a step over several cards (one all-reduce of
every gradient as one bucket, train/steps.py): from the end of the
program's mark_backward_end_kernel to the start of the next
mark_allreduce_end_kernel, the median over the whole steps of the traced
window on rank 0's card (counts/stages.py). None on one card, where the
program issues no exchange and no such mark."""

from counts.stages import stage_ms


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return stage_ms(record, ("backward_end",), "allreduce_end")
