"""train_mfu (%): the training step's model FLOPs (three times the
reference network's conv FLOPs an image, times the batch) over its period
on the card, over the card's dense bf16 peak. The period is the time from
the first to the last launch of the step's marker kernel in the traced
window (one a step), over the steps between them: the steady pace of whole
steps, which the profiler's own start and stop do not stretch."""

from counts.peaks import BF16_FLOPS


def read(record):
    if not record or record.get("kind") != "train":
        return None
    starts = sorted(a for n, a, b in record["kernels"] if record["step_kernel"] in n and a >= 0.0)
    if len(starts) < 2 or starts[-1] <= starts[0]:
        return None
    period = (starts[-1] - starts[0]) / (len(starts) - 1)
    return 100.0 * record["step_flops"] / period / (BF16_FLOPS * record["chips"])
