"""bn_silu_roofline (%): the training step's BatchNorm + SiLU (ops/csrc/
bn_silu.cu) moving 10 B of each BatchNorm output element of the reference
network (its family's bn_elements, counts/bn_silu.py; bf16: x read and y
written forward, x and dy read and dx written backward) at HBM speed, over
the device time of every kernel named bn_silu_* in the traced window; a
launch is one bn_silu_apply kernel, one a layer a step. None for a program
without them."""

from counts.bn_silu import BYTES_PER_ELEMENT
from counts.roofline import launches, share
from harness.registry import family, workload

APPLY = "bn_silu_apply"


def read(record):
    if not record or record.get("kind") != "train" or launches(record, APPLY) == 0:
        return None
    cfg = workload(record["cell"])["model"]
    elements, layers = family(cfg).bn_elements(cfg, record["image_size"])
    return share(record, BYTES_PER_ELEMENT * elements * record["batch"] / layers, APPLY, "bn_silu_")
