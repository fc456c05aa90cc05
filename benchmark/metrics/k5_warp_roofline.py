"""k5_warp_roofline (%): K5 (csrc/warp.cu) reading the source bytes its
non-zero taps reach (the mean over the traced epoch's steps, worked out
from their draws) and writing (B, 3, S, S) bf16 a launch, at HBM speed,
over its device time in the traced window."""

from counts.bytes import warp_quadrants
from counts.roofline import share


def read(record):
    if not record or record.get("kind") != "train" or not record.get("k5_reached"):
        return None
    reached = sum(record["k5_reached"]) / len(record["k5_reached"])
    return share(record, warp_quadrants(reached, record["batch"], record["image_size"]), "warp_quadrants_kernel")
