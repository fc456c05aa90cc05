"""k4_hsv_roofline (%): K4 (csrc/hsv.cu) reading and writing (B, 3, S, S)
bf16 images a launch at HBM speed, over its device time in the traced
window."""

from counts.bytes import hsv_planar
from counts.roofline import share


def read(record):
    if not record or record.get("kind") != "train":
        return None
    return share(record, hsv_planar(record["batch"], record["image_size"]), "hsv_planar_kernel")
