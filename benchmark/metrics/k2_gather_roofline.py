"""k2_gather_roofline (%): K2 (csrc/gather.cu) moving 4B corpus rows of
3 S^2 bytes a launch, in and out, at HBM speed, over its device time in the
traced window."""

from counts.bytes import gather_rows
from counts.roofline import share


def read(record):
    if not record or record.get("kind") != "train":
        return None
    S = record["image_size"]
    return share(record, gather_rows(4 * record["batch"], 3 * S * S), "gather_rows_kernel")
