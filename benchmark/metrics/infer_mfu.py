"""infer_mfu (%): the eval step's model FLOPs a second (the reference
network's conv FLOPs an image, times the window's infer_img_s) over the
card's dense bf16 peak."""

from counts.peaks import BF16_FLOPS


def read(record):
    if not record or record.get("kind") != "infer":
        return None
    return 100.0 * record["image_flops"] * record["rate_img_s"] / (BF16_FLOPS * record["chips"])
