"""k1_nms_roofline (%): K1 (csrc/nms.cu, a launch is its pair and its scan
kernel) reading (B, K) boxes and live flags and writing the keep mask, at
HBM speed, over their device time in the traced window."""

from counts.bytes import greedy_nms
from counts.roofline import share


def read(record):
    if not record or record.get("kind") != "infer":
        return None
    return share(record, greedy_nms(record["batch"], record["nms_k"]), "pair_kernel", "pair_kernel", "scan_kernel")
