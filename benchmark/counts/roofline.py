"""A kernel's share of its roofline in a traced record: its launches and
device time, found by its ``__global__`` name in
``object_detection_cib_torch/ops/csrc``, over the kernels wholly inside the
traced window, against the least time their bytes take at the card's HBM
bandwidth."""

from counts.peaks import HBM_BYTES


def _inside(record: dict, *names: str):
    w = record["window_s"]
    return [(a, b) for n, a, b in record["kernels"] if a >= 0.0 and b <= w and any(k in n for k in names)]


def launches(record: dict, name: str) -> int:
    """The kernels named ``name`` wholly inside the window."""
    return len(_inside(record, name))


def device_seconds(record: dict, *names: str) -> float:
    return sum(b - a for a, b in _inside(record, *names))


def share(record: dict, bytes_per_launch: float, counted: str, *names: str):
    """100 x (the least time the launches' bytes take at HBM speed) / (the
    kernels' device time); a launch is one kernel named ``counted``, its
    time that of every kernel named in ``names`` (``counted`` if none).
    None where the window holds none of them."""
    n = launches(record, counted)
    t = device_seconds(record, *(names or (counted,)))
    if n == 0 or t <= 0 or bytes_per_launch <= 0:
        return None
    return 100.0 * n * bytes_per_launch / HBM_BYTES / t
