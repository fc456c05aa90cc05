"""The program's own stage marks and spans in a traced record.

A stage mark is a one-thread kernel the program launches at a boundary of
its fused training step (``object_detection_cib_torch/ops/csrc/marks.cu``:
``mark_<stage>_kernel``, one a step). A stage's device time a step is the
time from a start mark's end to the next end mark's start, the median over
the steps whose two marks lie wholly inside the traced window. A span is a
``record_function`` interval of the program on the host
(``object_detection_cib_torch/utils/tracing.py``), kept in the record when
its name is of a family the harness reads (``infer.``). A program without
marks or spans gives None.
"""

import bisect
import statistics


def _marks(record: dict, stage: str):
    """(start, end) of the mark kernels of ``stage`` wholly inside the window, in order."""
    name, w = f"mark_{stage}_kernel", record["window_s"]
    return sorted((a, b) for n, a, b in record["kernels"] if name in n and a >= 0.0 and b <= w)


def stage_ms(record: dict, starts, end: str):
    """The median ms a step from the first of ``starts`` that the window
    holds to ``end``: for each start mark, to the first end mark that starts
    after it and before the next start mark."""
    begins = []
    for start in starts:
        begins = _marks(record, start)
        if begins:
            break
    ends = [a for a, _ in _marks(record, end)]
    gaps = []
    for k, (_, b0) in enumerate(begins):
        nxt = begins[k + 1][0] if k + 1 < len(begins) else float("inf")
        j = bisect.bisect_left(ends, b0)
        if j < len(ends) and ends[j] < nxt:
            gaps.append(ends[j] - b0)
    return 1e3 * statistics.median(gaps) if gaps else None


def span_ms(record: dict, name: str):
    """The median host ms of the spans named ``name`` wholly inside the window."""
    w = record["window_s"]
    got = [b - a for n, a, b in record.get("spans", ()) if n == name and a >= 0.0 and b <= w]
    return 1e3 * statistics.median(got) if got else None
