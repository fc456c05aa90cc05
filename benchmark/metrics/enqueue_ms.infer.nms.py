"""enqueue_ms.infer.nms (ms): the host's time in the eval step's infer.nms span
(non_max_suppression: candidate selection, K1 and the compaction), a span of
the program's own nested in the harness's infer.enqueue: the median over the
spans wholly inside the traced window (counts/stages.py). The window runs
under the profiler, which records every ATen operator, so this reads above
the same call untraced (PERF.md gives the profiler's inflation of
infer.enqueue). None for a program without the span."""

from counts.stages import span_ms


def read(record):
    if not record or record.get("kind") != "infer":
        return None
    return span_ms(record, "infer.nms")
