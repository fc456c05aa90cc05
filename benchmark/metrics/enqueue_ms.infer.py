"""enqueue_ms.infer (ms): the host's time in the call into the program's
eval step (the harness span infer.enqueue), the median over the untraced
window's requests."""


def read(record):
    if not record or record.get("kind") != "infer":
        return None
    return record["enqueue_ms"]
