"""idle_share.infer (%): the share of the traced window in which no kernel or
copy ran on the card (one minus the union of their intervals). The window
is a run of the closed loop's requests after the timed one, between two
synchronize calls."""


def read(record):
    if not record or record.get("kind") != "infer" or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
