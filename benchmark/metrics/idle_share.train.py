"""idle_share.train (%): the share of the traced window in which no kernel or
copy ran on the card (one minus the union of their intervals). The window
is one epoch of host time inside the timed fit, from the first epoch's
fetch to the second's: the card runs whole steps and one epoch boundary,
and neither the fit's start nor its end."""


def read(record):
    if not record or record.get("kind") != "train" or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
