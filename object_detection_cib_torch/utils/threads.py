"""Helpers for the producer threads of the data feeds."""

from __future__ import annotations

import queue
import threading


def put_unless_stopped(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` on the bounded queue ``q`` unless the consumer has gone
    (``stop`` set). Returns False if it has, so a producer never blocks for
    ever on a queue nobody reads."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False
