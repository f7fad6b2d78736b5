"""Data layer: the host time of ``next(it)`` on the port's batch iterator
(its producer thread and pinned copies), the mean over the window's
steps, in ms."""


def read(record):
    waits = record["window"]["data_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
