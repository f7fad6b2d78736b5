"""Device: the share of the traced window in which no kernel, copy or
memset ran on the card, in %."""


def read(record):
    summary = record["trace"]
    if summary is None or not summary.window_s:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
