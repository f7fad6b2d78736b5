"""Data: the host time of the program's ``data.queue_get`` span (the
consumer's wait on the producer thread's queue), the mean over the
window's steps, in ms, read from the port's span tracer in this process
(``repro_torch.obs.tracer()``, its ring buffer); the note gives the mean
of the ``data.pin_copy`` span (pinning and the copy to the card)."""
import sys


def read(record):
    obs_trace = sys.modules.get("repro_torch.obs.trace")
    steps = record["window"]["steps"]
    if obs_trace is None or not steps:
        return None
    events = obs_trace.tracer().events()
    ms = lambda name: [1e-3 * e["dur"] for e in events
                       if e["name"] == name][-steps:]
    wait, pin = ms("data.queue_get"), ms("data.pin_copy")
    if len(wait) < steps or len(pin) < steps:
        return None
    return sum(wait) / steps, f"data.pin_copy {sum(pin) / steps:.3f} ms"
