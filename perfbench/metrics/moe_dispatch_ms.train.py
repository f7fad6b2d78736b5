"""Model: the host time of the program's ``moe.dispatch`` spans a step
(the dropless dispatch of the held experts: the pairs' rows laid out by
expert on the card and gathered), the mean over the window's steps, in
ms, read from the port's span tracer in this process
(``repro_torch.obs.tracer()``).  The note gives the spans a step and the
largest held expert's load over the mean, from the port's counter of
(token, choice) pairs per held expert over the whole run."""
import sys


def _load_skew():
    moe = sys.modules.get("repro_torch.models.moe")
    pairs = getattr(moe, "EXPERT_PAIRS", None)
    if pairs is None:
        return None
    getattr(moe, "flush_expert_pairs", lambda: None)()
    loads = [child.value for _, child in pairs.samples()]
    if not loads or not sum(loads):
        return None
    return max(loads) / (sum(loads) / len(loads))


def read(record):
    obs_trace = sys.modules.get("repro_torch.obs.trace")
    steps = record["window"]["steps"]
    if obs_trace is None or not steps:
        return None
    events = obs_trace.tracer().events()
    starts = [e["ts"] for e in events if e["name"] == "step.forward"][-steps:]
    if len(starts) < steps:
        return None
    spans = [e for e in events
             if e["name"] == "moe.dispatch" and e["ts"] >= starts[0]]
    if not spans:
        return None
    skew = _load_skew()
    return 1e-3 * sum(e["dur"] for e in spans) / steps, \
        f"{len(spans) / steps:g} moe.dispatch spans a step; largest held " \
        "expert's load over the mean " + \
        ("not read" if skew is None else f"{skew:.3f}")
