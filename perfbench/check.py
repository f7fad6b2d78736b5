"""The comparison that decides ``correct`` for a training cell: the
program's first steps against the plain reference's from the same
weights and batches.

Three numbers, each against its limit in ``limits/<workload>.json``:

- ``loss_gap``: the largest |program - reference| over the checked
  steps' losses;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient as the optimizer gets
  it (clipped), over the larger of the reference's norm of that leaf and
  of the median leaf;
- ``change_gap``: the same for each leaf's norm of its change over the
  checked steps, leaving out the leaves whose reference gradient is
  under :data:`NOUGHT` of the median leaf's (they move by round-off
  alone).

A number whose limit is null is printed and not judged.  A skipped step
or a value that is not finite is not correct whatever the numbers say.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

NOUGHT = 1e-3


def _median(xs: list) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def leaf_gaps(prog: list, ref: list) -> list:
    """|prog - ref| / max(ref, median ref) of each leaf."""
    med = _median(ref)
    return [abs(p - r) / max(r, med, 1e-30) for p, r in zip(prog, ref)]


def kept(ref: dict) -> list:
    """The leaves the change is compared on: the reference's gradient at
    least :data:`NOUGHT` of the median leaf's."""
    med = _median(ref["first_grad"])
    return [g >= NOUGHT * med for g in ref["first_grad"]]


def numbers(prog: dict, ref: dict) -> dict:
    """The three numbers from the program's and the reference's readings
    (``loss`` per step, ``first_grad`` and ``change`` per leaf)."""
    change = [g for g, k in zip(leaf_gaps(prog["change"], ref["change"]),
                                kept(ref)) if k]
    return {
        "loss_gap": max(abs(p - r) for p, r in zip(prog["loss"], ref["loss"])),
        "grad_gap": max(leaf_gaps(prog["first_grad"], ref["first_grad"])),
        "change_gap": max(change, default=0.0),
    }


def load_limits(path: Path) -> dict:
    with open(path) as f:
        return {k: v["limit"] for k, v in json.load(f)["limits"].items()}


def verdict(nums: dict, limits: dict, sound: bool) -> tuple[bool, dict]:
    """(correct, each number with its limit)."""
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    ok = sound and all(math.isfinite(v) for v in nums.values())
    for k, v in nums.items():
        if limits.get(k) is not None and not v <= limits[k]:
            ok = False
    return ok, compared
