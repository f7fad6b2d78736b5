"""Instruction-driven cycle simulator for the generalized accelerator
template (paper Sec. III-A: "cycle-accurate performance and power
simulations ... driven by instruction flows").

Consumes the per-resident-set schedule emitted by ``compiler.compile_schedule``
and plays it through a three-resource pipeline:

    BUS  -- external memory traffic (ema bits / BW per set)
    CIM  -- plane updates + plane computes
    (IS/OS are bandwidth-matched by the Sec. III-D pruning rule and are not
     separately modeled)

Dependency model (double-buffered pipeline):

    bus_done[i]    = bus_done[i-1] + ema_cyc[i]
    upd_start[i]   = max(upd_done[i-1], bus_done[i])                (overlap)
                     max(cmp_done[i-1], bus_done[i])             (no overlap)
    upd_done[i]    = upd_start[i] + upd_cyc[i]
    cmp_start[i]   = max(cmp_done[i-1], upd_done[i])
    cmp_done[i]    = cmp_start[i] + cmp_cyc[i]

The reference scans this recurrence set by set.  A schedule may hold up to
``compiler.MAX_SETS`` sets, so the port evaluates its exact closed form
instead, with ``B``, ``Su``, ``Sc`` the inclusive prefix sums of the bus,
update and compute cycles (``S_0 = 0``):

    overlap:     upd_done[i] = Su[i] + max_{j<=i}(B[j] - Su[j-1])
                 cmp_done[i] = Sc[i] + max(0, max_{j<=i}(upd_done[j] - Sc[j-1]))
    no overlap:  cmp_done[i] = Sd[i] + max(0, max_{j<=i}(B[j] - Sd[j-1])),
                 Sd the prefix sum of upd_cyc + cmp_cyc

(each a ``cumsum`` and a ``cummax``).  Cycle counts are integers, so in
float64 every term is exact below 2^53 and the result equals the
reference's x64 scan; in float32 both are exact while the sums stay below
2^24.

The closed-form model's overlapped latency max(sum_c, sum_e, sum_u) is a
*lower bound* of this simulation and sum(c+e+u) an upper bound; both bounds
are property-tested, and the typical gap (near zero for the homogeneous
steady-state sets the compiler emits) is reported by the benchmarks.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device


def _ema_cycles(rec: dict[str, np.ndarray], bw: int) -> np.ndarray:
    ema_bits = (
        rec["v_bits"] + rec["s_bits"] + rec["spill_bits"] + rec["y_bits"]
    )
    return np.ceil(ema_bits / bw)


def _exclusive(s: torch.Tensor) -> torch.Tensor:
    """``s`` shifted right by one, 0 first: S[j-1] beside S[j]."""
    return torch.cat([s.new_zeros(1), s[:-1]])


def simulate_schedule(
    rec: dict[str, np.ndarray],
    bw: int,
    overlap: bool,
    *,
    device=None,
    dtype: torch.dtype | None = None,
) -> dict[str, float]:
    """Cycle simulation of one compiled schedule.  Returns latency and
    per-resource busy/utilization stats.

    Runs on ``device`` (``cuda`` unless the caller passes ``"cpu"``; a
    ``cuda`` request without a card raises) in ``dtype`` (float32, the
    reference's default, unless given; float64 is exact).
    """
    dev = resolve_device("cuda" if device is None else device)
    dtype = dtype or torch.float32
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64)).to(
        device=dev, dtype=dtype)
    e = as_t(_ema_cycles(rec, bw))
    c = as_t(rec["compute_cycles"])
    u = as_t(rec["update_cycles"])
    n_sets = int(e.numel())

    if n_sets == 0:
        latency = 0.0
    elif overlap:
        bus = torch.cumsum(e, 0)
        su, sc = torch.cumsum(u, 0), torch.cumsum(c, 0)
        upd = su + torch.cummax(bus - _exclusive(su), 0).values
        lead = torch.clamp_min(torch.max(upd - _exclusive(sc)), 0.0)
        latency = float(sc[-1] + lead)
    else:
        bus = torch.cumsum(e, 0)
        sd = torch.cumsum(u + c, 0)
        lead = torch.clamp_min(torch.max(bus - _exclusive(sd)), 0.0)
        latency = float(sd[-1] + lead)
    total = {
        "latency_cycles": latency,
        "bus_busy": float(e.sum()),
        "compute_busy": float(c.sum()),
        "update_busy": float(u.sum()),
        "n_sets": n_sets,
    }
    total["compute_utilization"] = total["compute_busy"] / max(latency, 1.0)
    total["bus_utilization"] = total["bus_busy"] / max(latency, 1.0)
    return total


def analytic_latency_bounds(
    rec: dict[str, np.ndarray], bw: int
) -> tuple[float, float]:
    """(lower, upper) bounds that must sandwich the simulated latency."""
    e = float(_ema_cycles(rec, bw).sum())
    c = float(rec["compute_cycles"].sum())
    u = float(rec["update_cycles"].sum())
    return max(c, e, u), c + e + u
