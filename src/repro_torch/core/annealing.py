"""Simulated-annealing engine for the hardware-mapping co-exploration
(paper Sec. III-D / IV-A: "hardware configurations are iteratively adjusted
... through the simulated annealing algorithm").

Chains of every job in a batch advance together: one SA step proposes a
move for each of the ``[jobs, chains]`` walkers and evaluates all of them
in one call of the batched objective (one kernel launch on the card).
Steps run as a Python loop.  Registered as the ``"sa"`` backend of the
search subsystem (``repro_torch.search.sa``).

The walk moves through index space of the (power-of-two constrained) axis
value lists; the area budget enters as a smooth penalty inside the objective
so chains can skirt the boundary.  Acceptance uses relative deltas
(exp(-(new-old)/old / T)) to stay scale-free across objectives.

Randomness comes from one ``torch.Generator`` seeded with
``SASettings.seed``; every job of a batch sees the same uniform draws (as
every job of a reference batch gets the same chain keys), so a job's walk
does not depend on the batch it runs in.  The draws differ from JAX's
threefry streams, so the port's SA is held to the reference on outcome.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pruning import DesignSpace


@dataclasses.dataclass(frozen=True)
class SASettings:
    n_chains: int = 64
    n_steps: int = 400
    t0: float = 0.3
    alpha: float = 0.985
    jump_prob: float = 0.15   # occasional uniform redraw of one axis
    seed: int = 0


def _axes_matrix(space: DesignSpace) -> tuple[np.ndarray, np.ndarray]:
    """Pad per-axis value lists into a [5, Lmax] matrix + length vector."""
    axes = space.axes()
    lmax = max(len(a) for a in axes)
    mat = np.zeros((5, lmax), dtype=np.float64)
    lens = np.zeros(5, dtype=np.int32)
    for i, vals in enumerate(axes):
        mat[i, : len(vals)] = vals
        mat[i, len(vals):] = vals[-1]
        lens[i] = len(vals)
    return mat, lens


def cfg_of(mat: torch.Tensor, idx: torch.Tensor, bw: torch.Tensor):
    """Axis-index rows [J, M, 5] -> cfg rows [J, M, 6] (bus width last)."""
    J, n = idx.shape[:2]
    vals = torch.gather(mat[:, None].expand(J, n, *mat.shape[1:]), 3,
                        idx[..., None])[..., 0]
    return torch.cat([vals, bw[:, None, None].expand(J, n, 1)], dim=2)


def _uniform_index(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """floor(u * n) for u in [0, 1) and integer n, kept inside [0, n - 1]."""
    return torch.minimum(torch.floor(u * n).long(), n - 1)


def anneal(
    objective_fn,              # cfg [J, M, 6] -> [J, M] (lower is better)
    mat: torch.Tensor,         # [J, 5, L] padded axis-value matrices
    lens: torch.Tensor,        # [J, 5] true axis lengths (int64)
    bw: torch.Tensor,          # [J] external bus bandwidth (appended to cfg)
    settings: SASettings,
    generator: torch.Generator,
):
    """Vectorized-chain SA walk over a batch of jobs.

    Returns (best_idx [J, chains, 5], best_val [J, chains],
    hists [J, chains, steps]).
    """
    J, n, steps = mat.shape[0], settings.n_chains, settings.n_steps
    dev = mat.device
    draw = dict(generator=generator, device=dev, dtype=torch.float64)
    u_init = torch.rand((n, 5), **draw)
    u = torch.rand((steps, n, 5), **draw)
    lens = lens.to(device=dev, dtype=torch.long)

    idx = _uniform_index(u_init[None], lens[:, None, :])           # [J, n, 5]
    val = objective_fn(cfg_of(mat, idx, bw))
    best_idx, best_val = idx, val
    temps = settings.t0 * settings.alpha ** np.arange(steps)
    hist = []
    chains = torch.arange(n, device=dev)
    for t in range(steps):
        axis = torch.floor(u[t, :, 0] * 5).long().clamp(max=4)      # [n]
        jump = u[t, :, 1] < settings.jump_prob                      # [n]
        delta = torch.where(u[t, :, 2] < 0.5, -1, 1)                # [n]
        hi = lens[:, axis]                                          # [J, n]
        cur = idx[:, chains, axis]                                  # [J, n]
        new_pos = torch.where(
            jump, _uniform_index(u[t, :, 3], hi),
            torch.minimum(torch.clamp_min(cur + delta, 0), hi - 1))
        new_idx = idx.clone()
        new_idx[:, chains, axis] = new_pos
        new_val = objective_fn(cfg_of(mat, new_idx, bw))
        rel = (new_val - val) / torch.clamp_min(val, 1e-30)
        accept = (new_val < val) | (
            u[t, :, 4].to(val.dtype)
            < torch.exp(-rel / max(float(temps[t]), 1e-9)))
        idx = torch.where(accept[..., None], new_idx, idx)
        val = torch.where(accept, new_val, val)
        better = val < best_val
        best_idx = torch.where(better[..., None], idx, best_idx)
        best_val = torch.where(better, val, best_val)
        hist.append(best_val)
    return best_idx, best_val, torch.stack(hist, dim=-1)
