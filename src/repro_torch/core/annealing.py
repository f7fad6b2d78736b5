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

Each job draws its walk's uniforms up front from its own
``torch.Generator`` (seeded ``SASettings.seed``, or a portfolio pull's
derived seed), so a job's walk does not depend on the batch it runs in;
jobs with equal seeds draw equal numbers, as every job of a reference
batch gets the same chain keys.  The draws differ from JAX's threefry
streams, so the port's SA is held to the reference on outcome.

The single-job API (:func:`simulated_annealing`, :func:`exhaustive_search`)
takes a batched objective ``cfg [..., 6] -> [...]``, such as
``cost_model.make_objective_fn`` (plain PyTorch) or
``kernels.ops.objective_fn`` (one ``strategy_eval`` launch per call on the
card).
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from repro_torch.core.pruning import DesignSpace


class SAResult(typing.NamedTuple):
    best_cfg: torch.Tensor        # [6] (mr, mc, scr, is_kb, os_kb, bw)
    best_value: torch.Tensor      # scalar
    best_per_chain: torch.Tensor  # [chains]
    trace_best: torch.Tensor      # [steps] population-best value per step


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


def make_chain_keys(settings: SASettings, key: int | None = None
                    ) -> np.ndarray:
    """[n_chains] int64 seeds, one per chain: ``key + i`` (``key``
    defaults to ``settings.seed``) -- the port's counterpart of the
    reference's per-chain PRNG keys."""
    base = settings.seed if key is None else int(key)
    return base + np.arange(settings.n_chains, dtype=np.int64)


def _uniform_index(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """floor(u * n) for u in [0, 1) and integer n, kept inside [0, n - 1]."""
    return torch.minimum(torch.floor(u * n).long(), n - 1)


def anneal(
    objective_fn,              # cfg [J, M, 6] -> [J, M] (lower is better)
    mat: torch.Tensor,         # [J, 5, L] padded axis-value matrices
    lens: torch.Tensor,        # [J, 5] true axis lengths (int64)
    bw: torch.Tensor,          # [J] external bus bandwidth (appended to cfg)
    settings: SASettings,
    generators,                # one torch.Generator per job
):
    """Vectorized-chain SA walk over a batch of jobs.

    Returns (best_idx [J, chains, 5], best_val [J, chains],
    hists [J, chains, steps]).
    """
    # search.base imports this module's package through search/__init__
    from repro_torch.search.base import cfg_from_indices, draw_per_job

    J, n, steps = mat.shape[0], settings.n_chains, settings.n_steps
    dev = mat.device
    u_init, u = draw_per_job(generators, lambda g: (
        torch.rand((n, 5), generator=g, device=dev, dtype=torch.float64),
        torch.rand((steps, n, 5), generator=g, device=dev,
                   dtype=torch.float64)))
    u = u.transpose(0, 1)                                   # [steps, J, n, 5]
    lens = lens.to(device=dev, dtype=torch.long)

    idx = _uniform_index(u_init, lens[:, None, :])                 # [J, n, 5]
    val = objective_fn(cfg_from_indices(mat, idx, bw))
    best_idx, best_val = idx, val
    temps = settings.t0 * settings.alpha ** np.arange(steps)
    hist = []
    for t in range(steps):
        idx, val, best_idx, best_val = sa_step(
            objective_fn, mat, lens, bw, (idx, val, best_idx, best_val),
            u[t], float(temps[t]), settings.jump_prob)
        hist.append(best_val)
    return best_idx, best_val, torch.stack(hist, dim=-1)


def sa_step(objective_fn, mat, lens, bw, state, u: torch.Tensor,
            temp: float, jump_prob: float):
    """One SA move of every walker of a ``[J, n]`` block: ``state`` is
    (idx [J, n, 5], val, best_idx, best_val [J, n]), ``u`` [J, n, 5] the
    move's uniforms (axis, jump, direction, jump target, acceptance) and
    ``lens`` [J, 5] int64.  One ``objective_fn`` call scores the block's
    proposals; returns the new state."""
    # search.base imports this module's package through search/__init__
    from repro_torch.search.base import cfg_from_indices

    idx, val, best_idx, best_val = state
    axis = torch.floor(u[..., 0] * 5).long().clamp(max=4)          # [J, n]
    jump = u[..., 1] < jump_prob                                   # [J, n]
    delta = torch.where(u[..., 2] < 0.5, -1, 1)                    # [J, n]
    hi = torch.gather(lens, 1, axis)                               # [J, n]
    cur = torch.gather(idx, 2, axis[..., None])[..., 0]            # [J, n]
    new_pos = torch.where(
        jump, _uniform_index(u[..., 3], hi),
        torch.minimum(torch.clamp_min(cur + delta, 0), hi - 1))
    new_idx = idx.scatter(2, axis[..., None], new_pos[..., None])
    new_val = objective_fn(cfg_from_indices(mat, new_idx, bw))
    rel = (new_val - val) / torch.clamp_min(val, 1e-30)
    accept = (new_val < val) | (
        u[..., 4].to(val.dtype) < torch.exp(-rel / max(temp, 1e-9)))
    idx = torch.where(accept[..., None], new_idx, idx)
    val = torch.where(accept, new_val, val)
    better = val < best_val
    best_idx = torch.where(better[..., None], idx, best_idx)
    best_val = torch.where(better, val, best_val)
    return idx, val, best_idx, best_val


def _working(device, dtype) -> tuple[torch.device, torch.dtype]:
    """``device`` (``cuda`` by default; raises without a card) and
    ``dtype`` (float32 by default)."""
    from repro_torch.core.engine import resolve_device

    return (resolve_device("cuda" if device is None else device),
            dtype or torch.float32)


def simulated_annealing(
    objective_fn,              # cfg [..., 6] -> [...] (lower is better)
    space: DesignSpace,
    bw: int,
    settings: SASettings = SASettings(),
    key: int | None = None,
    *,
    device=None,
    dtype: torch.dtype | None = None,
) -> SAResult:
    """SA over one job's design space: :func:`anneal` with one job, its
    generator seeded ``key`` (``settings.seed`` unless given).  Runs on
    ``device`` (the card unless ``"cpu"``) in ``dtype``."""
    dev, dtype = _working(device, dtype)
    mat, lens = _axes_matrix(space)
    mat_t = torch.as_tensor(mat[None], dtype=dtype).to(dev)
    lens_t = torch.as_tensor(lens[None], dtype=torch.long, device=dev)
    bw_t = torch.full((1,), float(bw), dtype=dtype, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(settings.seed if key is None else int(key))
    best_idx, best_val, hists = anneal(
        objective_fn, mat_t, lens_t, bw_t, settings, [gen])
    winner = int(torch.argmin(best_val[0]))
    vals = mat_t[0, torch.arange(5, device=dev), best_idx[0, winner]]
    return SAResult(
        best_cfg=torch.cat([vals, bw_t]),
        best_value=best_val[0, winner],
        best_per_chain=best_val[0],
        trace_best=hists[0].min(dim=0).values,
    )


def exhaustive_search(
    objective_fn,              # cfg [..., 6] -> [...]
    candidates: np.ndarray,    # [C, 6] cfg rows (pruned space + bw column)
    batch: int = 4096,
    *,
    device=None,
    dtype: torch.dtype | None = None,
) -> tuple[np.ndarray, float]:
    """Ground-truth optimum over an (already pruned) candidate list,
    ``batch`` rows per objective call; ties keep the first row."""
    dev, dtype = _working(device, dtype)
    best_val = np.inf
    best_cfg = None
    for i in range(0, len(candidates), batch):
        chunk = torch.as_tensor(np.asarray(candidates[i: i + batch],
                                           np.float64), dtype=dtype).to(dev)
        vals = objective_fn(chunk).cpu().numpy()
        j = int(np.argmin(vals))
        if vals[j] < best_val:
            best_val = float(vals[j])
            best_cfg = np.asarray(candidates[i + j])
    return best_cfg, best_val
