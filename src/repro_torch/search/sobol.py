"""Scrambled quasi-random (Sobol) baseline backend.

A low-discrepancy sweep over the 5-axis index space: Sobol points in
[0, 1)^5 (Joe-Kuo direction numbers, first five dimensions, digital-shift
scrambled per job) are mapped to per-axis indices.  Serves two roles:

1. the cheapest sensible baseline an optimizer must beat -- evenly
   stratified coverage of the pruned pow-2 grid, no adaptivity;
2. the init-population provider for the population backends
   (:func:`sobol_index_population` seeds GA / DE with stratified rather
   than i.i.d. uniform members).

The Gray-code XOR sweep runs in int64 tensors holding 30-bit values (CUDA
lacks most uint32 operations in torch).  The 30-bit digital shift is an
argument of :func:`scrambled_sobol`, drawn from each job's generator by
the backends, so the points equal the reference's bit for bit given the
reference's shift.  One evaluation call scores a whole sweep.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.search.base import (SearchBackend, cfg_from_indices,
                                     draw_per_job, register_backend)

__all__ = ["SobolSettings", "SobolBackend", "sobol_index_population",
           "scrambled_sobol", "draw_shift"]

#: bits of Sobol resolution (< 31 keeps everything in safe int32 range)
_BITS = 30


def _direction_numbers(bits: int = _BITS) -> np.ndarray:
    """[5, bits] uint32 direction numbers (dim 1 = van der Corput; dims 2-5
    from the Joe-Kuo primitive-polynomial table)."""
    polys = (                        # (s, a, initial m values), dims 2..5
        (1, 0, (1,)),
        (2, 1, (1, 3)),
        (3, 1, (1, 3, 1)),
        (3, 2, (1, 1, 1)),
    )
    v = np.zeros((5, bits), dtype=np.uint32)
    v[0] = [1 << (bits - 1 - j) for j in range(bits)]
    for d, (s, a, m_init) in enumerate(polys, start=1):
        m = list(m_init)
        for i in range(s, bits):
            new = m[i - s] ^ (m[i - s] << s)
            for k in range(1, s):
                new ^= ((a >> (s - 1 - k)) & 1) * (m[i - k] << k)
            m.append(new)
        v[d] = [m[j] << (bits - 1 - j) for j in range(bits)]
    return v


_DIRECTIONS = _direction_numbers()


def draw_shift(generator: torch.Generator, device) -> torch.Tensor:
    """One job's 30-bit digital shift [5] (int64), from its generator."""
    return torch.randint(0, 1 << _BITS, (5,), generator=generator,
                         device=device)


def scrambled_sobol(n: int, shift: torch.Tensor) -> torch.Tensor:
    """[J, n, 5] float32 Sobol points in [0, 1), each job's sweep XORed
    with its 30-bit shift ``shift`` [J, 5] (int64)."""
    dev = shift.device
    i = torch.arange(n, dtype=torch.int64, device=dev)
    gray = i ^ (i >> 1)
    directions = torch.as_tensor(_DIRECTIONS.astype(np.int64), device=dev)
    x = torch.zeros((n, 5), dtype=torch.int64, device=dev)
    for j in range(_BITS):
        bit = (gray >> j) & 1
        x = x ^ (bit[:, None] * directions[None, :, j])
    x = x[None] ^ (shift[:, None, :] & ((1 << _BITS) - 1))
    return x.to(torch.float32) / float(1 << _BITS)


def sobol_index_population(n: int, lens: torch.Tensor,
                           shift: torch.Tensor) -> torch.Tensor:
    """[J, n, 5] int64 axis indices, stratified over each job's per-axis
    ranges ``lens`` [J, 5] -- the shared init-population provider (GA /
    DE / the Sobol sweep)."""
    u = scrambled_sobol(n, shift)
    idx = torch.floor(u * lens[:, None, :].to(torch.float32)).long()
    return torch.minimum(idx, lens[:, None, :] - 1)


@dataclasses.dataclass(frozen=True)
class SobolSettings:
    n_points: int = 1024
    seed: int = 0


class SobolBackend(SearchBackend):
    name = "sobol"
    settings_cls = SobolSettings

    def budget(self, settings: SobolSettings) -> int:
        return settings.n_points

    def with_budget(self, settings: SobolSettings, n_evals: int):
        return dataclasses.replace(settings, n_points=max(8, int(n_evals)))

    def run(self, objective_fn, mat, lens, bw, settings: SobolSettings,
            generators):
        (shift,) = draw_per_job(
            generators, lambda g: (draw_shift(g, mat.device),))
        idx = sobol_index_population(settings.n_points, lens, shift)
        vals = objective_fn(cfg_from_indices(mat, idx, bw))
        return idx, vals, torch.cummin(vals, dim=1).values


register_backend(SobolBackend())
