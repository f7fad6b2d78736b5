"""Discrete differential evolution (rand/1/bin) over the index space.

The classic DE mutant ``x_r1 + F * (x_r2 - x_r3)`` is computed in *float
index space* (float32, as the reference does, whatever the engine's
dtype) and snapped back to the integer grid (round half to even + clip to
the axis's true length), which preserves DE's self-scaling step sizes on
the pow-2 axes; binomial crossover (``cr``, with the guaranteed
``j_rand`` gene) and greedy one-to-one selection are standard.  Greedy
selection makes DE elitist: the final population's min fitness IS the
best value ever seen.  Init population comes from the scrambled-Sobol
provider.  Each job draws all its generations' randomness up front from
its own generator; one batched evaluation call per generation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.search.base import (SearchBackend, cfg_from_indices,
                                     draw_per_job, gather_rows,
                                     register_backend)
from repro_torch.search.sobol import draw_shift, sobol_index_population

__all__ = ["DESettings", "DifferentialEvolutionBackend"]


@dataclasses.dataclass(frozen=True)
class DESettings:
    pop: int = 48
    generations: int = 530            # ~ SA's default budget (64 x 400)
    f: float = 0.6                    # differential weight
    cr: float = 0.9                   # crossover rate
    seed: int = 0


class DifferentialEvolutionBackend(SearchBackend):
    name = "evolution"
    settings_cls = DESettings

    def budget(self, settings: DESettings) -> int:
        return settings.pop * (settings.generations + 1)

    def with_budget(self, settings: DESettings, n_evals: int):
        pop = min(settings.pop, max(8, int(n_evals) // 8))
        return dataclasses.replace(
            settings, pop=pop, generations=max(1, int(n_evals) // pop - 1))

    def run(self, objective_fn, mat, lens, bw, settings: DESettings,
            generators):
        n, gens = settings.pop, settings.generations
        dev = mat.device

        def draw(g):
            return (draw_shift(g, dev),
                    torch.randint(0, n, (gens, n, 3), generator=g,
                                  device=dev),
                    torch.rand((gens, n, 5), generator=g, device=dev)
                    < settings.cr,
                    torch.randint(0, 5, (gens, n), generator=g, device=dev))
        shift, r, cross, j_rand = draw_per_job(generators, draw)
        lens = lens.to(device=dev, dtype=torch.long)
        top = (lens - 1)[:, None, :].to(torch.float32)
        genes = torch.arange(5, device=dev)

        pop = sobol_index_population(n, lens, shift)
        fit = objective_fn(cfg_from_indices(mat, pop, bw))
        trace = []
        for t in range(gens):
            # rand/1: three donors per member (independent draws; a rare
            # collision just produces a null difference vector)
            x1, x2, x3 = (gather_rows(pop, r[:, t, :, k])
                          for k in range(3))
            mutant = x1.to(torch.float32) + settings.f * (
                x2 - x3).to(torch.float32)
            mutant = torch.minimum(torch.clamp_min(torch.round(mutant), 0),
                                   top).long()

            # bin: binomial crossover with a guaranteed mutant gene
            c = cross[:, t] | (genes == j_rand[:, t, :, None])
            trial = torch.where(c, mutant, pop)

            # greedy one-to-one selection
            trial_fit = objective_fn(cfg_from_indices(mat, trial, bw))
            keep = trial_fit <= fit
            pop = torch.where(keep[..., None], trial, pop)
            fit = torch.where(keep, trial_fit, fit)
            trace.append(fit.min(dim=1).values)
        return pop, fit, torch.stack(trace, dim=1)


register_backend(DifferentialEvolutionBackend())
