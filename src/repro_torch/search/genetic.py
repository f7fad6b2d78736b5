"""Tournament-selection genetic algorithm over the pruned pow-2 index space.

Population members are [5] axis-index rows (the same walk space as SA);
the populations of every job of a batch advance together, one batched
evaluation call (one kernel launch on the card) per generation:

* **init** -- scrambled-Sobol stratified population
  (:func:`repro_torch.search.sobol.sobol_index_population`);
* **selection** -- size-``tournament`` tournaments (the first argmin
  fitness wins);
* **crossover** -- uniform: each axis independently picks parent A or B,
  gated per child by ``crossover_prob``;
* **mutation** -- axis-index redraw: each gene resamples uniformly inside
  its axis's true length with probability ``mutation_prob``;
* **elitism** -- the best ``elite`` members (stable order: ties at
  INFEASIBLE keep population order) survive unchanged.

Each job draws all its generations' randomness up front from its own
generator, and a generation runs on the device without a host sync.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.search.base import (SearchBackend, cfg_from_indices,
                                     draw_per_job, gather_rows,
                                     register_backend)
from repro_torch.search.sobol import draw_shift, sobol_index_population

__all__ = ["GASettings", "GeneticBackend"]


@dataclasses.dataclass(frozen=True)
class GASettings:
    pop: int = 64
    generations: int = 400            # ~ SA's default budget (64 x 400)
    tournament: int = 3
    crossover_prob: float = 0.9
    mutation_prob: float = 0.15
    elite: int = 2
    seed: int = 0


class GeneticBackend(SearchBackend):
    name = "genetic"
    settings_cls = GASettings

    def budget(self, settings: GASettings) -> int:
        return settings.pop * (settings.generations + 1)

    def with_budget(self, settings: GASettings, n_evals: int):
        pop = min(settings.pop, max(8, int(n_evals) // 8))
        return dataclasses.replace(
            settings, pop=pop,
            generations=max(1, int(n_evals) // pop - 1),
            elite=min(settings.elite, pop - 1))

    def run(self, objective_fn, mat, lens, bw, settings: GASettings,
            generators):
        n, elite, gens = settings.pop, settings.elite, settings.generations
        dev = mat.device

        def draw(g):
            rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
            return (draw_shift(g, dev),
                    torch.randint(0, n, (gens, 2 * n, settings.tournament),
                                  generator=g, device=dev),
                    rand(gens, n, 1) < settings.crossover_prob,
                    rand(gens, n, 5) < 0.5,
                    rand(gens, n, 5) < settings.mutation_prob,
                    torch.randint(0, 1 << 20, (gens, n, 5), generator=g,
                                  device=dev))
        shift, tsel, do_cx, take_b, mutate, redraw = draw_per_job(
            generators, draw)
        J = mat.shape[0]
        lens = lens.to(device=dev, dtype=torch.long)

        pop = sobol_index_population(n, lens, shift)
        fit = objective_fn(cfg_from_indices(mat, pop, bw))
        w0 = torch.argmin(fit, dim=1, keepdim=True)
        best_idx = gather_rows(pop, w0)[:, 0]
        best_val = torch.gather(fit, 1, w0)[:, 0]
        trace = []
        for t in range(gens):
            # tournament selection of 2 parents per child
            ts = tsel[:, t]                                  # [J, 2n, T]
            tfit = torch.gather(fit, 1, ts.reshape(J, -1)).reshape(ts.shape)
            winners = torch.gather(ts, 2, torch.argmin(
                tfit, dim=2, keepdim=True))[..., 0]          # [J, 2n]
            pa = gather_rows(pop, winners[:, :n])
            pb = gather_rows(pop, winners[:, n:])

            # uniform crossover, then axis-index redraw within the bounds
            child = torch.where(do_cx[:, t] & take_b[:, t], pb, pa)
            child = torch.where(mutate[:, t],
                                redraw[:, t] % lens[:, None, :], child)

            # elitism: current best members overwrite the first rows
            order = torch.argsort(fit, dim=1, stable=True)
            child = torch.cat([gather_rows(pop, order[:, :elite]),
                               child[:, elite:]], dim=1)
            fit = objective_fn(cfg_from_indices(mat, child, bw))
            pop = child

            w = torch.argmin(fit, dim=1, keepdim=True)
            w_val = torch.gather(fit, 1, w)[:, 0]
            better = w_val < best_val
            best_idx = torch.where(better[:, None],
                                   gather_rows(pop, w)[:, 0], best_idx)
            best_val = torch.where(better, w_val, best_val)
            trace.append(best_val)
        # pin the global best into member 0 so the engine's per-member
        # argmin always sees it regardless of elitism settings
        pop = torch.cat([best_idx[:, None], pop[:, 1:]], dim=1)
        fit = torch.cat([best_val[:, None], fit[:, 1:]], dim=1)
        return pop, fit, torch.stack(trace, dim=1)


register_backend(GeneticBackend())
