"""Portfolio racer: budget-allocated racing over the registered backends.

No single optimizer dominates every (macro, workload, objective, budget)
job, so the portfolio races them.  Two budget **allocators** are available
(``PortfolioSettings.allocator``):

``"bandit"`` (default)
    A deterministic UCB bandit over per-backend *improvement rates*.  Every
    backend first gets one initialization pull (a fixed budget slice); each
    subsequent pull goes to the backend maximizing ``mean reward +
    ucb_c * sqrt(ln(total pulls) / pulls)``, **per job**, where a pull's
    reward is the normalized incumbent improvement it achieved -- computed
    from the best-so-far trace each run already returns (the run best IS
    ``min(trace)``).  Ties break on backend order, rewards derive
    only from objective values, and every pull's RNG comes from
    :func:`derived_seed` -- so allocation is bit-deterministic given the
    job seed and race runs still replay standalone.

``"halving"``
    The fixed successive-halving schedule: every surviving backend gets an
    equal slice per rung, each job culls to its best ``ceil(k/2)`` per
    rung.

Both allocators spend ``race_fraction`` of ``total_evals`` racing and hand
the remainder to each job's winning backend; the reported best is the min
over *all* phases, so the portfolio can never report worse than any race
run it performed.  Both spend the same race budget: halving evaluates
``race/rungs`` per rung; the bandit makes ``len(backends) * rungs`` pulls
of ``race / (len(backends) * rungs)`` evaluations each.  The first bandit
pull of every backend therefore has exactly the settings (budget + derived
seed) of halving's rung 0, which is what the dominance tests replay.

The portfolio is a *composite* backend: it has no run of its own.  The
engine orchestrates it (``_run_portfolio_batch``), batching each pull's
jobs through the constituent backends' regular batched runs on the
engine's one card; the per-constituent device placement
(:func:`constituent_devices`) is validated and wraps over that one slot.

Budget split (``race_plan`` / ``final_plan`` / ``bandit_pull_plan``) is
deterministic from the settings alone, and every scaled constituent gets a
seed derived only from ``(seed, backend index, pull index)`` -- running a
constituent standalone with a plan entry's settings reproduces the
portfolio's race run bit-for-bit (what the parity/property tests assert).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.search.base import (SearchBackend, get_backend,
                                     register_backend)

__all__ = ["PortfolioSettings", "PortfolioBackend", "race_plan",
           "final_plan", "derived_seed", "bandit_slice", "bandit_rounds",
           "bandit_pull_plan", "ucb_scores", "pull_reward", "ALLOCATORS",
           "FIDELITIES", "constituent_devices"]

#: valid ``PortfolioSettings.allocator`` values
ALLOCATORS = ("bandit", "halving")

#: valid ``PortfolioSettings.fidelity`` values: "analytic" scores with the
#: closed-form cost model only; "measured" adds a final re-scoring phase
#: where the top-K analytic winners are re-ranked under kernel-calibrated
#: tech constants (repro.core.calibration)
FIDELITIES = ("analytic", "measured")


@dataclasses.dataclass(frozen=True)
class PortfolioSettings:
    """Knobs of the portfolio racer (see the module docstring)."""

    #: constituent backends to race (must be registered, non-composite)
    backends: tuple[str, ...] = ("sa", "genetic", "evolution", "sobol")
    #: total objective-evaluation budget per job (~ SA's default 64 x 400)
    total_evals: int = 25_600
    #: fraction of the budget spent racing (the rest goes to the winner)
    race_fraction: float = 0.5
    #: budget granularity: rung count for "halving", pull-count multiplier
    #: for "bandit" (both spend the race budget in ``rungs`` equal waves)
    rungs: int = 2
    #: race-budget allocation strategy: "bandit" (UCB over per-backend
    #: improvement rates) or "halving" (fixed successive-halving rungs)
    allocator: str = "bandit"
    #: UCB exploration constant (bandit allocator only)
    ucb_c: float = 0.5
    seed: int = 0
    #: scoring fidelity: "analytic" (default) or "measured" (two-fidelity
    #: race -- the final phase re-scores the top-K candidates with
    #: kernel-measurement-calibrated tech constants)
    fidelity: str = "analytic"
    #: how many analytic front-runners the measured phase re-scores
    topk: int = 8
    #: cross-job budget flow (bandit allocator only): a job whose last
    #: ``flatline_waves`` consecutive adaptive pulls each earned reward
    #: below ``flatline_eps`` releases its remaining race pulls into a
    #: shared group pool that still-improving jobs drain.  0 disables
    #: reallocation entirely (the bit-for-bit-deterministic default).
    flatline_waves: int = 0
    #: reward threshold below which an adaptive pull counts as flat
    flatline_eps: float = 1e-6
    #: per-constituent device pin: ``device_affinity[b]`` is the race
    #: device slot backend ``b`` runs on every wave (``None`` keeps the
    #: engine's round-robin placement).  Slots index the visible race
    #: devices modulo their count, so a pinning stays valid -- and the
    #: results stay bit-identical -- whatever hardware is present.
    device_affinity: tuple[int, ...] | None = None

    def __post_init__(self):
        # field-local checks fail fast at construction; registry-dependent
        # checks (backend names, composites) stay in _validate so custom
        # backends can be registered after settings are built
        if self.fidelity not in FIDELITIES:
            raise ValueError(
                f"unknown portfolio fidelity {self.fidelity!r}; "
                f"valid: {FIDELITIES}")
        if self.topk < 1:
            raise ValueError("portfolio topk must be >= 1")
        if self.allocator not in ALLOCATORS:
            raise ValueError(
                f"unknown portfolio allocator {self.allocator!r}; "
                f"valid: {ALLOCATORS}")
        if self.flatline_waves < 0:
            raise ValueError("portfolio flatline_waves must be >= 0")
        if self.flatline_waves and self.allocator != "bandit":
            raise ValueError(
                "budget flow (flatline_waves > 0) needs the bandit "
                "allocator: rewards come from its pull traces")
        if self.flatline_eps < 0:
            raise ValueError("portfolio flatline_eps must be >= 0")
        if self.device_affinity is not None:
            if len(self.device_affinity) != len(self.backends):
                raise ValueError(
                    f"device_affinity length {len(self.device_affinity)} "
                    f"!= backend count {len(self.backends)}")
            if any(int(d) < 0 for d in self.device_affinity):
                raise ValueError("device_affinity slots must be >= 0")


def derived_seed(seed: int, backend_index: int, rung: int) -> int:
    """Per-(backend, pull) seed; primes keep distinct slots distinct."""
    return int(seed) + 7919 * (backend_index + 1) + 104_729 * rung


def _validate(settings: PortfolioSettings) -> None:
    if not settings.backends:
        raise ValueError("portfolio needs at least one constituent backend")
    if settings.allocator not in ALLOCATORS:
        raise ValueError(
            f"unknown portfolio allocator {settings.allocator!r}; "
            f"valid: {ALLOCATORS}")
    if settings.fidelity not in FIDELITIES:
        raise ValueError(
            f"unknown portfolio fidelity {settings.fidelity!r}; "
            f"valid: {FIDELITIES}")
    if settings.topk < 1:
        raise ValueError("portfolio topk must be >= 1")
    for name in settings.backends:
        b = get_backend(name)
        if b.composite:
            raise ValueError(
                f"portfolio constituent {name!r} is itself composite")
        if settings.allocator == "bandit" and not b.seed_free_run:
            # adaptive pulls reseed via per-job generators (per-job pull
            # counters diverge); a backend reading settings.seed inside
            # run() would silently replay its first pull instead
            raise ValueError(
                f"bandit allocator requires seed-free constituents; "
                f"{name!r} declares seed_free_run=False")


def _race_budget(settings: PortfolioSettings) -> int:
    return int(settings.total_evals * settings.race_fraction)


# --------------------------------------------------------------------- #
# fixed successive-halving schedule
# --------------------------------------------------------------------- #
def race_plan(settings: PortfolioSettings) -> list[dict]:
    """Per-rung ``{backend name: scaled settings}`` of the halving
    schedule.  Each rung splits an equal share of the race budget among
    that rung's survivor count (``ceil(n / 2**rung)``), so every surviving
    backend gets the same number of evaluations per rung regardless of
    which ones survived.  Rung 0 doubles as the bandit allocator's
    initialization pull (identical budget slice and derived seed)."""
    _validate(settings)
    n = len(settings.backends)
    race = _race_budget(settings)
    plans = []
    for r in range(settings.rungs):
        alive = max(1, -(-n // (2 ** r)))                # ceil(n / 2^r)
        per_backend = max(1, race // (settings.rungs * alive))
        rung = {}
        for b_idx, name in enumerate(settings.backends):
            b = get_backend(name)
            scaled = b.with_budget(b.default_settings(), per_backend)
            rung[name] = b.reseed(scaled,
                                  derived_seed(settings.seed, b_idx, r))
        plans.append(rung)
    return plans


def final_plan(settings: PortfolioSettings) -> dict:
    """``{backend name: settings}`` for the post-race exploitation phase
    (the remaining budget, spent entirely on each job's winner).  The
    final seed slot sits past every race pull's, so exploitation never
    replays a race run."""
    _validate(settings)
    remaining = max(1, settings.total_evals - _race_budget(settings))
    final_rung = settings.rungs if settings.allocator == "halving" \
        else bandit_rounds(settings) + 1
    out = {}
    for b_idx, name in enumerate(settings.backends):
        b = get_backend(name)
        scaled = b.with_budget(b.default_settings(), remaining)
        out[name] = b.reseed(
            scaled, derived_seed(settings.seed, b_idx, final_rung))
    return out


# --------------------------------------------------------------------- #
# bandit (UCB) schedule
# --------------------------------------------------------------------- #
def bandit_rounds(settings: PortfolioSettings) -> int:
    """Total race pulls per job: one initialization pull per backend plus
    ``n * (rungs - 1)`` adaptive pulls -- the same pull count (and hence
    the same per-pull budget) as halving's rung structure."""
    return len(settings.backends) * max(1, settings.rungs)


def bandit_slice(settings: PortfolioSettings) -> int:
    """Evaluation budget of ONE bandit pull; equals halving's rung-0
    per-backend slice, so the two allocators are eval-for-eval
    comparable (and the init pulls replay halving's rung 0)."""
    return max(1, _race_budget(settings) // bandit_rounds(settings))


def bandit_pull_plan(settings: PortfolioSettings, backend_index: int,
                     pull: int):
    """Scaled + reseeded settings of one backend's ``pull``-th race pull
    (pull 0 is the initialization pull == halving's rung 0 entry).
    Running a constituent standalone with this plan entry reproduces the
    portfolio's pull bit-for-bit."""
    _validate(settings)
    name = settings.backends[backend_index]
    b = get_backend(name)
    scaled = b.with_budget(b.default_settings(), bandit_slice(settings))
    return b.reseed(scaled, derived_seed(settings.seed, backend_index, pull))


def pull_reward(incumbent_before: float, trace: np.ndarray) -> float:
    """Reward of one pull: the normalized improvement it achieved.

    ``trace`` is the run's best-so-far trace (``[steps]``, the
    diagnostic every backend already returns); the run best is its min.
    The reference point is the job's incumbent before the pull, or the
    run's own starting best for initialization pulls (incumbent still
    inf).  Clipped to [0, 1] so one lucky pull cannot dominate the mean.
    """
    trace = np.asarray(trace, dtype=np.float64)
    run_best = float(np.min(trace))
    ref = float(incumbent_before)
    if not np.isfinite(ref):
        ref = float(trace.flat[0])
    gain = max(0.0, ref - run_best)
    return float(min(1.0, gain / (abs(ref) + 1e-30)))


def constituent_devices(settings: PortfolioSettings,
                        devices: list) -> list:
    """The race device each constituent backend runs on, as a list
    aligned with ``settings.backends``.  ``device_affinity`` pins
    constituents to explicit slots (e.g. SA on device 0, Sobol on device
    1); ``None`` keeps the historical round-robin over the visible race
    devices.  Either way slots wrap modulo ``len(devices)``, so a pinned
    settings object runs unchanged on any machine (device placement
    never feeds the RNG, so results are identical regardless)."""
    aff = settings.device_affinity
    if aff is None:
        return [devices[b % len(devices)]
                for b in range(len(settings.backends))]
    return [devices[int(slot) % len(devices)] for slot in aff]


def ucb_scores(mean_reward: np.ndarray, pulls: np.ndarray,
               c: float) -> np.ndarray:
    """Deterministic UCB index per (job, backend): ``mean + c *
    sqrt(ln(total pulls of the job) / pulls)``.  Unpulled arms score +inf
    so every backend is tried before any is repeated; ties resolve to the
    lower backend index via the caller's stable argmax."""
    mean_reward = np.asarray(mean_reward, dtype=np.float64)
    pulls = np.asarray(pulls, dtype=np.float64)
    total = pulls.sum(axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        bonus = c * np.sqrt(np.log(np.maximum(total, 1.0)) /
                            np.maximum(pulls, 1e-12))
    return np.where(pulls > 0, mean_reward + bonus, math.inf)


class PortfolioBackend(SearchBackend):
    """The composite racing backend registered as ``"portfolio"``."""

    name = "portfolio"
    settings_cls = PortfolioSettings
    composite = True

    def budget(self, settings: PortfolioSettings) -> int:
        """Total objective evaluations one portfolio run spends."""
        return settings.total_evals

    def with_budget(self, settings: PortfolioSettings, n_evals: int):
        """Settings rescaled to roughly ``n_evals`` total evaluations."""
        return dataclasses.replace(settings, total_evals=max(8, int(n_evals)))

    def run(self, objective_fn, mat, lens, bw, settings, generators):
        """Composite backends have no run of their own -- the engine
        races the constituents instead; calling this directly is an
        error."""
        raise NotImplementedError(
            "the portfolio is composite: the engine orchestrates it over "
            "the constituent backends' runs")


register_backend(PortfolioBackend())
