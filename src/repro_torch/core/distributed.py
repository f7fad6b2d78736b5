"""Multi-device distributed hardware-mapping co-exploration.

The paper runs its simulated annealing on a single host.  The reference
shards the chain population over a JAX mesh with ``shard_map``; the port
keeps its semantics with one controller: the *mesh* is a sequence of
``torch.device`` slots (repeats allowed, so one card or the CPU can hold
2 or 4 slots), and the population is the *job x chain* grid of the
batched exploration engine (``core/engine.py``).  Every slot anneals a
local ``[jobs, chains_per_device]`` block -- each step one call of the
engine's evaluator on that block, i.e. one ``strategy_eval`` launch per
slot per step on the card -- and every ``sync_every`` steps the per-job
incumbent best (value + config) is exchanged across slots with the
reference's ``pmin`` / ``psum`` rule; each slot then re-seeds its worst
chain of each job with that job's global best (exploit) while the rest keep
exploring.  Steps advance slot by slot, so slots on different cards
overlap.

Randomness: the initial population comes from
``np.random.default_rng(settings.seed)``, as in the reference, so it is
equal bit for bit.  Each chain carries an int64 seed (the reference's
per-chain PRNG key); in each round a chain draws its uniforms from a
``torch.Generator`` seeded from its seed folded with 1, and the seed then
advances by folding with 2 (the reference's ``fold_in(key, 1)`` /
``fold_in(key, 2)``).  The draws are made on the host, so placement never
feeds them, and they differ from JAX's threefry streams: the port is held
to the reference on outcome.

Production concerns handled here:
  * fault tolerance -- search state (chain indices, job ids, chain seeds,
    round) checkpoints to an .npz after every round, written to a
    temporary file and moved into place; ``resume=True`` restarts from the
    latest checkpoint after a failure.  The port's checkpoint also holds
    each chain's current value and best (so a resumed run continues the
    uninterrupted one exactly) and its seeds are not JAX keys: it cannot
    be swapped with the reference's;
  * elasticity -- on resume the per-job population is re-tiled to whatever
    slot count the new mesh has (chains are embarrassingly parallel);
  * stragglers -- rounds are fixed-work (``sync_every`` steps), so a slow
    slot delays at most one exchange.

:func:`race_devices` additionally serves the engine's portfolio racer:
when several devices of the engine's kind are listed, portfolio race waves
place their constituent backends round-robin across them.
"""
from __future__ import annotations

import dataclasses
import os
import typing

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.annealing import (SASettings, _axes_matrix,
                                        make_chain_keys, sa_step)
from repro_torch.core.calibration import TechConstants, resolve_tech
from repro_torch.core.engine import ExploreJob, _pow2_at_least, resolve_device
from repro_torch.core.ir import Workload
from repro_torch.core.macro import MacroSpec
from repro_torch.core.pruning import DesignSpace
from repro_torch.core.template import AcceleratorConfig
from repro_torch.kernels import ops
from repro_torch.search.base import cfg_from_indices

__all__ = [
    "DistributedResult",
    "distributed_co_explore",
    "distributed_co_explore_jobs",
    "exchange",
    "race_devices",
]

#: checkpoint fields beyond the reference's (idx, keys, job_id, round,
#: trace): each chain's current value and its best so far
_CONTINUITY = ("val", "best_idx", "best_val")


@dataclasses.dataclass
class DistributedResult:
    config: AcceleratorConfig
    best_value: float
    rounds: int
    n_chains: int
    trace: list[float]


def race_devices() -> list[torch.device]:
    """Visible CUDA devices the engine's portfolio racer places
    constituent backends across (``ExplorationEngine._run_portfolio_batch``
    launches each race wave's runs, one backend per device, before it
    reads any, and folds the wave's results into per-job incumbents -- the
    host-side analogue of this module's per-round best exchange).  A
    1-device list makes the engine use its one device.

    ``CIM_TUNER_RACE_DEVICES="0,2"`` restricts (and orders) the raced
    devices by index -- the process-level complement of
    ``PortfolioSettings.device_affinity``, which pins each constituent to
    a slot *within* this list.  Placement never feeds the generators, so
    any subset produces bit-identical results."""
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    spec = os.environ.get("CIM_TUNER_RACE_DEVICES", "").strip()
    if spec:
        try:
            slots = [int(x) for x in spec.split(",") if x.strip()]
        except ValueError as exc:
            raise ValueError(
                f"CIM_TUNER_RACE_DEVICES must be comma-separated device "
                f"indices, got {spec!r}") from exc
        if devs:
            devs = [devs[s % len(devs)] for s in slots] or devs
    return devs


def _fold_in(keys: np.ndarray, data: int) -> np.ndarray:
    """Per-chain seeds mixed with ``data`` (splitmix64), as non-negative
    int64 -- the counterpart of ``jax.random.fold_in``."""
    z = keys.astype(np.uint64) + np.full(keys.shape, data, np.uint64) \
        * np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(1)).astype(np.int64)


def _round_draws(keys: np.ndarray, steps: int) -> torch.Tensor:
    """[n_chains, steps, 5] float64 uniforms of one round, each chain's
    from a CPU generator seeded from its seed folded with 1."""
    out = torch.empty((len(keys), steps, 5), dtype=torch.float64)
    gen = torch.Generator()
    for c, seed in enumerate(_fold_in(keys, 1)):
        gen.manual_seed(int(seed))
        torch.rand((steps, 5), generator=gen, dtype=torch.float64,
                   out=out[c])
    return out


def exchange(best_val: np.ndarray, best_idx: np.ndarray,
             val: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The reference's per-job best exchange over slots.

    ``best_val``, ``val`` [D, J, c] and ``best_idx`` [D, J, c, 5] are the
    slots' blocks.  Per job: each slot's local best (first index on ties),
    ``g_best`` the min over slots (``pmin``), ``winner`` the slots whose
    local best equals it, and ``g_idx`` the integer mean of the winners'
    configs (``psum(contrib) // max(n_win, 1)``; with one winner its
    config).  Returns ``(g_best [J], g_idx [J, 5], worst [D, J])``,
    ``worst`` each slot's chain of largest current value (first on ties),
    which the caller re-seeds with ``(g_idx, g_best)``."""
    local_best = best_val.min(axis=2)                            # [D, J]
    local_arg = best_val.argmin(axis=2)                          # [D, J]
    g_best = local_best.min(axis=0)                              # [J]
    winner = (local_best <= g_best).astype(np.int64)             # [D, J]
    arg_idx = np.take_along_axis(
        best_idx, local_arg[..., None, None], axis=2)[:, :, 0]   # [D, J, 5]
    contrib = arg_idx.astype(np.int64) * winner[..., None]
    n_win = winner.sum(axis=0)                                   # [J]
    g_idx = contrib.sum(axis=0) // np.maximum(n_win, 1)[:, None]
    return g_best, g_idx, val.argmax(axis=2)


def _resolve_mesh(mesh) -> list[torch.device]:
    slots = [resolve_device("cuda")] if mesh is None else \
        [resolve_device(d) for d in mesh]
    if not slots:
        raise ValueError("empty mesh")
    return slots


def distributed_co_explore_jobs(
    mesh,
    jobs: typing.Sequence[ExploreJob],
    settings: SASettings = SASettings(),
    chains_per_device: int = 4,          # chains per job per slot
    rounds: int = 8,
    sync_every: int = 50,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    *,
    dtype: torch.dtype = torch.float32,
    evaluator=None,
) -> list[DistributedResult]:
    """Anneal the full job x chain population of a job batch over a mesh.

    ``mesh`` is a sequence of devices, one slot each (``None``: one slot
    on the card; a ``cuda`` slot without a card raises).  Every slot
    holds ``chains_per_device`` chains of every job, so the per-job
    exchange (best exchange / worst re-seed) always has local members;
    elastic resume re-tiles each job's chains to the new mesh.
    ``evaluator`` is the batched objective (``kernels.ops.job_objective``
    unless given, e.g. its plain version ``kernels.ref.job_objective_ref``).
    """
    n_jobs = len(jobs)
    if n_jobs == 0:
        raise ValueError("empty job list")
    slots = _resolve_mesh(mesh)
    evaluator = evaluator or ops.job_objective

    # ---- per-job data (shared-shape padding, as in the engine) ----
    ops_pad = _pow2_at_least(max(len(job.merged_workload().ops)
                                 for job in jobs))
    axes = [_axes_matrix(job.design_space()) for job in jobs]
    lmax = max(m.shape[1] for m, _ in axes)
    mats = np.stack([
        np.concatenate([m, np.repeat(m[:, -1:], lmax - m.shape[1], axis=1)],
                       axis=1)
        for m, _ in axes])                                    # [J, 5, L]
    lens = np.stack([ln for _, ln in axes])                   # [J, 5]
    rows = [cost_model.job_params_np(
        job.merged_workload().as_arrays(pad_to=ops_pad), job.macro, job.tech,
        job.objective, job.strategy_set, job.area_budget_mm2, job.bw)
        for job in jobs]

    n_dev = len(slots)
    local = n_jobs * chains_per_device                 # chains per slot
    n_chains = n_dev * local                           # total population
    job_id = np.tile(np.repeat(np.arange(n_jobs), chains_per_device), n_dev)

    # ---- init population (possibly from a checkpoint; re-tiled if the
    # mesh size changed = elastic resume) ----
    start_round = 0
    rng = np.random.default_rng(settings.seed)
    state = {"idx": rng.integers(
        0, lens[job_id], size=(n_chains, 5)).astype(np.int32)}
    state["keys"] = make_chain_keys(
        dataclasses.replace(settings, n_chains=n_chains))
    trace: list[np.ndarray] = []
    ckpt_path = (
        os.path.join(checkpoint_dir, "dse_state.npz") if checkpoint_dir
        else None
    )
    if resume and ckpt_path and os.path.exists(ckpt_path):
        with np.load(ckpt_path) as st:
            if st["keys"].ndim != 1:
                raise ValueError(
                    f"{ckpt_path} holds JAX keys, not the port's per-chain "
                    "seeds: it was written by the reference package")
            # legacy (pre-batch) checkpoints carry no job axis: all job 0
            old_job = (st["job_id"] if "job_id" in st.files
                       else np.zeros(len(st["idx"]), dtype=np.int64))
            fields = ["idx", "keys"]
            if all(f in st.files for f in _CONTINUITY) and all(
                    (old_job == j).any() for j in range(n_jobs)):
                fields += _CONTINUITY
                state.update(val=np.zeros(n_chains), best_val=np.zeros(
                    n_chains), best_idx=np.zeros((n_chains, 5), np.int64))
            for j in range(n_jobs):
                sel = np.flatnonzero(old_job == j)
                if len(sel) == 0:
                    continue
                mine = np.flatnonzero(job_id == j)
                reps = -(-len(mine) // len(sel))
                for f in fields:
                    tiled = np.tile(st[f][sel], (reps,) + (1,) * (
                        st[f].ndim - 1))
                    state[f][mine] = tiled[: len(mine)]
            start_round = int(st["round"])
            trace = list(np.asarray(st["trace"]).reshape(-1, n_jobs))

    # ---- per-slot blocks [J, chains_per_device, ...] ----
    block = lambda a, d: a.reshape(n_dev, n_jobs, chains_per_device,
                                   *a.shape[1:])[d]
    on_dev: dict[str, tuple] = {}       # repeated slots share their copies
    for dev in slots:
        if str(dev) not in on_dev:
            on_dev[str(dev)] = (
                cost_model.stack_job_params(rows, dtype, dev),
                torch.as_tensor(mats, dtype=dtype).to(dev),
                torch.as_tensor(lens, dtype=torch.long, device=dev))
    job_of, mat_of, lens_of = zip(*[on_dev[str(dev)] for dev in slots])
    objective = [
        (lambda cfg, job=job: evaluator(job, cfg.contiguous()))
        for job in job_of]

    blocks = []                     # per slot: [idx, val, best_idx, best_val]
    for d, dev in enumerate(slots):
        idx = torch.as_tensor(block(state["idx"], d), dtype=torch.long,
                              device=dev)
        if "val" in state:
            val = torch.as_tensor(block(state["val"], d), dtype=dtype,
                                  device=dev)
            best = [torch.as_tensor(block(state["best_idx"], d),
                                    dtype=torch.long, device=dev),
                    torch.as_tensor(block(state["best_val"], d),
                                    dtype=dtype, device=dev)]
        else:
            val = objective[d](cfg_from_indices(mat_of[d], idx,
                                                job_of[d].bw))
            best = [idx, val]
        blocks.append([idx, val, *best])
    keys = state["keys"]

    for r in range(start_round, rounds):
        temps = settings.t0 * (0.5 ** r) * settings.alpha ** np.arange(
            sync_every)
        draws = _round_draws(keys, sync_every).reshape(
            n_dev, n_jobs, chains_per_device, sync_every, 5)
        u_of = [draws[d].permute(2, 0, 1, 3).contiguous().to(dev)
                for d, dev in enumerate(slots)]              # [steps, J, c, 5]
        for t in range(sync_every):
            for d in range(n_dev):
                blocks[d] = list(sa_step(
                    objective[d], mat_of[d], lens_of[d], job_of[d].bw,
                    tuple(blocks[d]), u_of[d][t], float(temps[t]),
                    settings.jump_prob))

        # ---- per-job global best exchange, re-seed each slot's worst ----
        g_best, g_idx, worst = exchange(*(
            np.stack([b[i].cpu().numpy() for b in blocks])
            for i in (3, 2, 1)))
        jx = torch.arange(n_jobs)
        for d, dev in enumerate(slots):
            idx, val = blocks[d][0].clone(), blocks[d][1].clone()
            w = torch.as_tensor(worst[d])
            idx[jx.to(dev), w.to(dev)] = torch.as_tensor(g_idx).to(dev)
            val[jx.to(dev), w.to(dev)] = torch.as_tensor(
                g_best, dtype=dtype).to(dev)
            blocks[d][0], blocks[d][1] = idx, val
        keys = _fold_in(keys, 2)
        trace.append(np.asarray(g_best))
        if ckpt_path:
            flat = lambda i: np.concatenate(
                [b[i].cpu().numpy().reshape(local, *b[i].shape[2:])
                 for b in blocks])
            os.makedirs(checkpoint_dir, exist_ok=True)
            tmp = ckpt_path + ".tmp.npz"
            np.savez(
                tmp, idx=flat(0).astype(np.int32), keys=keys,
                job_id=job_id, round=r + 1, trace=np.asarray(trace),
                val=flat(1), best_idx=flat(2), best_val=flat(3),
            )
            os.replace(tmp, ckpt_path)

    bv = np.concatenate([b[3].cpu().numpy().reshape(local) for b in blocks])
    bi = np.concatenate([b[2].cpu().numpy().reshape(local, 5)
                         for b in blocks])
    results = []
    for j, job in enumerate(jobs):
        mine = np.flatnonzero(job_id == j)
        w = mine[int(np.argmin(bv[mine]))]
        cfg_vals = mats[j][np.arange(5), bi[w]]
        cfg = AcceleratorConfig(
            *[int(round(v)) for v in cfg_vals], bw=job.bw)
        results.append(DistributedResult(
            config=cfg,
            best_value=float(bv[w]),
            rounds=rounds,
            n_chains=len(mine),
            trace=[float(row[j]) for row in trace],
        ))
    return results


def distributed_co_explore(
    mesh,
    macro: MacroSpec,
    workload: Workload,
    area_budget_mm2: float,
    objective: str = "ee",
    strategy_set: str = "st",
    space: DesignSpace | None = None,
    bw: int = 256,
    tech: TechConstants | None = None,
    settings: SASettings = SASettings(),
    chains_per_device: int = 4,
    rounds: int = 8,
    sync_every: int = 50,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    *,
    dtype: torch.dtype = torch.float32,
    evaluator=None,
) -> DistributedResult:
    """Single-job distributed DSE (a job x chain population of one job)."""
    tech = resolve_tech(tech)
    job = ExploreJob(
        macro=macro, workload=workload, area_budget_mm2=area_budget_mm2,
        objective=objective, strategy_set=strategy_set, bw=bw, tech=tech,
        space=space,
    )
    return distributed_co_explore_jobs(
        mesh, [job], settings=settings,
        chains_per_device=chains_per_device, rounds=rounds,
        sync_every=sync_every, checkpoint_dir=checkpoint_dir,
        resume=resume, dtype=dtype, evaluator=evaluator,
    )[0]
