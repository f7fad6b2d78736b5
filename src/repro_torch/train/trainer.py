"""Training loop: eager step through the hand-written kernels,
checkpoint/restart, NaN guard, straggler telemetry -- the reference's
``train/trainer.py`` in PyTorch, on a mesh or one device.

Fault-tolerance model (the reference's):
  * checkpoint every ``ckpt_every`` steps (and at the end) through the
    atomic CheckpointManager; on (re)start the trainer restores the newest
    checkpoint -- a preempted run simply relaunches the same command (the
    data pipeline is stateless-by-step so batches resume bit-exact);
  * NaN guard: a step whose grad-norm is non-finite is *skipped* (params
    and optimizer state are left as they were: the norm is checked before
    the in-place update) -- a single corrupt batch cannot poison the run;
  * straggler telemetry: per-step wall times keep an EWMA; steps slower
    than ``straggler_factor`` x EWMA are counted.
Given a ``DeviceMesh`` (``launch.mesh``), the parameters and AdamW state
are DTensors placed by the sharding rules, the batches are sharded over
the data axes, the step is ``build_cell``'s, and a restore is placed by
the rules on whatever mesh the relaunch has.  Given a device (``"cuda"``,
``"cpu"``), it trains there without DTensors, as before there was a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       make_batch_iterator)
from repro_torch.launch.mesh import is_mesh
from repro_torch.launch.steps import make_train_step, on_mesh
from repro_torch.models import sharding as sh
from repro_torch.models.model import build_model
from repro_torch.optim import AdamW, AdamWConfig
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    ckpt_every: int = 50
    ckpt_dir: str = "checkpoints"
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    straggler_factor: float = 2.0
    optimizer: AdamWConfig = AdamWConfig()


def _nan_guarded(step_fn):
    """Skip the update when the grad norm is non-finite: ``step_fn``
    (``make_train_step``'s) checks the norm before its in-place update and
    leaves params and optimizer state untouched; ``metrics["skipped"]``
    says so."""
    def guarded(params, opt_state, batch):
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             skip_nonfinite=True)
        return params, opt_state, sh.gather(metrics)
    return guarded


class Trainer:
    def __init__(self, cfg: ArchConfig, tcfg: TrainerConfig, mesh="cuda",
                 stream=None):
        """A trainer on ``mesh``: a ``DeviceMesh``, or a device (the card
        unless the caller asks for the CPU)."""
        self.cfg, self.tcfg = cfg, tcfg
        self.mesh = mesh if is_mesh(mesh) else None
        self.device = torch.device(mesh.device_type if self.mesh else mesh)
        self.model = build_model(cfg, shard_act=sh.make_shard_act(self.mesh))
        self.optimizer = AdamW(tcfg.optimizer)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.ckpt_keep)
        self.stream = stream or SyntheticLMStream(DataConfig(
            seq_len=tcfg.seq_len, global_batch=tcfg.global_batch,
            vocab=cfg.vocab, seed=tcfg.seed,
            memory_tokens=cfg.n_memory, d_model=cfg.d_model))
        self.step_fn = _nan_guarded(on_mesh(
            make_train_step(self.model, self.optimizer), self.mesh))
        self.history: list[dict] = []
        self.straggler_steps = 0

    # ------------------------------------------------------------------ #
    def _place(self, params):
        if self.mesh is None:
            return params
        return sh.distribute(params, sh.param_shardings(
            self.cfg, params, self.mesh), self.mesh)

    def init_state(self):
        params = self._place(self.model.init(self.tcfg.seed, self.device,
                                             trainable=True))
        return params, self.optimizer.init(params), 0

    def restore_or_init(self):
        params, opt, step = self.init_state()
        if self.ckpt.latest_step() is not None:
            (params, opt), step = self.ckpt.restore((params, opt))
        return params, opt, step

    # ------------------------------------------------------------------ #
    def train(self, log: Callable[[str], None] = print):
        tc = self.tcfg
        params, opt, start = self.restore_or_init()
        it = make_batch_iterator(self.stream, self.mesh or self.device,
                                 start_step=start)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else \
            (lambda: None)
        ewma = None
        try:
            for step in range(start, tc.steps):
                batch = next(it)
                sync()
                t0 = time.perf_counter()
                params, opt, metrics = self.step_fn(params, opt, batch)
                loss = float(metrics["loss"])   # waits for the step
                sync()
                dt = time.perf_counter() - t0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > tc.straggler_factor * ewma and step > start + 3:
                    self.straggler_steps += 1
                rec = {"step": step + 1, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "lr": float(metrics["lr"]),
                       "skipped": bool(metrics["skipped"]),
                       "sec_per_step": dt}
                self.history.append(rec)
                if (step + 1) % tc.log_every == 0 or step == start:
                    log(f"step {rec['step']:5d} loss {loss:8.4f} "
                        f"gnorm {rec['grad_norm']:8.3f} lr {rec['lr']:.2e} "
                        f"{dt*1e3:7.1f} ms"
                        + (" [SKIPPED:nan]" if rec["skipped"] else ""))
                if (step + 1) % tc.ckpt_every == 0 or step + 1 == tc.steps:
                    path = self.ckpt.save(step + 1, (params, opt))
                    log(f"checkpoint @ {path}")
        finally:
            # close the generator so its producer thread stops now --
            # leaked producers otherwise keep allocating batches forever
            it.close()
        return params, opt
