"""The training driver: a cell of the port's ``Trainer`` on one card.

Set-up builds the trainer as ``Trainer(cfg, tcfg, "cuda", stream=...)``
with the benchmark's seeded stream, makes the weights from the seed on
the device (``weights.py``) in the layout of the port's trainable tree,
and the AdamW state by ``trainer.optimizer.init``.  Every step, in the
warm-up and in the window, does what ``Trainer.train`` does in one step
(``train/trainer.py``): ``next(it)`` on ``make_batch_iterator``,
``trainer.step_fn(params, opt, batch)``, then the loss, grad norm, lr and
``skipped`` flag read as Python values, with the trainer's two
synchronises (after the batch and after the loss).  No checkpoint, no
log.  A change to the trainer's loop needs this mirror changed with it.

The warm-up is the traffic's ``warmup_steps``; its first
``check_steps`` are the ones the reference follows: after step 1 the
first gradient is read from the optimizer's first moment, after the
last checked step each leaf's change from the initial weights (drawn
again).  The window then runs whole steps until ``--seconds`` have
passed; the rate is their tokens over the time from the window's start to
a synchronise after the last.  With ``--trace 1`` the profiler covers
:data:`TRACE_STEPS` steps after the window's first, and the window
holds at least one step after them.  Once the window has
closed and the peak memory is read, the program's state is freed and the
reference runs the checked steps.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import os
import tempfile
import time

from perfbench import check, harness, trace, weights
from perfbench.harness import Outcome, RunError
from perfbench.stream import ZipfStream

#: steps the profiler covers in a traced run, after the window's first
TRACE_STEPS = 3
OPTIMIZER_KEYS = ("peak_lr", "warmup_steps", "total_steps", "b1", "b2", "eps",
                  "weight_decay", "grad_clip")


def arch_config(cfg: dict):
    """The port's ``ArchConfig`` from a configuration file: its keys that
    are fields, lists as tuples."""
    from repro_torch.configs.base import ArchConfig

    names = {f.name for f in dataclasses.fields(ArchConfig)}
    return ArchConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in cfg.items() if k in names})


def build(cell, seed: int, device):
    """(trainer, params, opt_state, stream, leaves) of the cell, the
    weights drawn from ``seed``."""
    from repro_torch.models.transformer import ParamTree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg, tr = cell.config, cell.traffic
    stream = ZipfStream(seed, tr["seq_len"], tr["batch"], cfg["vocab"])
    opt = tr["optimizer"]
    tcfg = TrainerConfig(
        seq_len=tr["seq_len"], global_batch=tr["batch"], seed=seed,
        ckpt_dir=os.path.join(tempfile.gettempdir(), "perfbench-ckpt"),
        optimizer=AdamWConfig(**{k: opt[k] for k in OPTIMIZER_KEYS}))
    trainer = Trainer(arch_config(cfg), tcfg, str(device), stream=stream)
    leaves = weights.layout(cfg)
    program = [(n, tuple(p.shape)) for n, p in
               trainer.model.abstract_params(trainable=True).named_parameters()]
    if program != [(leaf.name, leaf.shape) for leaf in leaves]:
        raise RunError("the port's trainable tree is not the layout "
                       "weights.py works out for this configuration")
    params = ParamTree(weights.tree(leaves, weights.make(leaves, seed, device)),
                       trainable=True)
    return trainer, params, trainer.optimizer.init(params), stream, leaves


def one_step(trainer, params, opt, it, log: dict, sync):
    """One step as ``Trainer.train`` takes it, in the harness's spans."""
    from torch.autograd.profiler import record_function

    t0 = time.perf_counter()
    with record_function("train.data"):
        batch = next(it)
    t1 = time.perf_counter()
    with record_function("train.sync"):
        sync()
    with record_function("train.step"):
        params, opt, metrics = trainer.step_fn(params, opt, batch)
    with record_function("train.sync"):
        loss = float(metrics["loss"])
        sync()
        rec = {"loss": loss, "grad_norm": float(metrics["grad_norm"]),
               "lr": float(metrics["lr"]), "skipped": bool(metrics["skipped"])}
    log["data_s"].append(t1 - t0)
    log["step_s"].append(time.perf_counter() - t0)
    log["records"].append(rec)
    return params, opt


def warm_up(trainer, params, opt, it, leaves, seed: int, tr: dict, log: dict,
            sync) -> dict:
    """The warm-up steps; returns the program's readings for the check."""
    import torch

    b1 = tr["optimizer"]["b1"]
    if not 1 <= tr["check_steps"] <= tr["warmup_steps"]:
        raise RunError("the traffic's check_steps must lie within its "
                       "warmup_steps")
    prog = {}
    for s in range(tr["warmup_steps"]):
        params, opt = one_step(trainer, params, opt, it, log, sync)
        if s == 0:
            norms = torch.stack([torch.linalg.vector_norm(m)
                                 for m in opt["m"]])
            prog["first_grad"] = (norms / (1 - b1)).tolist()
        if s + 1 == tr["check_steps"]:
            sync()
            prog["change"] = weights.change_norms(
                leaves, list(params.parameters()), seed)
    prog["loss"] = [r["loss"] for r in log["records"][:tr["check_steps"]]]
    return prog


def measure(cell, args, t_start: float, device) -> tuple:
    """Set-up, warm-up and window on ``device``: (window record, program's
    readings, peak bytes, noise record, stream)."""
    import torch

    tr = cell.traffic
    cuda = device.type == "cuda"
    # the trainer's own: every card (one here)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    trainer, params, opt, stream, leaves = build(cell, args.seed, device)
    built_s = time.time() - t_start
    from repro_torch.data.pipeline import make_batch_iterator

    it = make_batch_iterator(stream, str(device))
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    log = {"data_s": [], "step_s": [], "records": []}
    try:
        prog = warm_up(trainer, params, opt, it, leaves, args.seed, tr, log,
                       sync)
        card_start = harness.card_sample() if cuda else None
        sync()
        setup_s = time.time() - t_start
        n0 = len(log["records"])
        t0 = time.perf_counter()
        traced, prof, after = None, None, None
        trace_steps = TRACE_STEPS if args.trace else 0
        while True:
            n = len(log["records"]) - n0
            if trace_steps and n == 1:
                prof, win = _start_trace(torch, sync)
            params, opt = one_step(trainer, params, opt, it, log, sync)
            n += 1
            if trace_steps and n == 1 + trace_steps:
                traced = _stop_trace(prof, win, sync)
                after = (n, time.perf_counter())
            # a traced run ends with one untraced step or more: the
            # model's share of the peak is read from them
            if time.perf_counter() - t0 >= args.seconds and \
                    (not trace_steps or (after and n > after[0])):
                break
        sync()
        t1 = time.perf_counter()
        card_end = harness.card_sample() if cuda else None
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    finally:
        it.close()
    harness.guard_modules()
    steps = len(log["records"]) - n0
    tokens = tr["seq_len"] * tr["batch"]
    window = {
        "steps": steps, "tokens": steps * tokens, "seconds": t1 - t0,
        "data_wait_s": log["data_s"][n0:], "setup_s": setup_s,
        # the steps after the traced stretch: the profiler off
        "untraced": None if after is None or after[0] == steps else
        {"tokens": (steps - after[0]) * tokens, "seconds": t1 - after[1]},
        "trace": traced, "traced_steps": trace_steps if traced else 0,
        "skipped": sum(r["skipped"] for r in log["records"]),
        "finite": all(math.isfinite(r["loss"]) for r in log["records"]),
        "attempted": len(log["records"]),
    }
    noise = {"card_start": card_start, "card_end": card_end,
             "step_s": log["step_s"][n0:], "warmup_step_s": log["step_s"][:n0],
             "data_wait_ms": 1e3 * sum(window["data_wait_s"]) / max(steps, 1),
             "setup_s": setup_s, "built_s": built_s, "window_s": t1 - t0}
    return window, prog, peak, noise, stream


def _start_trace(torch, sync):
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    sync()
    win = record_function(trace.WINDOW_SPAN)
    win.__enter__()
    return prof, win


def _stop_trace(prof, win, sync) -> trace.Summary:
    sync()
    win.__exit__(None, None, None)
    prof.stop()
    return trace.read_profile(prof)


def reference_check(cell, seed: int, stream, prog: dict, window: dict,
                    device) -> tuple:
    """The reference's checked steps from the same weights and batches,
    and the verdict: (correct, each compared number with its limit)."""
    from perfbench.reference import common

    tr = cell.traffic
    batches = [stream.global_batch_at(s) for s in range(tr["check_steps"])]
    ref = common.train_steps(cell.config, tr["optimizer"], batches, seed,
                             device, common.Precision("fp32"))
    sound = window["skipped"] == 0 and window["finite"]
    return check.verdict(check.numbers(prog, ref),
                         check.load_limits(cell.limits_path), sound)


def free_device() -> None:
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, args, t_start: float) -> Outcome:
    import torch

    device = torch.device("cuda")
    window, prog, peak, noise, stream = measure(cell, args, t_start, device)
    free_device()
    t = time.perf_counter()
    ok, compared = reference_check(cell, args.seed, stream, prog, window,
                                   device)
    noise["check_s"] = time.perf_counter() - t
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": 1, "memory_peak_bytes": peak}
    summary = window["trace"]
    breakdown = None
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": [list(x) for x in summary.device_ops],
                     "idle_gaps": [list(x) for x in summary.idle_gaps]}
        noise["idle_gaps"] = breakdown["idle_gaps"]
    return Outcome(
        end_to_end={
            "train_tokens_per_s": window["tokens"] / window["seconds"],
            "train_peak_mem_gib": peak / 2 ** 30,
            "setup_s": window["setup_s"]},
        record={"cell": cell, "window": window, "trace": summary,
                "card": noise["card_start"]},
        correct=ok, compared=compared, attempted=window["attempted"],
        failed=window["skipped"], device=device_info, noise=noise,
        breakdown=breakdown)
