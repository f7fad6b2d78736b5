"""The one-GPU cell report, the port's twin of the reference's
``launch/dryrun.py``.

For every (architecture x input shape) cell, from ``build_cell``'s
abstract arguments on a 1x1 abstract mesh at the shape's full size (meta
tensors: nothing is allocated), it records the bytes of the parameters,
the optimizer state and the gradients (train), the batch and the caches,
the cell's MODEL_FLOPS, whether that state fits the card, and the status
(``SKIP`` where ``cfg.skip_shapes`` names the shape).  With ``measure``
(``--measure``) and overrides that fit one card it then runs the cell's
step on a 1x1 ``DeviceMesh`` on the card and records its peak memory, its
step seconds, the kernels' launches a step and MODEL_FLOPS over the step
time over the card's bf16 peak.

The reference lowers and compiles each cell for a 256- or 512-chip mesh
and reads XLA's memory and cost analyses and the collectives of its HLO.
The port compiles no XLA program: it has no ``XLA_FLAGS``, no lower or
compile times, and no twin of ``hlo_analysis`` or ``collective_bytes``.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
        --set n_layers=8 --batch 1 --measure
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import statistics
import time

#: perf-variant switches for the hillclimb iterations (EXPERIMENTS Sec. Perf);
#: each maps to ArchConfig overrides so baseline-vs-variant is a pure A/B
VARIANTS: dict[str, dict] = {
    "moe-row": dict(moe_row_dispatch=True),
    "fsdp": dict(fsdp=True),
    "bf16p": dict(cast_params_bf16=True),
    "remat-dots": dict(remat_policy="dots"),
    "ssm-fused": dict(ssm_fused_coeffs=True),
    "ssm-chunk64": dict(ssm_chunk=64),
    "ssm-fused64": dict(ssm_fused_coeffs=True, ssm_chunk=64),
    "moe-row-bf16p": dict(moe_row_dispatch=True, cast_params_bf16=True),
    "moe-row-seqattn": dict(moe_row_dispatch=True, seq_shard_attn=True),
    "ssm-fused512": dict(ssm_fused_coeffs=True, ssm_chunk=512),
    "ssm-fused1024": dict(ssm_fused_coeffs=True, ssm_chunk=1024),
    "ssm-fused2048": dict(ssm_fused_coeffs=True, ssm_chunk=2048),
    "granite-opt": dict(moe_row_dispatch=True, seq_shard_attn=True,
                        fsdp=True),
    "yi-opt": dict(fsdp=True, cast_params_bf16=True),
    "yi-opt-dots": dict(fsdp=True, cast_params_bf16=True,
                        remat_policy="dots"),
    "ssm-full-opt": dict(ssm_fused_coeffs=True, ssm_chunk=64,
                         cast_params_bf16=True),
}

#: one H100 SXM's device memory (NVIDIA's data sheet), for the abstract
#: report where no card is asked about
H100_BYTES = 80 * 10 ** 9
#: the measured cell: warm-up steps (the first DTensor step fills the
#: sharding caches), then timed ones (enough that the fastest is the
#: step with the host out of its way)
MEASURE_WARMUP, MEASURE_STEPS = 2, 10


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree (a module, dicts, lists)."""
    import torch

    if isinstance(tree, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def cell_config(arch_id: str, shape_id: str, variant: str | None = None,
                overrides: dict | None = None):
    """(cfg, shape) of a cell: the arch with its variant and ``overrides``
    (ArchConfig fields; ``batch`` and ``seq`` set the shape's global batch
    and sequence length)."""
    from repro_torch.configs import SHAPES, get_arch

    cfg = get_arch(arch_id)
    if variant:
        cfg = dataclasses.replace(cfg, **VARIANTS[variant])
    overrides = dict(overrides or {})
    shape = SHAPES[shape_id]
    for key, field in (("batch", "global_batch"), ("seq", "seq_len")):
        if key in overrides:
            shape = dataclasses.replace(
                shape, **{field: int(overrides.pop(key))})
    return dataclasses.replace(cfg, **overrides), shape


def run_cell(arch_id: str, shape_id: str, *, variant: str | None = None,
             microbatches: int = 1, overrides: dict | None = None,
             measure: bool = False, device="cuda") -> dict:
    """The cell's report (see the module's docstring); ``measure`` runs
    its step on ``device`` (the card; ``cpu`` runs it on the CPU, where
    no time is a device time)."""
    import torch

    from repro_torch.launch.mesh import AXES, abstract_mesh
    from repro_torch.launch.roofline import PEAK_FLOPS, cell_flops
    from repro_torch.launch.steps import build_cell

    cfg, shape = cell_config(arch_id, shape_id, variant, overrides)
    rec: dict = {
        "arch": arch_id, "shape": shape_id, "mesh": "1x1",
        "variant": variant or "baseline",
        "overrides": dict(overrides or {}),
        "global_batch": shape.global_batch, "seq_len": shape.seq_len,
    }
    if shape_id in cfg.skip_shapes:
        rec["status"] = "SKIP"
        rec["reason"] = ("full-attention arch: 500k-token decode requires "
                         "sub-quadratic attention (DESIGN.md)")
        return rec

    _, args = build_cell(cfg, shape, abstract_mesh((1, 1), AXES),
                         microbatches=microbatches)
    rec["param_bytes"] = tree_bytes(args[0])
    rec["param_count"] = sum(p.numel() for p in args[0].parameters())
    if shape.kind == "train":
        rec["opt_bytes"] = tree_bytes(args[1])
        rec["grad_bytes"] = sum(p.numel() * 4 for p in args[0].parameters())
        rec["batch_bytes"] = tree_bytes(args[2])
        rec["cache_bytes"] = 0
    elif shape.kind == "prefill":
        from repro_torch.models import build_model
        rec["batch_bytes"] = tree_bytes(args[1])
        rec["cache_bytes"] = tree_bytes(build_model(cfg).abstract_cache(
            shape.global_batch, shape.seq_len))
    else:
        rec["cache_bytes"] = tree_bytes(args[1])
        rec["batch_bytes"] = tree_bytes(args[2])
    rec["state_bytes"] = sum(rec.get(k, 0) for k in (
        "param_bytes", "opt_bytes", "grad_bytes", "batch_bytes",
        "cache_bytes"))
    rec["model_flops"] = cell_flops(cfg, shape)
    on_card = torch.device(device).type == "cuda"
    if on_card and torch.cuda.is_available():
        rec["card_bytes"] = torch.cuda.get_device_properties(0).total_memory
        rec["card"] = torch.cuda.get_device_name(0)
    else:
        rec["card_bytes"], rec["card"] = H100_BYTES, "H100 data sheet"
    rec["fits"] = rec["state_bytes"] <= rec["card_bytes"]
    rec["status"] = "OK"
    if measure:
        rec["measured"] = measure_cell(cfg, shape, microbatches, device)
        if on_card:
            rec["measured"]["model_flops_share"] = (
                rec["model_flops"] / rec["measured"]["step_s"] / PEAK_FLOPS)
    return rec


def measure_cell(cfg, shape, microbatches: int, device) -> dict:
    """The cell's step on a 1x1 ``DeviceMesh`` on ``device``: peak memory
    over the state and the steps (on the card), the median and the fastest
    step seconds, the kernels' launches a step."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("--measure on the card: no CUDA card here")
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    mesh = make_debug_mesh(1, 1, device_type=dev.type)
    step, _ = build_cell(cfg, shape, mesh, microbatches=microbatches)
    model = step.model
    if cuda:
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        from repro_torch.optim import AdamW
        stream = SyntheticLMStream(DataConfig(
            seq_len=t, global_batch=b, vocab=cfg.vocab, seed=0,
            memory_tokens=cfg.n_memory, d_model=cfg.d_model))
        state = {"params": model.init(0, dev, trainable=True)}
        state["opt"] = AdamW().init(state["params"])

        def prep(i):
            return {k: torch.as_tensor(v).to(dev)
                    for k, v in stream.global_batch_at(i).items()}

        def one(batch):
            state["params"], state["opt"], m = step(
                state["params"], state["opt"], batch)
            return float(m["loss"])
    else:
        params = model.init(0, dev)
        tokens = torch.as_tensor(rng.integers(1, cfg.vocab, (b, t)),
                                 dtype=torch.int32, device=dev)
        caches = model.init_cache(b, t, dev) if shape.kind == "decode" \
            else None
        nxt = tokens[:, :1].contiguous()
        prep = lambda i: None

        def one(_):
            if caches is None:
                logits, _ = step(params, {"tokens": tokens})
            else:
                logits, _ = step(params, caches, nxt)
            return float(logits.to_local().float().abs().max())
    for i in range(MEASURE_WARMUP):
        one(prep(i))
    for w in {**ops.KERNEL_WRAPPERS, **ops.BACKWARD_WRAPPERS}.values():
        w.launches = 0
    secs = []
    for i in range(MEASURE_WARMUP, MEASURE_WARMUP + MEASURE_STEPS):
        batch = prep(i)                  # the step's batch, not timed
        sync()
        t0 = time.perf_counter()
        value = one(batch)
        sync()
        secs.append(time.perf_counter() - t0)
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "steps": MEASURE_STEPS, "step_s": statistics.median(secs),
           "step_s_min": min(secs),
           "step_s_all": secs, "last_value": value,
           "launches_per_step": {
               k: w.launches / MEASURE_STEPS for k, w in
               {**ops.KERNEL_WRAPPERS, **ops.BACKWARD_WRAPPERS}.items()
               if w.launches}}
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
    return out


def _literal(v: str):
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS),
                    help="ArchConfig perf-variant overrides")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation slices for train cells")
    ap.add_argument("--set", action="append", default=[],
                    help="ArchConfig override field=value")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch")
    ap.add_argument("--measure", action="store_true",
                    help="run the cell's step on the card")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=None,
                    help="also write each record to <dir>/<arch>_<shape>_"
                         "single[.variant].json")
    args = ap.parse_args()

    from repro_torch.configs import ARCH_IDS, SHAPES

    if not (args.all or args.arch):
        ap.error("--arch or --all")
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    overrides = {k: _literal(v) for k, v in
                 (ov.split("=", 1) for ov in args.set)}
    if args.batch is not None:
        overrides["batch"] = args.batch
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, variant=args.variant,
                           microbatches=args.microbatches,
                           overrides=overrides, measure=args.measure,
                           device=args.device)
            print(json.dumps(rec), flush=True)
            if args.out_dir:
                tag = "single" + (f".{args.variant}" if args.variant else "")
                with open(os.path.join(args.out_dir,
                                       f"{arch}_{shape}_{tag}.json"), "w") as f:
                    json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
