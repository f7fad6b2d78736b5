"""CPU rehearsal of the bar of ``chip_smoke.py``'s phase 15.b: one
training step of the kernel path against the plain twins on the same
weights and batch.

On the CPU the two autograd Functions (``ops.FlashAttention``,
``ops.SelectiveScan``) run their plain route: fp32 attention and the
fp32 step-by-step scan, differentiated by autograd.  Routed through
``flash_prefill`` / ``kernel_scan`` they stand in for the kernels, and the
plain twins (``layers.attention_any``, ``ssm.plain_scan``, the reference's
branches) are what phase 15 holds them against.  Eight layers of yi-6b
(d 512, head 64) and of falcon-mamba-7b (d_inner 512), 512 tokens, two
seeds; prints ``chip_smoke.grad_gaps`` for each (the falcon runs take
some six minutes each: the plain scan is a Python loop over time).

    PYTHONPATH=src python scripts/train_gap_rehearsal.py
"""
import dataclasses
import functools
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       SyntheticLMStream)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model, layers, ssm  # noqa: E402

CASES = (("yi-6b", dict(head_dim=64, n_layers=8, d_model=512, n_heads=8,
                        n_kv_heads=2, d_ff=1024)),
         ("falcon-mamba-7b", dict(n_layers=8, d_model=256, d_inner=512)))
TOKENS = 512


def main() -> None:
    for arch, widths in CASES:
        cfg = dataclasses.replace(get_arch(arch).reduced(), **widths)
        route = {"attention": functools.partial(
            layers.flash_prefill, kernel=lambda q, k, v, causal:
            ops.FlashAttention.apply(q, k, v, causal))} \
            if arch == "yi-6b" else {"scan": functools.partial(
                ssm.kernel_scan, kernel=ops.SelectiveScan.apply)}
        model = build_model(cfg, **route)
        plain = build_model(cfg, attention=layers.attention_any,
                            scan=ssm.plain_scan)
        for seed in (0, 1):
            params = model.init(seed, "cpu", trainable=True)
            batch = SyntheticLMStream(DataConfig(
                seq_len=TOKENS, global_batch=1, vocab=cfg.vocab,
                seed=seed)).global_batch_at(0)
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            t0 = time.perf_counter()
            gap = chip_smoke.grad_gaps(
                params, chip_smoke.step_grads(model, params, batch),
                chip_smoke.step_grads(plain, params, batch))
            print(f"{arch} seed {seed}: {gap} "
                  f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)


if __name__ == "__main__":
    main()
