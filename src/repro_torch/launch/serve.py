"""Serving entry point: batched generation with the reduced or full config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --batch 4 --prompt-len 512 --new-tokens 32

runs on the card; ``--device cpu --smoke`` runs the reduced config on the
CPU; ``--mesh 1x1`` serves on a one-rank ("data", "model") ``DeviceMesh``
on ``--device``'s kind.  The prompts are seeded random token ids, as in
the reference.
"""
from __future__ import annotations

import argparse

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="serve on a (data, model) DeviceMesh of D x M ranks")
    args = ap.parse_args()

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import mesh_or_device
    from repro_torch.serve.engine import GenerationConfig, ServeEngine

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    engine = ServeEngine(cfg, mesh_or_device(args.mesh, args.device))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab, rng.integers(
        args.prompt_len // 2, args.prompt_len + 1)))
        for _ in range(args.batch)]
    out = engine.generate(prompts, GenerationConfig(
        max_new_tokens=args.new_tokens, temperature=args.temperature))
    print(f"prefill {out['prefill_s']*1e3:.1f} ms, "
          f"decode {out['decode_s']*1e3:.1f} ms, "
          f"{out['tokens_per_s']:.1f} tok/s")
    print("sampled tokens:\n", out["tokens"])


if __name__ == "__main__":
    main()
