#!/usr/bin/env python3
"""Time the port's ``strategy_eval``, ``selective_scan`` and fp32
``cim_matmul`` and ``flash_attention`` kernels of one tree on one CUDA
card, so that two trees can be compared in one run.

    python3 scripts/kernel_times.py [--kernels strategy_eval selective_scan
                                     cim_matmul flash_attention]

It times the kernels of the ``repro_torch`` package under this checkout's
``src``.  To time another commit, unpack it (``git archive <commit> | tar
-x -C build/other``), copy this script and ``chip_smoke.py`` into that
tree (``scripts/`` and the root) and run it there.  Run the two trees in
turns (A, B, B, A) on one card and compare only within that session.

It uses only what every tree of the port has (``strategy_eval.launch``,
``ops.selective_scan``, the calibration microbench's cases) and the
helpers of ``chip_smoke.py``:

- ``strategy_eval`` at every launch shape of a Fig. 7 sweep, an SA job,
  an exhaustive bert-large job and the microbench, recorded untimed and
  then replayed on the first inputs of each shape in fp32 and fp64, per
  call and from a CUDA graph, with its registers, spills and
  ``MUFU.RCP`` count;
- ``selective_scan`` at the microbench's shapes and at falcon-mamba-7b
  width (1 x 2048 x 8192 x 16), fp32 and bf16, each checked against its
  plain version at ``chip_smoke.py``'s tolerance, per call and from a
  CUDA graph;
- ``cim_matmul`` and ``flash_attention`` in fp32 at the microbench's
  shapes (the calibration path's) and at full width (bert-large's FFN
  512 x 1024 x 4096 AF and PF; bert-large 16 x 512 x 512 x 64 and yi-6b
  32 x 4096 x 4096 x 128 causal attention), each checked against its plain
  version at ``chip_smoke.py``'s tolerance and timed per call and from a
  CUDA graph beside its library call (``chip_smoke.measure_case``).

The last line is a JSON record of every row.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts ROOT/src on the path)


def scan_row(torch, ref, fn, args, kwargs, label, card) -> dict:
    """One scan case against its plain version; its times and bound."""
    got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    atol, rtol = cs.tolerance("selective_scan", cs.dtype_of(args[0]), kwargs)
    err = cs.check_close(f"selective_scan {label}", got,
                         cs.plain_of(ref, "selective_scan", args, kwargs),
                         atol, rtol)
    del got
    call = lambda: fn(*args, **kwargs)
    ms, g_ms = cs.timed_ms(torch, call), cs.graph_ms(torch, call)
    b_ms, b_by = cs.kernel_bound_ms("selective_scan", args, kwargs)
    print(f"[selective_scan] {label}: {ms:.4f} ms per call, graph "
          + (f"{g_ms:.4f} ms" if g_ms is not None else "none")
          + f"; bound {b_ms:.4f} ms ({b_by}); max |kernel - plain| "
          f"{err:.3e} (atol {atol}, rtol {rtol}); {card}", flush=True)
    return dict(label=label, max_abs_err=err, ms=ms, graph_ms=g_ms,
                bound_ms=b_ms, bound_by=b_by)


#: what --kernels chooses from
KERNELS = ("strategy_eval", "selective_scan", "cim_matmul", "flash_attention")


def fp32_product_rows(torch, ref, ops, obs_profile, dev, card,
                      kernels) -> dict[str, list[dict]]:
    """The fp32 cim_matmul and flash_attention rows: the microbench's
    cases, then full width."""
    rng = np.random.default_rng(2)
    f32 = lambda *shape: torch.as_tensor(rng.standard_normal(shape),
                                         dtype=torch.float32, device=dev)
    cases = [(k, f"{fn.__bucket_fn__(*args, **kw)} {tiling} float32", fn,
              args, kw)
             for k, tiling, fn, args, kw in obs_profile._microbench_cases(
                 kernels, np.random.default_rng(0), dev)]
    if "cim_matmul" in kernels:
        a, b = f32(512, 1024), f32(1024, 4096)
        cases += [("cim_matmul", f"bert-large FFN 512x1024x4096 {t} float32",
                   ops.cim_matmul, (a, b), {"tiling": t}) for t in ("AF", "PF")]
    if "flash_attention" in kernels:
        for name, (bh, t, d, causal) in (("bert-large", (16, 512, 64, False)),
                                         ("yi-6b prefill",
                                          (32, 4096, 128, True))):
            cases.append(("flash_attention",
                          f"{name} {bh}x{t}x{t}x{d} causal={causal} float32",
                          ops.flash_attention,
                          tuple(f32(bh, t, d) for _ in range(3)),
                          {"causal": causal}))
    rows: dict[str, list[dict]] = {k: [] for k in kernels}
    for kernel, label, fn, args, kw in cases:
        rows[kernel].append(cs.measure_case(torch, ref, kernel, fn, args, kw,
                                            label, card))
    return rows


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", nargs="+", choices=KERNELS,
                        default=list(KERNELS))
    kernels = parser.parse_args().kernels
    if not torch.cuda.is_available():
        cs.fail("no CUDA card: torch.cuda.is_available() is false")
    from repro_torch import core as port_core
    from repro_torch.core import cost_model
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cim_matmul as cm_k
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import selective_scan as ss_k
    from repro_torch.kernels import strategy_eval as se
    from repro_torch.obs import profile as obs_profile

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    print(card)
    out: dict = {}
    products = tuple(k for k in ("cim_matmul", "flash_attention")
                     if k in kernels)
    if products:
        t0 = time.perf_counter()
        mods = {"cim_matmul": cm_k, "flash_attention": fa_k}
        with concurrent.futures.ThreadPoolExecutor(len(products)) as pool:
            for fut in [pool.submit(build.build, mods[k].SOURCE,
                                    mods[k].NVCC_FLAGS) for k in products]:
                fut.result()
        print(f"[build] {', '.join(products)} of {ROOT / 'src'} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        out.update(fp32_product_rows(torch, ref, ops, obs_profile, dev, card,
                                     products))
    if {"strategy_eval", "selective_scan"} & set(kernels):
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            scan_lib = pool.submit(build.build, ss_k.SOURCE, ss_k.NVCC_FLAGS)
            se.build()
            scan_lib.result()
        print(f"[build] strategy_eval and selective_scan of {ROOT / 'src'} "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)

    if "strategy_eval" in kernels:
        jobs, _ = cs.fig7_jobs(port_core)
        macro = port_core.get_macro("vanilla-dcim")
        wl = port_core.bert_large_workload()
        with cs.LaunchShapes(se) as shapes:
            port_core.ExplorationEngine(device="cuda").run(
                jobs, method="exhaustive")
            port_core.co_explore(macro, wl, cs.FIG7_BUDGET_MM2)
            port_core.co_explore(macro, wl, cs.FIG7_BUDGET_MM2,
                                 method="exhaustive")
            obs_profile.run_microbench(kernels=("strategy_eval",))
            torch.cuda.synchronize()
        # the microbench turns profiling on, which synchronises every
        # wrapper call, and no CUDA graph can capture a synchronising call
        os.environ.pop(obs_profile.PROFILE_ENV, None)
        out["strategy_eval"] = cs.strategy_eval_rows(
            torch, se, ref, cost_model, shapes,
            cs.se_instantiations(build, se), card, set(shapes.counts))

    if "selective_scan" in kernels:
        on_card = lambda x, dtype=torch.float32: torch.as_tensor(
            np.asarray(x, np.float32)).to(dev).to(dtype)
        cases = []
        for dtype in (torch.float32, torch.bfloat16):
            for _, tiling, fn, args, kw in obs_profile._microbench_cases(
                    ("selective_scan",), np.random.default_rng(0), dev):
                args = tuple(x.to(dtype) for x in args[:4]) + args[4:]
                cases.append(scan_row(
                    torch, ref, fn, args, kw,
                    f"{fn.__bucket_fn__(*args, **kw)} {tiling} "
                    f"{cs.dtype_of(args[0])}", card))
            args = cs.falcon_scan_args(np.random.default_rng(1), on_card,
                                       dtype, dev)
            cases.append(scan_row(torch, ref, ops.selective_scan, args,
                                  cs.FALCON_TILING,
                                  f"falcon-mamba-7b {cs.dtype_of(args[0])}",
                                  card))
            del args
        out["selective_scan"] = cases
    print(json.dumps(out))


if __name__ == "__main__":
    main()
