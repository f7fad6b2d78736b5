#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port of CIM-Tuner on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
of which fails the run when it fails:

1. device  -- a CUDA card must be present; print its name and power limit;
2. build   -- build the ``strategy_eval`` kernel from the checkout's source
   (and, beside it, a variant built with FMA contraction, timed only to
   price ``-fmad=false``); print the compiler's register/spill report;
3. kernel  -- the kernel against its plain PyTorch version on the card, on
   the 28 Fig. 7 jobs over the raw, unpruned 30,492-point design space
   (so the INFEASIBLE and area-penalty branches run): fp32 at rtol 1e-5,
   fp64 at rtol 1e-12, identical per-operator argmins in both;
4. main path -- ``ExplorationEngine(device="cuda").run(fig7_jobs,
   method="exhaustive")`` through the kernel (launch counts reset just
   before, read just after), its 28 winners against the same sweep with
   the plain version on the card, the ST/SO gains, and the times;
5. Table II -- ``evaluate_config`` and ``co_explore(method="exhaustive")``
   on the TranCIM and TP-DCIM baselines at their published areas;
6. SA -- ``co_explore(macro, bert_large_workload(), 5.0)`` with its
   defaults (simulated annealing, one kernel launch per step), within 1 %
   of the exhaustive bert-large energy of phase 4;
7. build    -- the ``cim_matmul``, ``flash_attention`` and
   ``selective_scan`` libraries (their nvcc runs start in phase 2, beside
   the strategy_eval build); print each compiler report;
8. kernels  -- each against its plain version on the card, at the shapes
   of tests/test_kernels.py, at the calibration microbench's shapes and at
   full width (bert-large's FFN matmul, bert-large and yi-6b attention,
   the falcon-mamba-7b scan), fp32 and bf16, each with its stated
   tolerance; timed with CUDA events beside its plain version, its bound
   and, where one PyTorch call computes the same function, that call
   (timed as a yardstick only); AF's bf16 error <= PF's;
9. calibrate -- ``python -m repro_torch.service calibrate --json -o
   build/repro_torch/calibration.json`` in a subprocess, then the same
   path in-process (``run_microbench`` -> ``fit_report`` +
   ``fit_corrections`` -> ``save_calibration``) with the launch counts
   reset just before and read just after (every kernel > 0); the two
   agree on records and refit; the CLI's artifact pinned through
   ``CIM_TUNER_CALIBRATION`` drives ``default_cost_model()`` and a
   calibrated bert-large exhaustive ``co_explore`` on the card, which
   must equal the same job with the plain versions and carry its own
   job key.

The second-to-last line is a JSON record of the kernels (launches, error,
times, bound); the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import cProfile
import concurrent.futures
import ctypes
import json
import math
import os
import pstats
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: the seven Fig. 7 networks (bert-large + six architectures' operator mixes)
FIG7_NETWORKS = (
    "bert-large", "yi-6b", "gemma-7b", "falcon-mamba-7b",
    "granite-moe-3b-a800m", "mixtral-8x7b", "whisper-small",
)
FIG7_BUDGET_MM2 = 5.0
PAPER_GAINS = {"ee": 1.58, "th": 2.11}       # paper Fig. 7 geomeans

#: published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): fp32 and
#: fp64 outside the tensor cores (an FMA counts as two operations), HBM
FP_PEAK = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12
#: the peak for a matrix product's operations in each input type: bf16 on
#: the tensor cores, fp32 outside them (the port keeps fp32 out of TF32)
PRODUCT_PEAK = {"float32": 67e12, "bfloat16": 989e12}

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/strategy_eval.cu"
REPLACES = "src/repro/kernels/strategy_eval.py:58"
#: the kernels of slice 2: their sources and the TPU kernels they replace
NEW_KERNELS = {
    "cim_matmul": ("src/repro_torch/kernels/csrc/cim_matmul.cu",
                   "src/repro/kernels/cim_matmul.py:74"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:59"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:62"),
}
CALIBRATION_ARTIFACT = "build/repro_torch/calibration.json"


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def rel_err(got, want) -> float:
    """Max relative error (0 where the two are equal, INFEASIBLE included)."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    err = np.where(g == w, 0.0, np.abs(g - w) / np.maximum(np.abs(w), 1e-300))
    return float(err.max()) if err.size else 0.0


def cuda_time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def needed_flops(job, n_cands: int) -> float:
    """Operations the cost model needs on a [J, n_cands] grid: real
    operators only (count > 0) and only the strategies each job allows
    (the per-strategy counts of ``repro_torch.obs.profile``)."""
    from repro_torch.obs.profile import strategy_eval_work
    counts = job.ops[..., 3].cpu().numpy()
    allowed = job.allowed.cpu().numpy() > 0
    return sum(strategy_eval_work(n_cands, int((counts[j] > 0).sum()), 0,
                                  allowed[j])[0]
               for j in range(counts.shape[0]))


def bound_ms(job, cand, dtype_name: str) -> tuple[float, str]:
    """Least time on an H100 for one launch: the larger of its bytes (each
    input read once, the objective written once) over HBM and its needed
    operations over the fp peak."""
    J, C = cand.shape[:2]
    nbytes = cand.element_size() * (cand.numel() + job.ops.numel()
                                    + J * 33 + J * C)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = needed_flops(job, C) / FP_PEAK[dtype_name] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(report: str) -> str:
    """Kernels, register range and spill bytes of a ``-Xptxas -v`` report."""
    import re
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", report))
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores and loads")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def start_fmad_variant(se, build) -> tuple[subprocess.Popen, Path]:
    """Start building the kernel with FMA contraction allowed (-fmad=true),
    only to price the port's -fmad=false; nothing in the port loads it."""
    out = build.build_dir() / "fmad-variant" / se.library_path().name
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in se.NVCC_FLAGS if f != "-fmad=false"] + ["-fmad=true"]
    flags = [f for f in flags if f not in ("-Xptxas", "-v")]
    proc = subprocess.Popen([build.nvcc(), *flags, "-o", str(out),
                             str(se.SOURCE)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def fig7_jobs(port):
    from repro_torch.configs import get_arch
    macro = port.get_macro("vanilla-dcim")
    jobs, meta = [], []
    for name in FIG7_NETWORKS:
        wl = port.bert_large_workload() if name == "bert-large" else \
            get_arch(name).workload(seq=512)
        for sset in ("so", "st"):
            for obj in ("ee", "th"):
                jobs.append(port.ExploreJob(macro, wl, FIG7_BUDGET_MM2,
                                            objective=obj,
                                            strategy_set=sset))
                meta.append((name, sset, obj))
    return jobs, meta


def ops_bucket(job) -> int:
    """The engine's operator bucket: a power of two, at least 4."""
    return max(4, 1 << (len(job.merged_workload().ops) - 1).bit_length())


def job_rows(job):
    """One job's numpy JobParams at its operator bucket width."""
    from repro_torch.core import cost_model
    return cost_model.job_params_np(
        job.merged_workload().as_arrays(pad_to=ops_bucket(job)), job.macro,
        job.tech, job.objective, job.strategy_set, job.area_budget_mm2,
        job.bw)


#: kernel-vs-plain tolerances on the card, |kernel - plain| <= atol + rtol
#: |plain|, by (kernel, dtype[, schedule]):
#: - fp32 matmul: sums of up to 1024 products of N(0, 1) values (partial
#:   sums up to ~100) run in another order than cuBLAS's, a few 1e-5 apart;
#: - bf16 AF matmul, attention and scan: both versions compute in fp32 from
#:   the same bf16 inputs and round the output once, so an fp32 difference
#:   in the last bits moves the output by at most one bf16 step, 2^-7
#:   relative (atol for outputs near zero);
#: - bf16 PF matmul: each of the K / bk partial sums and each addition
#:   rounds to bf16 (the schedule's point); where the kernel's fp32 partial
#:   and cuBLAS's straddle a rounding boundary they differ by one bf16 step
#:   of the partial or the running sum (up to 0.5 at |x| >= 64), and the
#:   difference carries through later roundings;
#: - fp32 attention and scan: the tolerances of tests/test_kernels.py
#:   (2e-3, 1e-3); sums over up to 4096 keys or 16 states in another order.
TOLERANCES = {
    ("cim_matmul", "float32"): (1e-3, 1e-4),
    ("cim_matmul", "bfloat16", "AF"): (1e-3, 2 ** -7),
    ("cim_matmul", "bfloat16", "PF"): (1.0, 2 ** -6),
    ("flash_attention", "float32"): (2e-3, 0.0),
    ("flash_attention", "bfloat16"): (1e-3, 2 ** -7),
    ("selective_scan", "float32"): (1e-3, 0.0),
    ("selective_scan", "bfloat16"): (1e-3, 2 ** -7),
}


def tolerance(kernel: str, dtype_name: str, kwargs: dict) -> tuple:
    key = (kernel, dtype_name, kwargs.get("tiling", "AF"))
    return TOLERANCES.get(key) or TOLERANCES[(kernel, dtype_name)]


def dtype_of(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def check_close(label: str, got, want, atol: float, rtol: float) -> float:
    """Max |got - want| over a tensor or a tuple of them; fails on a shape,
    dtype, non-finite value or tolerance breach."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{label}: kernel {tuple(g.shape)} {g.dtype} vs plain "
                 f"{tuple(w.shape)} {w.dtype}")
        g32, w32 = g.float(), w.float()
        if not bool(torch.isfinite(g32).all()):
            fail(f"{label}: kernel output is not finite")
        diff = (g32 - w32).abs()
        over = float((diff - (atol + rtol * w32.abs())).max()) \
            if diff.numel() else 0.0
        err = float(diff.max()) if diff.numel() else 0.0
        if over > 0:
            fail(f"{label}: max |kernel - plain| {err:.3e} breaks atol "
                 f"{atol} rtol {rtol}")
        worst = max(worst, err)
    return worst


def plain_of(ref, kernel: str, args: tuple, kwargs: dict):
    """The plain PyTorch version of one wrapper call, on the same inputs."""
    if kernel == "cim_matmul":
        return ref.matmul_ref(*args, tiling=kwargs.get("tiling", "AF"),
                              bk=kwargs.get("bk", 128))
    if kernel == "flash_attention":
        return ref.attention_ref(*args, causal=kwargs.get("causal", True))
    return ref.selective_scan_ref(*args)


def library_of(torch, kernel: str, args: tuple, kwargs: dict):
    """One PyTorch call computing the same function, where there is one
    (a yardstick only: the port never calls it), else None."""
    if kernel == "cim_matmul" and kwargs.get("tiling", "AF") == "AF":
        return lambda: torch.matmul(*args)
    if kernel == "flash_attention":
        import torch.nn.functional as F
        # [1, BH, T, d] views: the layout SDPA's fused backends take
        q, k, v = (x.unsqueeze(0) for x in args)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs.get("causal", True))
    return None


def kernel_bound_ms(kernel: str, args: tuple, kwargs: dict) -> tuple:
    """Least time on an H100 for one call: the larger of its bytes (each
    input read once, each output written once) over HBM and its
    operations over the peak for their type -- products of bf16 inputs on
    the tensor cores, everything else at the fp32 rate."""
    from repro_torch.obs import profile
    flops, nbytes = profile.work_counts(kernel, args, kwargs)
    dt = dtype_of(args[0])
    if kernel == "cim_matmul":
        t_ops = flops / PRODUCT_PEAK[dt]
    elif kernel == "flash_attention":
        q, k = args[:2]
        pairs = profile.attention_pairs(q.shape[0], q.shape[1], k.shape[1],
                                        kwargs.get("causal", True))
        products = pairs * 4 * q.shape[2]
        t_ops = products / PRODUCT_PEAK[dt] + \
            (flops - products) / FP_PEAK["float32"]
    else:
        t_ops = flops / FP_PEAK["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else \
        (t_bytes * 1e3, "bytes")


def timed_ms(torch, fn) -> float:
    """CUDA-event time of ``fn``, repeated for about 0.2 s (2 to 50
    calls) after one warm-up call."""
    one = cuda_time_ms(torch, fn, reps=1, warmup=1)
    return cuda_time_ms(torch, fn, reps=max(2, min(50, int(200 / max(one,
                                                                   1e-3)))),
                        warmup=0)


def measure_case(torch, ref, kernel, fn, args, kwargs, label, card) -> dict:
    """One wrapper call on the card against its plain version: error, the
    kernel's, plain version's and library call's times, and the bound."""
    got = fn(*args, **kwargs)
    torch.cuda.synchronize()
    want = plain_of(ref, kernel, args, kwargs)
    atol, rtol = tolerance(kernel, dtype_of(args[0]), kwargs)
    err = check_close(f"{kernel} {label}", got, want, atol, rtol)
    del got, want
    ms = timed_ms(torch, lambda: fn(*args, **kwargs))
    plain_ms = timed_ms(torch, lambda: plain_of(ref, kernel, args, kwargs))
    lib = library_of(torch, kernel, args, kwargs)
    library_ms = timed_ms(torch, lib) if lib is not None else None
    b_ms, b_by = kernel_bound_ms(kernel, args, kwargs)
    print(f"[kernels] {kernel} {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library "
          + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
          + f", bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of bound; "
          f"max |kernel - plain| {err:.3e} (atol {atol}, rtol {rtol}); "
          f"{card}", flush=True)
    return dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def main() -> None:
    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is false")
    try:
        from repro_torch import core as port_core
        from repro_torch.core import cost_model
        from repro_torch.core.pruning import (DesignSpace, candidates_with_bw,
                                              enumerate_space, prune_space)
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels import cim_matmul as cm_k
        from repro_torch.kernels import flash_attention as fa_k
        from repro_torch.kernels import selective_scan as ss_k
        from repro_torch.kernels import strategy_eval as se
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; cards {torch.cuda.device_count()}")
    print(card)

    # the port keeps fp32 products in true fp32; so do the plain versions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    variant_proc, variant_lib = start_fmad_variant(se, build)
    # slice 2's libraries build meanwhile, one nvcc each (read in phase 7)
    new_libs = [cm_k, fa_k, ss_k]
    pool = concurrent.futures.ThreadPoolExecutor(len(new_libs))
    new_builds = [pool.submit(build.build, m.SOURCE, m.NVCC_FLAGS)
                  for m in new_libs]
    se.build()
    lib_s = time.perf_counter() - t0
    variant_out, _ = variant_proc.communicate()
    if variant_proc.returncode != 0:
        fail(f"fmad variant build failed:\n{variant_out}")
    print(f"[build] {se.library_path().name} in {lib_s:.2f} s "
          "(both builds started together)")
    print(se.ptxas_report().strip())

    # ---- 3. kernel against its plain version, raw space ------------------
    jobs, meta = fig7_jobs(port_core)
    buckets: dict[int, list[int]] = {}
    for i, j in enumerate(jobs):
        buckets.setdefault(ops_bucket(j), []).append(i)

    def stacked(idxs, dtype):
        return cost_model.stack_job_params(
            [job_rows(jobs[i]) for i in idxs], dtype, dev)

    def pruned(i):
        j = jobs[i]
        cands, _ = prune_space(DesignSpace(), j.macro, j.area_budget_mm2,
                               j.bw)
        return candidates_with_bw(cands, j.bw)
    raw = candidates_with_bw(enumerate_space(DesignSpace()), 256)
    chunk = 4096
    worst: dict[str, float] = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        for ops_pad, idxs in sorted(buckets.items()):
            job = stacked(idxs, dtype)
            cand = torch.as_tensor(np.repeat(raw[None], len(idxs), 0),
                                   dtype=dtype).to(dev)
            got = se.launch(cand, job.ops, se.pack_params(job), 1e3,
                            totals=True)
            torch.cuda.synchronize()
            for lo in range(0, raw.shape[0], chunk):
                part = cand[:, lo:lo + chunk].contiguous()
                want = ref.job_objective_ref(job, part, 1e3, totals=True)
                for name, g, w in zip(("obj", "lat", "en"), got[:3], want[:3]):
                    e = rel_err(g[:, lo:lo + chunk], w)
                    key = f"{str(dtype)[6:]}.{name}"
                    worst[key] = max(worst.get(key, 0.0), e)
                    if e > rtol:
                        fail(f"kernel {name} differs from plain ({dtype}, "
                             f"P={ops_pad}): max rel {e:.3e} > {rtol}")
                if not torch.equal(got[3][:, lo:lo + chunk], want[3]):
                    fail(f"kernel argmins differ from plain ({dtype}, "
                         f"P={ops_pad})")
    print("[kernel] raw space, 28 Fig. 7 jobs, max rel err vs plain: "
          + json.dumps(worst) + "; argmins identical")

    # timing at the sweep's dominant launch shape: 24 jobs x 4096 x P=8
    p8 = buckets[8]
    timing: dict[str, dict] = {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        job = stacked(p8, dtype)
        cand = torch.as_tensor(np.stack([pruned(i)[:chunk] for i in p8]),
                               dtype=dtype).to(dev)
        params = se.pack_params(job)
        k_ms = cuda_time_ms(torch, lambda: se.launch(cand, job.ops, params,
                                                     1e3), reps=50)
        p_ms = cuda_time_ms(torch, lambda: ref.job_objective_ref(
            job, cand, 1e3), reps=5, warmup=1)
        got = se.launch(cand, job.ops, params, 1e3)
        want = ref.job_objective_ref(job, cand, 1e3)
        b_ms, b_by = bound_ms(job, cand, dname)
        timing[dname] = dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=float((got - want).abs().max()),
            flops=needed_flops(job, cand.shape[1]), shape=list(cand.shape)
            + [job.ops.shape[1]])
        print(f"[kernel] {dname} [24 jobs, 4096, P=8]: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{timing[dname]['flops'] / (k_ms * 1e-3) / 1e12:.2f} "
              f"TFLOP/s needed-op rate; {card}")

    # the price of -fmad=false: the FMA-contracted variant, same inputs
    vlib = ctypes.CDLL(str(variant_lib))
    vfn = vlib.strategy_eval_f32
    vfn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_double, ctypes.c_void_p]
    vfn.restype = ctypes.c_int
    job = stacked(p8, torch.float32)
    cand = torch.as_tensor(np.stack([pruned(i)[:chunk] for i in p8]),
                           dtype=torch.float32).to(dev)
    params = se.pack_params(job)
    out_v = torch.empty(cand.shape[:2], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def variant():
        err = vfn(cand.data_ptr(), job.ops.data_ptr(), params.data_ptr(),
                  out_v.data_ptr(), None, None, None, cand.shape[0],
                  cand.shape[1], job.ops.shape[1], 1e3, stream)
        if err:
            fail(f"fmad variant launch failed ({err})")

    ieee = lambda: se.launch(cand, job.ops, params, 1e3)
    t_ieee = [cuda_time_ms(torch, ieee, 50), 0.0]
    t_fma = cuda_time_ms(torch, variant, 50)
    t_ieee[1] = cuda_time_ms(torch, ieee, 50)
    same = float((out_v == ieee()).double().mean())
    print(f"[kernel] -fmad=false {statistics.mean(t_ieee):.4f} ms vs "
          f"-fmad=true {t_fma:.4f} ms (fp32, same launch); FMA build equals "
          f"the IEEE build on {same:.4f} of objectives; {card}")

    # ---- 4. main path: the Fig. 7 sweep through the kernel ---------------
    engine = port_core.ExplorationEngine(device="cuda")
    ops.job_objective.launches = 0
    ops.strategy_eval.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = engine.run(jobs, method="exhaustive")
    torch.cuda.synchronize()
    wall_first = time.perf_counter() - t0
    main_launches = ops.job_objective.launches + ops.strategy_eval.launches
    if main_launches == 0:
        fail("the Fig. 7 sweep launched no strategy_eval kernel")
    print(f"[main] Fig. 7 sweep, 28 jobs: {main_launches} kernel launches")

    plain_engine = port_core.ExplorationEngine(
        device="cuda", evaluator=ref.job_objective_ref)
    t0 = time.perf_counter()
    plain_results = plain_engine.run(jobs, method="exhaustive")
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    for r, q, m in zip(results, plain_results, meta):
        if r.config != q.config or r.per_op_strategy != q.per_op_strategy:
            fail(f"winner of {m} differs from the plain sweep: "
                 f"{r.config} vs {q.config}")
        for k in ("tops_w", "gops", "area_mm2"):
            if not (math.isfinite(r.metrics[k]) and r.metrics[k] > 0):
                fail(f"{m} metric {k} = {r.metrics[k]}")
        if r.metrics["area_mm2"] > FIG7_BUDGET_MM2 * 1.001:
            fail(f"{m} winner is over budget: {r.metrics['area_mm2']}")
    print("[main] 28 winners and per-operator strategies equal the plain "
          "sweep's on the card")

    walls = [wall_first]
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(jobs, method="exhaustive")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # where the sweep's time goes: the host's functions (cProfile) and the
    # device's busy share (torch.profiler), one more repeat each
    prof = cProfile.Profile()
    prof.enable()
    engine.run(jobs, method="exhaustive")
    torch.cuda.synchronize()
    prof.disable()
    top = sorted(((v[3], f"{Path(k[0]).name}:{k[1]}({k[2]})")
                  for k, v in pstats.Stats(prof).stats.items()),
                 reverse=True)[1:9]
    print("[main] host cumulative s: " + "; ".join(
        f"{name} {t:.4f}" for t, name in top))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        engine.run(jobs, method="exhaustive")
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0
    busy_us = sum(e.self_device_time_total for e in trace.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[main] device busy {busy_us / 1e3:.3f} ms of {wall_traced:.4f} s "
          f"traced wall: idle share "
          + (f"{1 - busy_us * 1e-6 / wall_traced:.4f}" if busy_us
             else "not measured (no device time in the trace)")
          + f"; {card}")

    # the sweep's kernel time: the same sweep, each launch between events
    spans = []

    def timed_evaluator(job, cand, penalty_scale=1e3, *, totals=False):
        params = se.pack_params(job)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = se.launch(cand, job.ops, params, penalty_scale, totals=totals)
        e.record()
        spans.append((s, e))
        return out

    port_core.ExplorationEngine(device="cuda", evaluator=timed_evaluator) \
        .run(jobs, method="exhaustive")
    torch.cuda.synchronize()
    kernel_ms = sum(s.elapsed_time(e) for s, e in spans)
    n_evals = sum(r.search["kept"] for r in results)
    wall = statistics.median(walls[1:])
    print(f"[main] wall {wall:.4f} s (median of 3 repeats; first run "
          f"{wall_first:.4f} s; plain-version sweep {wall_plain:.4f} s), "
          f"kernel {kernel_ms:.3f} ms over {len(spans)} launches, "
          f"{n_evals} candidate evaluations = {n_evals / wall:.4g} /s; "
          f"{card}")
    by = {(m[0], m[1], m[2]): r for r, m in zip(results, meta)}
    ee_gains, th_gains = [], []
    for name in FIG7_NETWORKS:
        ee = by[(name, "st", "ee")].metrics["tops_w"] / \
            by[(name, "so", "ee")].metrics["tops_w"]
        th = by[(name, "st", "th")].metrics["gops"] / \
            by[(name, "so", "th")].metrics["gops"]
        if ee < 1 - 1e-9 or th < 1 - 1e-9:
            fail(f"{name}: ST lost to SO (EE x{ee:.3f}, Th x{th:.3f})")
        ee_gains.append(ee)
        th_gains.append(th)
        print(f"[main] {name}: ST/SO EE x{ee:.3f} Th x{th:.3f}")
    geo = lambda xs: math.exp(sum(math.log(x) for x in xs) / len(xs))
    print(f"[main] geomean ST/SO EE x{geo(ee_gains):.3f} (paper "
          f"x{PAPER_GAINS['ee']}), Th x{geo(th_gains):.3f} (paper "
          f"x{PAPER_GAINS['th']})")

    # ---- 5. Table II -----------------------------------------------------
    from repro_torch.core.macro import TPDCIM_MACRO, TRANCIM_MACRO
    from repro_torch.core.template import accelerator_area_mm2
    wl = port_core.bert_large_workload()
    for name, macro, cfg in (
            ("TranCIM", TRANCIM_MACRO, port_core.AcceleratorConfig(
                3, 1, 1, 64, 128)),
            ("TP-DCIM", TPDCIM_MACRO, port_core.AcceleratorConfig(
                2, 4, 1, 16, 16))):
        budget = accelerator_area_mm2(cfg, macro)
        base = port_core.evaluate_config(macro, cfg, wl)
        base_cpu = port_core.evaluate_config(macro, cfg, wl, device="cpu")
        for k in ("tops_w", "gops", "area_mm2"):
            if abs(base[k] - base_cpu[k]) > 1e-5 * abs(base_cpu[k]):
                fail(f"Table II {name} base {k}: card {base[k]} vs plain "
                     f"{base_cpu[k]}")
        ee = port_core.co_explore(macro, wl, budget, objective="ee",
                                  method="exhaustive")
        th = port_core.co_explore(macro, wl, budget, objective="th",
                                  method="exhaustive")
        g_ee = ee.metrics["tops_w"] / base["tops_w"]
        g_th = th.metrics["gops"] / base["gops"]
        if g_ee < 1 - 1e-9 or g_th < 1 - 1e-9:
            fail(f"Table II {name}: exploration lost to the baseline")
        print(f"[table2] {name} base {cfg.as_tuple()} EE "
              f"{base['tops_w']:.2f} TOPS/W Th {base['gops']:.1f} GOPS area "
              f"{budget:.2f}; EE {ee.config.as_tuple()} x{g_ee:.2f}; Th "
              f"{th.config.as_tuple()} x{g_th:.2f}")

    # ---- 6. SA through co_explore's defaults -----------------------------
    ops.job_objective.launches = 0
    ops.strategy_eval.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = port_core.co_explore(port_core.get_macro("vanilla-dcim"), wl,
                              FIG7_BUDGET_MM2)
    torch.cuda.synchronize()
    sa_s = time.perf_counter() - t0
    sa_launches = ops.job_objective.launches + ops.strategy_eval.launches
    if sa_launches == 0:
        fail("co_explore's SA launched no strategy_eval kernel")
    ex_energy = by[("bert-large", "st", "ee")].metrics["energy_pj"]
    ratio = sa.metrics["energy_pj"] / ex_energy
    if ratio > 1.01:
        fail(f"SA energy {sa.metrics['energy_pj']} is {ratio:.4f}x the "
             f"exhaustive optimum")
    print(f"[sa] {sa.summary()} in {sa_s:.3f} s, {sa_launches} launches; "
          f"energy {ratio:.5f}x exhaustive; {card}")

    # ---- 7. build slice 2's kernels -------------------------------------
    for m, fut in zip(new_libs, new_builds):
        lib = fut.result()
        print(f"[build] {lib.name} (started in phase 2): "
              f"{ptxas_summary(build.ptxas_report(m.SOURCE, m.NVCC_FLAGS))}; "
              f"full report in "
              f"{lib.name}.ptxas.txt")
    pool.shutdown()

    # ---- 8. kernels against their plain versions -------------------------
    from repro_torch.obs import profile as obs_profile
    rng = np.random.default_rng(0)

    def on_card(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x, np.float32)).to(dev).to(dtype)

    # the shapes and dtypes of tests/test_kernels.py, checked only
    n_checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for tiling in ("AF", "PF"):
            for m, k, n in ((64, 64, 64), (200, 300, 250), (128, 128, 128),
                            (1, 700, 130), (257, 129, 255)):
                a = on_card(rng.standard_normal((m, k)), dtype)
                b = on_card(rng.standard_normal((k, n)), dtype)
                kw = {"tiling": tiling}
                check_close(f"cim_matmul {tiling} {(m, k, n)} {dtype}",
                            ops.cim_matmul(a, b, **kw),
                            plain_of(ref, "cim_matmul", (a, b), kw),
                            *tolerance("cim_matmul", dtype_of(a), kw))
                n_checked += 1
    for dtype, causal, (bh, t, s_len, d) in (
            [(torch.float32, c, sh) for c in (False, True)
             for sh in ((2, 128, 128, 64), (1, 200, 300, 64),
                        (3, 129, 257, 128))]
            + [(torch.bfloat16, True, (2, 256, 256, 64))]):
        q, k, v = (on_card(rng.standard_normal((bh, ln, d)), dtype)
                   for ln in (t, s_len, s_len))
        kw = {"causal": causal}
        check_close(f"flash_attention {(bh, t, s_len, d)} causal={causal} "
                    f"{dtype}", ops.flash_attention(q, k, v, **kw),
                    plain_of(ref, "flash_attention", (q, k, v), kw),
                    *tolerance("flash_attention", dtype_of(q), kw))
        n_checked += 1
    for dtype, (b_, t, i, s_st) in ([(torch.float32, sh) for sh in (
            (1, 64, 32, 8), (2, 100, 48, 16), (1, 33, 17, 4))]
            + [(torch.bfloat16, (1, 64, 32, 8))]):
        args = (on_card(rng.standard_normal((b_, t, i)), dtype),
                on_card(np.abs(rng.standard_normal((b_, t, i))) * 0.1, dtype),
                on_card(rng.standard_normal((b_, t, s_st)), dtype),
                on_card(rng.standard_normal((b_, t, s_st)), dtype),
                on_card(-np.abs(rng.standard_normal((i, s_st)))),
                on_card(rng.standard_normal((b_, i, s_st))))
        kw = {"ct": 16, "ci": 16}
        check_close(f"selective_scan {(b_, t, i, s_st)} {dtype}",
                    ops.selective_scan(*args, **kw),
                    plain_of(ref, "selective_scan", args, kw),
                    *tolerance("selective_scan", dtype_of(args[0]), kw))
        n_checked += 1
    a = on_card(rng.standard_normal((128, 2048)), torch.bfloat16)
    b = on_card(rng.standard_normal((2048, 128)), torch.bfloat16)
    exact = ref.matmul_ref(a, b, out_dtype=torch.float32)
    psum_err = {t: float((ops.cim_matmul(a, b, tiling=t).float() - exact)
                         .abs().mean()) for t in ("AF", "PF")}
    if psum_err["AF"] > psum_err["PF"] + 1e-6:
        fail(f"bf16 AF error {psum_err['AF']} above PF's {psum_err['PF']}")
    print(f"[kernels] {n_checked} test-shape cases within tolerance; bf16 "
          f"128x2048x128 mean |err| AF {psum_err['AF']:.5f} <= PF "
          f"{psum_err['PF']:.5f}")

    # timed: the calibration microbench's own cases (the main path's
    # shapes), then full width
    new_cases: dict[str, list[dict]] = {name: [] for name in NEW_KERNELS}
    for kernel, tiling, fn, args, kwargs in obs_profile._microbench_cases(
            tuple(NEW_KERNELS), np.random.default_rng(0), dev):
        new_cases[kernel].append(measure_case(
            torch, ref, kernel, fn, args, kwargs,
            f"{fn.__bucket_fn__(*args, **kwargs)} {tiling} float32", card))
    full: list[tuple] = []
    for dtype in (torch.float32, torch.bfloat16):
        a = on_card(rng.standard_normal((512, 1024)), dtype)
        b = on_card(rng.standard_normal((1024, 4096)), dtype)
        for tiling in ("AF", "PF"):
            full.append(("cim_matmul", ops.cim_matmul, (a, b),
                         {"tiling": tiling},
                         f"bert-large FFN 512x1024x4096 {tiling}"))
    for dtype in (torch.float32, torch.bfloat16):
        for name, (bh, t, d, causal) in (("bert-large", (16, 512, 64, False)),
                                         ("yi-6b prefill",
                                          (32, 4096, 128, True))):
            qkv = tuple(on_card(rng.standard_normal((bh, t, d)), dtype)
                        for _ in range(3))
            full.append(("flash_attention", ops.flash_attention, qkv,
                         {"causal": causal},
                         f"{name} {bh}x{t}x{t}x{d} causal={causal}"))
    for dtype in (torch.float32, torch.bfloat16):
        b_, t, i, s_st = 1, 2048, 8192, 16
        args = (on_card(rng.standard_normal((b_, t, i)), dtype),
                on_card(np.abs(rng.standard_normal((b_, t, i))) * 0.1, dtype),
                on_card(rng.standard_normal((b_, t, s_st)), dtype),
                on_card(rng.standard_normal((b_, t, s_st)), dtype),
                on_card(-np.abs(rng.standard_normal((i, s_st)))),
                torch.zeros((b_, i, s_st), device=dev))
        full.append(("selective_scan", ops.selective_scan, args,
                     {"ct": 128, "ci": 64},
                     f"falcon-mamba-7b {b_}x{t}x{i}x{s_st} ct128xci64"))
    for kernel, fn, args, kwargs, label in full:
        new_cases[kernel].append(measure_case(
            torch, ref, kernel, fn, args, kwargs,
            f"{label} {dtype_of(args[0])}", card))
        del args
    del full
    torch.cuda.empty_cache()

    # ---- 9. calibrate: measure -> fit -> artifact -> calibrated job ------
    from repro_torch.core import calibration as cal
    artifact = ROOT / CALIBRATION_ARTIFACT
    artifact.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "calibrate", "--json",
         "-o", str(artifact)], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if proc.returncode != 0:
        fail(f"calibrate exited {proc.returncode}:\n{proc.stderr}")
    cli = json.loads(proc.stdout)
    print(f"[calibrate] python -m repro_torch.service calibrate: "
          f"{cli['records']} records in {time.perf_counter() - t0:.2f} s; "
          f"report {json.dumps(cli['report'])}")

    # the same path in-process: the main path's launch counts
    for w in ops.KERNEL_WRAPPERS.values():
        w.launches = 0
    torch.cuda.synchronize()
    records = obs_profile.run_microbench()
    report = cal.fit_report(records)
    fitted = cal.fit_corrections(records)
    cal.save_calibration(str(artifact.with_name("calibration-inprocess.json")),
                         fitted, records=records, report=report)
    torch.cuda.synchronize()
    cal_launches = {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()}
    if not all(cal_launches.values()):
        fail(f"the calibration path launched no kernel for some wrapper: "
             f"{cal_launches}")
    pinned_cf, payload = cal.load_calibration(str(artifact))
    label = lambda rs: [(r["kernel"], r["bucket"], r["tiling"], r["flops"],
                         r["bytes"], r["seed"]) for r in rs]
    if label(payload["measurements"]) != label(records):
        fail("the CLI's records and the in-process records differ in labels "
             "or work counts")
    if cal.fit_corrections(payload["measurements"]) != pinned_cf:
        fail("refitting the CLI's records does not give its factors")
    print(f"[calibrate] in-process: launches {json.dumps(cal_launches)}; "
          f"factors {json.dumps(fitted.as_dict())}; held-out improvement "
          f"{report['improvement']:.4g}; CLI factors "
          f"{json.dumps(pinned_cf.as_dict())} (refit equal); {card}")
    for row in obs_profile.summary(records):
        print(f"[calibrate] {row['kernel']} {row['bucket']}: "
              f"{row['us_per_call']:.1f} us/call wall, roofline share "
              f"{row['roofline_utilization']:.3e}")

    os.environ[cal.CALIBRATION_ENV] = str(artifact)
    cal.reset_calibration_state()
    cm = port_core.default_cost_model()
    if not cm.calibrated or cm.version != cal.calibration_version(pinned_cf):
        fail(f"the pinned artifact did not calibrate the cost model: {cm}")
    macro = port_core.get_macro("vanilla-dcim")
    ops.job_objective.launches = 0
    ops.strategy_eval.launches = 0
    torch.cuda.synchronize()
    calibrated = port_core.co_explore(macro, wl, FIG7_BUDGET_MM2,
                                      method="exhaustive", tech=cm.tech)
    torch.cuda.synchronize()
    explore_launches = ops.job_objective.launches + ops.strategy_eval.launches
    if explore_launches == 0:
        fail("the calibrated co_explore launched no strategy_eval kernel")
    plain_cal = port_core.co_explore(
        macro, wl, FIG7_BUDGET_MM2, method="exhaustive", tech=cm.tech,
        engine=port_core.ExplorationEngine(device="cuda",
                                           evaluator=ref.job_objective_ref))
    if calibrated.config != plain_cal.config or \
            calibrated.per_op_strategy != plain_cal.per_op_strategy:
        fail(f"calibrated winner differs from the plain route's: "
             f"{calibrated.config} vs {plain_cal.config}")
    analytic = port_core.co_explore(macro, wl, FIG7_BUDGET_MM2,
                                    method="exhaustive")
    key = lambda tech: port_core.job_key(port_core.ExploreJob(
        macro, wl, FIG7_BUDGET_MM2, tech=tech), "exhaustive")
    if key(cm.tech) == key(port_core.DEFAULT_TECH):
        fail("the calibrated job shares the analytic job's key")
    for m in (calibrated, analytic):
        if not all(math.isfinite(m.metrics[k]) and m.metrics[k] > 0
                   for k in ("tops_w", "gops", "area_mm2", "energy_pj")):
            fail(f"non-finite metrics {m.metrics}")
    print(f"[calibrate] bert-large exhaustive, 5 mm^2: analytic "
          f"{analytic.config.as_tuple()} {analytic.metrics['tops_w']:.3f} "
          f"TOPS/W | calibrated ({cm.version}) "
          f"{calibrated.config.as_tuple()} "
          f"{calibrated.metrics['tops_w']:.3f} TOPS/W; strategies analytic "
          f"{json.dumps(analytic.per_op_strategy)} calibrated "
          f"{json.dumps(calibrated.per_op_strategy)}; calibrated = plain "
          f"route; "
          f"{explore_launches} launches; own job key")

    t32 = timing["float32"]
    new_lines = []
    for name, (source, replaces) in NEW_KERNELS.items():
        first = new_cases[name][0]
        new_lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": cal_launches[name],
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "shape": first["label"], "cases": new_cases[name]})
    print(json.dumps({"kernels": [{
        "name": "strategy_eval", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches + sa_launches + explore_launches
        + cal_launches["strategy_eval"],
        "max_abs_err": t32["max_abs_err"], "ms": t32["ms"],
        "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": None,
        "float64": {k: timing["float64"][k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")},
    }, *new_lines]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
