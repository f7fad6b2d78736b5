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
   of the exhaustive bert-large energy of phase 4.

The second-to-last line is a JSON record of the kernel (launches, error,
times, bound); the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import cProfile
import ctypes
import json
import math
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

#: floating-point operations (add, sub, mul, div, ceil, floor, min, max,
#: compare) of matmul_cost evaluated for one (candidate, operator) under
#: strategy s = 4*rev + 2*wp + pf, counted from its formula, plus the
#: argmin's score compare: 101 shared terms, 11/22/16/33 for the IP-AF /
#: IP-PF / WP-AF / WP-PF psum spill, 1 compare.
FLOPS_PER_STRATEGY = (113, 124, 118, 135, 113, 124, 118, 135)
#: per (candidate, operator): count-weighted latency and energy sums
FLOPS_PER_OPERATOR = 4
#: per candidate: SRAM bits, area, objective, area penalty, bandwidth rule
FLOPS_PER_CANDIDATE = 38

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/strategy_eval.cu"
REPLACES = "src/repro/kernels/strategy_eval.py:58"


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
    operators only (count > 0) and only the strategies each job allows."""
    counts = job.ops[..., 3].cpu().numpy()
    allowed = job.allowed.cpu().numpy() > 0
    per_strategy = np.asarray(FLOPS_PER_STRATEGY, dtype=np.float64)
    total = 0.0
    for j in range(counts.shape[0]):
        real_ops = int((counts[j] > 0).sum())
        per_op = float(per_strategy[allowed[j]].sum()) + FLOPS_PER_OPERATOR
        total += n_cands * (real_ops * per_op + FLOPS_PER_CANDIDATE)
    return total


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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def start_fmad_variant(se) -> tuple[subprocess.Popen, Path]:
    """Start building the kernel with FMA contraction allowed (-fmad=true),
    only to price the port's -fmad=false; nothing in the port loads it."""
    out = se.build_dir() / "fmad-variant" / se.library_path().name
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in se.NVCC_FLAGS if f != "-fmad=false"] + ["-fmad=true"]
    flags = [f for f in flags if f not in ("-Xptxas", "-v")]
    proc = subprocess.Popen([se._nvcc(), *flags, "-o", str(out),
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
        from repro_torch.kernels import ops, ref
        from repro_torch.kernels import strategy_eval as se
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; cards {torch.cuda.device_count()}")
    print(card)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    variant_proc, variant_lib = start_fmad_variant(se)
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

    t32 = timing["float32"]
    print(json.dumps({"kernels": [{
        "name": "strategy_eval", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches + sa_launches,
        "max_abs_err": t32["max_abs_err"], "ms": t32["ms"],
        "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": None,
        "float64": {k: timing["float64"][k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
