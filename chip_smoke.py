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
   the strategy_eval build); print each library's compiler summary, the
   registers and spills of every tensor-core instantiation (bf16, and
   fp32 in 3xTF32), and the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
   instructions in its SASS (``cuobjdump -sass``); fails if an
   instantiation of either route of ``cim_matmul`` or ``flash_attention``
   has no ``HGMMA`` or one is missing;
8. kernels  -- each against its plain version on the card, at the shapes
   of tests/test_kernels.py, at every bf16 tile set of the tensor-core
   routes (matmul on a ragged shape that needs TMA padding, AF and PF;
   attention with T != S ragged, at every compiled head width (64, 128,
   256) and at 120 and 16, which run on a wider one, causal or not), at
   the calibration microbench's shapes (fp32, and bf16 for the two
   tensor-core kernels) and at full width (bert-large's FFN matmul,
   bert-large and yi-6b attention, the falcon-mamba-7b scan, fp32 and
   bf16; bf16 causal attention at h2o-danube-3-4b's prefill
   32x4096x4096x120, gemma-7b's 16x4096x4096x256 and recurrentgemma-9b's
   local 16x2048x2048x256), each with its stated tolerance; timed with
   CUDA events beside its plain version, its bound and, where one PyTorch
   call computes the same function, that call (timed as a yardstick
   only), each also replayed from a CUDA graph (device time without
   per-call host dispatch); AF's
   bf16 error <= PF's; then the fp32 (3xTF32) routes at every tile set on
   the bf16 sweep's ragged shapes (matmul 257x300x250 AF and PF; attention
   2x200x333 and 2x333x200 at every width, causal or not), each checked
   and timed the same way, fp32 bounds also at the CUDA cores' rate;
9. calibrate -- ``python -m repro_torch.service calibrate --json -o
   build/repro_torch/calibration.json`` in a subprocess, then the same
   path in-process (``run_microbench`` -> ``fit_report`` +
   ``fit_corrections`` -> ``save_calibration``) with the launch counts
   reset just before and read just after (every kernel > 0); the two
   agree on records and refit; the CLI's artifact pinned through
   ``CIM_TUNER_CALIBRATION`` drives ``default_cost_model()`` and a
   calibrated bert-large exhaustive ``co_explore`` on the card, which
   must equal the same job with the plain versions and carry its own
   job key;
10. strategy_eval per shape -- the paths of phases 4, 6, 9 and 11 driven
   once more, untimed, with every kernel launch recorded by shape (and the
   first inputs of each); each path's recorded launches must equal its
   launch counts and those of its timed run. Each shape is replayed in
   fp32 (and the shapes of phases 4, 6 and 9 in fp64): per call and from
   a CUDA graph, beside its bound, launches, registers, spills and
   ``MUFU.RCP`` count; and the sum of launches x graph time;
11. search (run before phase 10, which records its launches) -- fp32 on
   the full ``DesignSpace()`` at 5 mm^2, ``vanilla-dcim``:
   ``co_explore(..., method=m)`` with default settings on bert-large for
   m in sobol, genetic, evolution, portfolio (bandit), each within 1 %
   (Sobol 10 %) of phase 4's exhaustive energy, within budget, and with
   exactly the strategy_eval launches its settings give; the bandit
   portfolio over the 28 Fig. 7 jobs with the kernel and with the plain
   version on the card (identical configs, best values and pulls; each
   job's ratio to its exhaustive objective printed); the halving
   allocator twice (equal, and not worse than any rung-0 solo run); the
   measured-fidelity rung with phase 9's artifact pinned (source
   "artifact", both rankings, winner metrics equal to ``evaluate_config``
   under the corrected tech) and unpinned (source "live": the live
   microbench launches ``cim_matmul``, ``flash_attention`` and
   ``selective_scan``);
12. service -- an in-process ``DSEServer`` on the card over a fresh
   store: the 28 Fig. 7 exhaustive jobs POSTed as specs and streamed back
   over SSE equal phase 4's configs, per-operator strategies and metrics
   bit for bit, in one dispatch per operator bucket, through the kernel
   (launch counts reset just before, read just after), arriving bucket by
   bucket; resubmitted, all 28 come from the store with no dispatch;
   while the bert-large bandit portfolio races, 3 more P = 8 portfolio
   jobs are POSTed 50 ms apart, at least one joins the running race, and
   each equals its solo ``engine.run`` (config, final best, pulls);
   ``/v1/pareto`` equals ``pareto_explore(engine=...)``, ``/v1/metrics``
   parses as Prometheus text, the race's timeline is served; then
   ``python -m repro_torch.service serve`` as a subprocess on the card,
   ``explore --url --json`` against it (equal to the in-process records)
   and SIGTERM ("draining", exit 0).  Every wait has a timeout;
13. verify and scale (run before phase 10, which records its launches) --
   the kernel's per-operator strategies of phase 4's 28 winners compiled
   by ``compile_schedule`` (operators over ``MAX_SETS`` counted per job):
   every schedule's ten sums equal ``matmul_cost`` in fp64 on the card,
   every ``simulate_schedule`` latency on the card (overlap as the cost
   model sets it) lies inside ``analytic_latency_bounds``, and each job's
   simulation gap (sum of count x simulated latency over the kernel's total
   latency) is printed; ``compile_trace`` + ``replay_trace`` equal ``x @ w``
   under all 8 strategies; the Fig. 1 ``buffer_sweep`` and its argmin;
   ``simulated_annealing`` with a kernel objective (``ops.objective_fn``)
   at phase 6's settings within 1 % of phase 4's bert-large optimum and
   ``exhaustive_search`` equal to phase 4's winner and value bit for bit;
   ``distributed_co_explore_jobs`` over the 28 jobs on 1 and 4 slots of
   the card (monotone traces, launches = slots x (1 + rounds x
   sync_every), ratios to phase 4's optima, walls), a checkpoint after
   round 4 resumed to the end equal to the uninterrupted run, and an
   elastic resume from 4 slots to 1.

14. serve (run after phase 12) -- ``ServeEngine`` at full width and
   depth for yi-6b (32 layers, d 4096, GQA 32/4, head 128),
   falcon-mamba-7b (64 Mamba-1 layers, d_inner 8192, state 16),
   h2o-danube-3-4b (24 layers, GQA 32/8, head 120) and gemma-7b (28
   layers, 16 heads of 256, 8.54 B parameters), weights from the port's
   own init (seed 0), one model at a time: 14.a a seeded prompt's prefill
   (1 x 4096, 1 x 2048, 1 x 4096, 1 x 4096) through the kernels -- exactly
   32 ``flash_attention`` launches at 32x4096x4096x128 bf16, 64
   ``selective_scan`` launches at 1x2048x8192x16 fp32, 24 at
   32x4096x4096x120 and 28 at 16x4096x4096x256, no other kernel --
   against the same model with the plain twins on the card (max |d
   logits| within ``SERVE_REL_TOL`` of max |logit|, top-1 agreement at
   least ``SERVE_TOP1``), the kernel's CUDA-event time and share of the
   wall; 14.b ``generate`` (4 left-padded prompts of 256-512 tokens, 32
   new, greedy: prefill_s, decode_s, tokens_per_s; 32 flash launches, 64
   x 33 scan launches) with the plain twins teacher-forced on its tokens
   and held at every step; each launch shape of 14.a and 14.b timed
   against its plain version, bound and SDPA; 14.c (yi-6b and
   falcon-mamba-7b) ``python -m repro_torch.launch.serve --arch <id>
   --batch 4 --prompt-len 512 --new-tokens 32`` as a subprocess (exit 0,
   the reference's two lines); peak memory.  The kernels line reports the
   serve path's launches (by arch) and shapes for the two kernels.

15. train (run after phase 14) -- the training path at full width, depth
   8 (gemma-7b 4): 15.a the backward kernels ``flash_attention_bwd``
   (yi-6b's layer, 32x4096x4096x128 causal, h2o-danube-3-4b's at 120,
   gemma-7b's 16x4096x4096x256, and ragged, non-causal d 64, T != S at
   64, 120, 128 and 256) and ``selective_scan_bwd`` (1x2048x8192x16, and
   S in {1, 4, 8, 16} ragged)
   against autograd of their plain versions on the card (attention row by
   row: each query's dq, each key's dk and dv), two launches
   bit-identical, timed per call and from a CUDA graph beside the plain
   version, the bound and (attention) SDPA's backward; then the
   optimizer's kernels (``adamw.cu``) on the full-width leaf tables of
   yi-6b and falcon-mamba-7b at 2 layers: the norm's sums and the norm
   within 1e-6 relative of the plain versions', one update's p, m and v
   bit-equal to the plain version's given the same norm, the norm and the
   update timed per call and from a CUDA graph beside the plain versions
   and their bounds (4 and 28 B a parameter), registers and no spills;
   15.b per config
   (yi-6b 1 x 4096 tokens, falcon-mamba-7b 1 x 2048, gemma-7b 1 x 4096)
   ``Trainer`` for 10 steps on the synthetic stream with a checkpoint
   every 5 (launch counts reset just before and read just after: per step
   2 forward launches a layer with remat, 1 backward and the optimizer's
   4, its last update taking every leaf), the loss
   falling, for yi-6b and falcon-mamba-7b a run of 5 steps resumed by a
   third to step 10 (losses within 1e-3 of the uninterrupted run's;
   gemma-7b saves no checkpoint and runs once, its kernels timed in that
   run), one step of the kernel path against the plain twins (loss and
   every leaf's gradient under the bars rehearsed on the CPU) at the
   starting weights, and after training against the plain twins and the
   exact twin (fp32 attention under autograd in the kernels' place) with
   that step's backward launches held against their plain versions,
   sec_per_step, tokens/s, the kernels' CUDA-event share of a step and
   peak memory; 15.c (run after 15.a, before 15.b, while this process
   holds the least memory) ``python -m repro_torch.launch.train --arch
   yi-6b --set n_layers=8 --steps 4 --batch 1 --seq 4096`` in a fresh
   process.  The kernels line gains the two backward kernels with their training
   launches, and ``adamw_apply`` and ``adamw_norm`` (the norm's three
   launches) with their training launches and 15.a's yi-6b case.

16. sharded (run after phase 15; its two timed training runs, 16.d's
   fresh process and then 16.a, run right after 15.c, one after the
   other, so that both time the same host) -- the sharding slice on a 1x1
   ``DeviceMesh`` (``launch.mesh.make_debug_mesh``, NCCL, one rank): 16.a
   yi-6b at full width, depth 8, 1 x 4096 tokens, 12 steps of
   ``build_cell``'s training cell against ``make_train_step`` without a
   mesh from the same seed (losses and every updated leaf within 1e-6
   relative; 16 ``flash_attention`` and 8 ``flash_attention_bwd``
   launches a step, under ``local_map``, and the optimizer's 4, in both),
   sec_per_step and peak memory of both; 16.b ``ServeEngine(cfg, mesh)`` on the device
   engine's falcon-mamba-7b weights: a 2,048-token prefill (64
   ``selective_scan`` launches) held at phase 14's bar, then 4 greedy
   tokens equal to the device engine's; 16.c ``roofline.cim_sweep`` over
   the ten archs (seq 512, ``vanilla-dcim``, 5 mm^2, exhaustive) through
   the DSE service on the card, on a fresh store (``strategy_eval``
   launches); 16.d the abstract cell report of every arch x shape
   (``dryrun.run_cell``) and ``python -m repro_torch.launch.dryrun --arch
   yi-6b --shape train_4k --set n_layers=8 --batch 1 --measure`` in a
   fresh process held against 16.a's sharded step (its fastest timed
   step) and peak memory within 10 %.  The kernels line adds phase 16's counted launches.

Timed and counted ``co_explore`` drives (phases 6, 9, 10, 11) pass
``engine=``, the bypass of the service, so a repeat times the engine and
not a store hit; phase 5's Table II runs go through the service.

Phase 7 also counts ``MUFU.RCP`` (IEEE division) in every kernel's SASS;
phase 8 prints each scan launch's blocks, threads and warps per SM.  Each
phase's wall is printed as it ends (``[phase]`` lines), and all of them
with the whole run's before the kernels line.

The second-to-last line is a JSON record of the kernels (launches, error,
times, bound); the last is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import cProfile
import concurrent.futures
import ctypes
import json
import math
import os
import pstats
import re
import shutil
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
#: the peak for a matrix product's operations in each input type, on the
#: tensor cores: bf16 at 989 TFLOP/s; fp32 in 3xTF32, each fp32 product
#: three TF32 products at 495 TFLOP/s (495e12 / 3).  The fp32 routes ran on
#: the CUDA cores before (67 TFLOP/s, FP_PEAK): measure_case prints the
#: share against that rate too, so no share can read above 1
PRODUCT_PEAK = {"float32": 495e12 / 3, "bfloat16": 989e12}

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
#: the design of each kernel's dtype routes (printed in the kernels line)
DESIGNS = {
    "strategy_eval": {
        "float32": "CUDA cores: two lanes per (job, candidate), one REV half "
                   "each, shuffle-combined first-index argmin; per-job and "
                   "per-(candidate, operator, REV) terms computed once; "
                   "IEEE, -fmad=false",
        "float64": "CUDA cores: two lanes per (job, candidate), one REV half "
                   "each, shuffle-combined first-index argmin; per-job and "
                   "per-(candidate, operator, REV) terms computed once; "
                   "IEEE, -fmad=false"},
    "cim_matmul": {
        "float32": "tensor cores, 3xTF32: wgmma m64n64k8 .tf32 lo*hi + hi*lo "
                   "+ hi*hi; a producer warpgroup loads each 32-wide K stage, "
                   "splits it into tf32 hi + lo and stores it K-major (B "
                   "transposed) into a 4-6 stage mbarrier ring; TM/64 "
                   "consumer warpgroups, each stage's hi*hi sum added on "
                   "the CUDA cores; TM x 64 blocks (64 x 64 where TM rows "
                   "leave the card idle); PF adds each K block's sum into "
                   "the output",
        "bfloat16": "tensor cores: wgmma m64nBNk16 from a TMA ring "
                    "(mbarriers), producer warpgroup + BM/64 consumer "
                    "warpgroups; PF epilogue staged in shared memory"},
    "flash_attention": {
        "float32": "tensor cores, 3xTF32: wgmma .tf32 QK^T (Q, K hi + lo "
                   "in smem) and PV (P hi + lo from registers, V^T hi + lo "
                   "in smem); a producer warpgroup loads, splits and "
                   "stores q once and K, V (V transposed) per key step "
                   "into mbarrier rings; one consumer warpgroup of 64 "
                   "query rows, softmax in registers; 64-key steps at "
                   "widths 64 and 128, 32 at 256",
        "bfloat16": "tensor cores: wgmma QK^T (smem) and PV (P hi+lo from "
                    "registers), 2-stage TMA ring, softmax in registers, "
                    "QK of one key step overlapping PV of the last; head "
                    "widths up to 256 on the compiled 64, 128, 256 (TMA "
                    "zero-fills the columns past d; 64x64 tiles at 256)"},
    "selective_scan": {
        "float32": "CUDA cores: a lane per state, S lanes per (batch, "
                   "channel), y by shuffle tree; dt/xi/B/C chunks "
                   "double-buffered in shared memory by cp.async",
        "bfloat16": "CUDA cores: a lane per state, S lanes per (batch, "
                    "channel), y by shuffle tree; dt/xi/B/C chunks "
                    "double-buffered in shared memory by cp.async"},
}
#: the tensor-core instantiations each library must hold (phase 7), by
#: route: bf16 (namespace tc, fed by TMA) and fp32 (namespace tf, 3xTF32,
#: loaded by its producer threads): pieces of their mangled names, and
#: how many there are
TC_KERNELS = {
    "cim_matmul": {"bf16": (("2tc9af_kernelILi", "2tc9pf_kernelILi"), 16),
                   "fp32": (("2tf9mm_kernelILi",), 2)},
    "flash_attention": {"bf16": (("2tc12flash_kernelILi",), 9),
                        "fp32": (("2tf12flash_kernelILi",), 3)}}
CALIBRATION_ARTIFACT = "build/repro_torch/calibration.json"
#: the falcon-mamba-7b scan at full width (B, T, I, S) and its tiling
FALCON_SCAN = (1, 2048, 8192, 16)
FALCON_TILING = {"ct": 128, "ci": 64}


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


def traced_busy(torch, fn, sync) -> tuple[float, float]:
    """One run of ``fn`` under torch.profiler: the device's busy time (µs,
    the sum of its kernels' self time) and the traced run's wall (s).  On
    a card only the device's activity is traced: the host's operator
    events of a search path (hundreds a step) take longer to collect than
    the run itself."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]
    with profile(activities=acts) as trace:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return device_us(torch, trace), wall


def device_us(torch, trace) -> float:
    """The device time of a profile's kernels, copies and memsets (µs).
    The ranges of ``obs`` spans, which reach a running profiler, are left
    out: their device time is that of the kernels under them."""
    return sum(e.self_device_time_total for e in trace.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def busy_text(busy_us: float, wall: float) -> str:
    return (f"device busy {busy_us / 1e3:.3f} ms of {wall:.4f} s traced "
            "wall: busy share " + (f"{busy_us * 1e-6 / wall:.4f}" if busy_us
                                   else "not measured (no device time in "
                                   "the trace)") + " (torch.profiler)")


def job_of_params(cost_model, ops_t, params):
    """The batched ``JobParams`` a packed parameter block [J, NPARAM]
    came from (the inverse of ``strategy_eval.pack_params``; the bus
    width rides in the candidates, so ``bw`` is left out)."""
    nm, nt = (len(cost_model.MacroParams._fields),
              len(cost_model.TechParams._fields))
    cols = params.unbind(1)
    return cost_model.JobParams(
        ops=ops_t, macro=cost_model.MacroParams(*cols[:nm]),
        tech=cost_model.TechParams(*cols[nm:nm + nt]),
        allowed=params[:, nm + nt:nm + nt + 8], obj_code=cols[-2],
        area_budget=cols[-1], bw=None)


#: where the strategy mask sits in a packed parameter row (the kernel's
#: ``Param`` layout: 11 macro and 12 tech constants, then the mask)
P_ALLOWED = 23


def needed_flops(ops_t, params, n_cands: int) -> float:
    """Operations the cost model needs on a [J, n_cands] grid: real
    operators only (count > 0) and only the strategies each job allows
    (the per-strategy counts of ``repro_torch.obs.profile``)."""
    from repro_torch.obs.profile import strategy_eval_work
    counts = ops_t[..., 3].cpu().numpy()
    allowed = params[:, P_ALLOWED:P_ALLOWED + 8].cpu().numpy() > 0
    return sum(strategy_eval_work(n_cands, int((counts[j] > 0).sum()), 0,
                                  allowed[j])[0]
               for j in range(counts.shape[0]))


def bound_ms(cand, ops_t, params, totals: bool = False) -> tuple[float, str]:
    """Least time on an H100 for one launch: the larger of its bytes (each
    input read once, each output written once: the objective, and with
    ``totals`` the latency, energy and per-operator index) over HBM and
    its needed operations over the fp peak."""
    J, C = cand.shape[:2]
    outputs = J * C * (3 if totals else 1)
    nbytes = cand.element_size() * (cand.numel() + ops_t.numel()
                                    + params.numel() + outputs) \
        + (4 * J * C * ops_t.shape[1] if totals else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = needed_flops(ops_t, params, C) / FP_PEAK[dtype_of(cand)] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class LaunchShapes:
    """While installed, counts every ``strategy_eval`` launch by shape
    (J, C, P, dtype, totals) and keeps a copy of the first launch's inputs
    of each shape, so the kernel can be timed later on the main path's own
    data. It costs host time and copies, so no timed span runs under it."""

    def __init__(self, se):
        self.se = se
        self.counts: collections.Counter = collections.Counter()
        self.inputs: dict[tuple, tuple] = {}

    def __enter__(self):
        self.orig = launch = self.se.launch

        def recording(cand, ops_t, params, penalty_scale, **kw):
            key = (cand.shape[0], cand.shape[1], ops_t.shape[1],
                   dtype_of(cand), bool(kw.get("totals")))
            self.counts[key] += 1
            if key not in self.inputs:
                self.inputs[key] = (cand.clone(), ops_t.clone(),
                                    params.clone(), float(penalty_scale))
            return launch(cand, ops_t, params, penalty_scale, **kw)
        self.se.launch = recording
        return self

    def __exit__(self, *exc):
        self.se.launch = self.orig


#: C++ names of the kernel's element types
CXX_TYPES = {"float32": "float", "float64": "double"}


def se_instantiations(build, se) -> dict[str, dict]:
    """Registers, spill bytes and ``MUFU.RCP`` count of each
    ``strategy_eval`` instantiation, by its C++ element type."""
    pattern = r"strategy_eval_kernel<(\w+)>"
    rows: dict[str, dict] = {}
    for name, regs, st, ld in ptxas_table(se.ptxas_report()):
        m = re.match(pattern, name)
        if m:
            rows[m.group(1)] = dict(regs=regs, spill_bytes=st + ld)
    for mangled, c in sass_counts(build, se.library_path()).items():
        m = re.match(pattern, short_name(mangled))
        if m:
            rows.setdefault(m.group(1), {})["mufu_rcp"] = c["MUFU.RCP"]
    return rows


def strategy_eval_rows(torch, se, ref, cost_model, shapes: LaunchShapes,
                       insts: dict, card: str, fp64_shapes: set) -> list[dict]:
    """Each launch shape the main path gave the kernel, on its own first
    inputs, in fp32 (and fp64 for ``fp64_shapes``): held against the
    plain version (relative error within 1e-5 in fp32 and 1e-12 in fp64,
    per-operator strategies equal), time per call and replayed from a CUDA
    graph, the plain version's time, bound and share of it, launches on
    the main path, and the instantiation's registers, spills and
    ``MUFU.RCP``."""
    fmt = lambda x: f"{x:.4f} ms" if x is not None else "none"
    rtols = {"float32": 1e-5, "float64": 1e-12}
    rows = []
    for key in sorted(shapes.inputs, key=lambda k: (-k[0] * k[1], k)):
        cand, ops_t, params, ps = shapes.inputs[key]
        totals = key[4]
        for dtype in (torch.float32, torch.float64)[
                :2 if key in fp64_shapes else 1]:
            c, o, p = (x.to(dtype) for x in (cand, ops_t, params))
            fn = lambda: se.launch(c, o, p, ps, totals=totals)
            job = job_of_params(cost_model, o, p)
            plain = lambda: ref.job_objective_ref(job, c, ps, totals=totals)
            got, want = fn(), plain()
            got, want = ((got, want) if totals else ((got,), (want,)))
            label = f"strategy_eval [{key[0]}, {key[1]}, P={key[2]}]"
            err = max(rel_err(g, w) for g, w in zip(got[:3], want[:3]))
            if err > rtols[dtype_of(c)]:
                fail(f"{label} {dtype_of(c)}: max rel error {err:.3e} "
                     f"against the plain version")
            if totals and not torch.equal(got[3], want[3]):
                fail(f"{label} {dtype_of(c)}: per-operator strategies "
                     "differ from the plain version's")
            abs_err = max(float((g.double() - w.double()).abs().max())
                          for g, w in zip(got[:3], want[:3]))
            b_ms, b_by = bound_ms(c, o, p, totals)
            ms, g_ms = timed_ms(torch, fn), graph_ms(torch, fn)
            p_ms = timed_ms(torch, plain)
            inst = insts.get(CXX_TYPES[dtype_of(c)], {})
            row = dict(shape=list(key[:3]), totals=totals, dtype=dtype_of(c),
                       launches=shapes.counts[key], ms=ms, graph_ms=g_ms,
                       plain_ms=p_ms, max_abs_err=abs_err, max_rel_err=err,
                       bound_ms=b_ms, bound_by=b_by, **inst)
            rows.append(row)
            print(f"[strategy_eval] [J {key[0]}, C {key[1]}, P {key[2]}]"
                  f"{' totals' if totals else ''} {row['dtype']}: "
                  f"max rel error {err:.3e} against the plain version"
                  + (", strategies equal" if totals else "") + "; "
                  f"{ms:.4f} ms per call, graph {fmt(g_ms)}, plain "
                  f"{p_ms:.4f} ms; bound "
                  f"{b_ms:.6f} ms ({b_by}), {b_ms / ms:.4f} of bound per call"
                  + (f", {b_ms / g_ms:.4f} from the graph" if g_ms else "")
                  + f"; {row['launches']} main-path launches; "
                  f"{inst.get('regs', '?')} registers, "
                  f"{inst.get('spill_bytes', '?')} bytes of spills, "
                  f"{inst.get('mufu_rcp', '?')} MUFU.RCP; {card}", flush=True)
    spent = sum(r["launches"] * (r["graph_ms"] or 0.0) for r in rows
                if r["dtype"] == "float32")
    print(f"[strategy_eval] main path: {sum(shapes.counts.values())} "
          f"launches over {len(shapes.counts)} shapes; launches x "
          f"graph-replayed time per shape (fp32) = {spent:.4f} ms of device "
          f"time; {card}", flush=True)
    return rows


def ptxas_summary(report: str) -> str:
    """Kernels, register range and spill bytes of a ``-Xptxas -v`` report."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", report))
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spill stores and loads")


def ptxas_table(report: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function of a ``-Xptxas -v`` report, names shortened to the
    kernel and its template arguments."""
    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = short_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return rows


#: element types in mangled template arguments
MANGLED_TYPES = {"f": "float", "d": "double", "13__nv_bfloat16": "bf16"}


def short_name(mangled: str) -> str:
    """``tc::af_kernel<128, 64, 128>``, ``tf::mm_kernel<128>`` or
    ``strategy_eval_kernel<double, 2>`` from a kernel's mangled name (the
    tensor-core kernels take no element type: ``tc::`` are the bf16
    routes, ``tf::`` the fp32 ones)."""
    m = re.search(r"([a-z_]+_kernel)I(f|d|13__nv_bfloat16)?((?:Li\d+E)*)E",
                  mangled)
    if not m or not (m.group(2) or m.group(3)):
        return mangled
    args = re.findall(r"Li(\d+)E", m.group(3))
    typed = [MANGLED_TYPES[m.group(2)]] if m.group(2) else []
    fp32 = f"2tf{len(m.group(1))}{m.group(1)}" in mangled
    return ("" if typed else "tf::" if fp32 else "tc::") + m.group(1) + \
        "<" + ", ".join(typed + args) + ">"


#: SASS instructions counted per kernel function: wgmma, TMA loads, and
#: the reciprocal seed of every IEEE division (fp32 MUFU.RCP, fp64
#: MUFU.RCP64H), one or two per division site plus the slow path's
SASS_OPS = ("HGMMA", "UTMALDG", "MUFU.RCP")


def sass_counts(build, lib: Path) -> dict[str, dict[str, int]]:
    """Counts of each of :data:`SASS_OPS` in each kernel function of a
    library's SASS (``cuobjdump -sass``), by mangled name."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    counts: dict[str, dict[str, int]] = {}
    name = None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name:
            for op in SASS_OPS:
                counts[name][op] += op in line
    return counts


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
#:   sums up to ~100) run in another order than cuBLAS's, each product in
#:   3xTF32 (about 2^-20 relative) and each 32-wide stage's sum added on
#:   the CUDA cores: up to about 1.6e-4 apart at the bert-large FFN;
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
    # fp32 PF adds its K blocks' partial sums in fp32: the product, up to
    # summation order; bf16 PF rounds each partial sum, which no call does
    if kernel == "cim_matmul" and (kwargs.get("tiling", "AF") == "AF"
                                   or args[0].dtype == torch.float32):
        return lambda: torch.matmul(*args)
    if kernel == "flash_attention":
        import torch.nn.functional as F
        # [1, BH, T, d] views: the layout SDPA's fused backends take
        q, k, v = (x.unsqueeze(0) for x in args)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=kwargs.get("causal", True))
    return None


def kernel_bound_ms(kernel: str, args: tuple, kwargs: dict,
                    peak: dict = PRODUCT_PEAK) -> tuple:
    """Least time on an H100 for one call: the larger of its bytes (each
    input read once, each output written once) over HBM and its
    operations over the peak for their type -- products at ``peak``
    (PRODUCT_PEAK: on the tensor cores), everything else at the fp32
    rate."""
    from repro_torch.obs import profile
    flops, nbytes = profile.work_counts(kernel, args, kwargs)
    dt = dtype_of(args[0])
    if kernel == "cim_matmul":
        t_ops = flops / peak[dt]
    elif kernel == "flash_attention":
        q, k = args[:2]
        pairs = profile.attention_pairs(q.shape[0], q.shape[1], k.shape[1],
                                        kwargs.get("causal", True))
        products = pairs * 4 * q.shape[2]
        t_ops = products / peak[dt] + \
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


def graph_ms(torch, fn, calls: int = 20):
    """Device time of one ``fn`` call without its host dispatch: ``calls``
    calls captured into one CUDA graph, replayed, timed with CUDA events.
    None where the call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        ms = timed_ms(torch, graph.replay) / calls
        del graph
        return ms
    except RuntimeError as e:
        print(f"[kernels] CUDA graph capture failed: {e}", flush=True)
        torch.cuda.synchronize()
        return None


def scan_geometry(torch, ss_k, args: tuple, kwargs: dict) -> dict:
    """The scan launch's blocks, threads a block, most blocks an SM holds
    and resident warps per SM in the first wave."""
    xi, a = args[0], args[4]
    b, _, i = xi.shape
    ct = kwargs.get("ct", ss_k.DEFAULT_CT)
    ci = kwargs.get("ci", ss_k.DEFAULT_CI)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = ss_k.geometry(xi.dtype, b, i, a.shape[1], ct, ci)
    resident = min(g["blocks"], g["blocks_per_sm"] * sms)
    return dict(g, warps_per_sm=resident * -(-g["threads"] // 32) / sms)


def measure_case(torch, ref, kernel, fn, args, kwargs, label, card) -> dict:
    """One wrapper call on the card against its plain version: error, the
    kernel's, plain version's and library call's times (per call, and
    replayed from a CUDA graph), and the bound."""
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
    g_ms = graph_ms(torch, lambda: fn(*args, **kwargs))
    lib_g_ms = graph_ms(torch, lib) if lib is not None else None
    b_ms, b_by = kernel_bound_ms(kernel, args, kwargs)
    # fp32 products: the bound at the CUDA cores' rate as well
    b67 = kernel_bound_ms(kernel, args, kwargs, FP_PEAK)[0] \
        if kernel in TC_KERNELS and dtype_of(args[0]) == "float32" else None
    geo = {}
    if kernel == "selective_scan":
        from repro_torch.kernels import selective_scan as ss_k
        geo = scan_geometry(torch, ss_k, args, kwargs)
    fmt = lambda x: f"{x:.4f} ms" if x is not None else "none"
    print(f"[kernels] {kernel} {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {fmt(library_ms)}, bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.3f} of bound; graph-replayed "
          f"kernel {fmt(g_ms)}, library {fmt(lib_g_ms)}"
          + (f", {b_ms / g_ms:.3f} of bound" if g_ms else "")
          + (f"; bound at the CUDA cores' fp32 rate {b67:.4f} ms, "
             f"{b67 / (g_ms or ms):.3f} of it" if b67 else "")
          + f"; max |kernel - plain| {err:.3e} (atol {atol}, rtol {rtol})"
          + (f"; launch {geo['blocks']} blocks x {geo['threads']} threads, "
             f"{geo['warps_per_sm']:.2f} warps per SM" if geo else "")
          + f"; {card}", flush=True)
    return dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                graph_ms=g_ms, library_graph_ms=lib_g_ms,
                **({"bound_cuda_cores_ms": b67} if b67 else {}), **geo)


def falcon_scan_args(rng, on_card, dtype, dev) -> tuple:
    """Inputs of the falcon-mamba-7b scan at full width (1 x 2048 x 8192 x
    16), drawn from ``rng``."""
    import torch
    b_, t, i, s_st = FALCON_SCAN
    return (on_card(rng.standard_normal((b_, t, i)), dtype),
            on_card(np.abs(rng.standard_normal((b_, t, i))) * 0.1, dtype),
            on_card(rng.standard_normal((b_, t, s_st)), dtype),
            on_card(rng.standard_normal((b_, t, s_st)), dtype),
            on_card(-np.abs(rng.standard_normal((i, s_st)))),
            torch.zeros((b_, i, s_st), device=dev))


#: the search methods phase 11 drives, each through co_explore's defaults
SEARCH_METHODS = ("sobol", "genetic", "evolution", "portfolio")
#: the reference's bar (tests/test_search.py): adaptive backends within 1 %
#: of the exhaustive optimum, the Sobol baseline within 10 %
SEARCH_TOL = {"sobol": 1.10}


def backend_calls(name: str, settings) -> int:
    """Evaluator calls of one batched run of a primitive backend: one per
    SA step or GA / DE generation plus the initial population; one for a
    Sobol sweep."""
    if name == "sobol":
        return 1
    return (settings.n_steps if name == "sa" else settings.generations) + 1


def search_launches(method: str, settings, results, timelines) -> int:
    """The strategy_eval launches of one engine run of ``method`` over one
    operator bucket, from its settings: the backend's calls, one launch
    finishing the winners, and the pruned sweep of any snap-verify
    fallback.  A portfolio makes, per race wave, one batched run of each
    backend some job pulled (read from each job's flight-recorder pulls),
    one final run per winning backend, and two re-scoring launches when
    measured."""
    from repro_torch.search import portfolio as pf
    n = 1 + sum(math.ceil(r.search["kept"] / 4096) for r in results
                if "kept" in r.search)
    if method != "portfolio":
        return n + backend_calls(method, settings)
    names = settings.backends
    waves: dict[int, set[int]] = {}
    for tl in timelines:
        before = dict.fromkeys(names, 0)
        for ev in tl["events"]:
            if ev["phase"] != "race":
                continue
            waves.setdefault(ev["rung"], set()).update(
                b for b, name in enumerate(names)
                if ev["pulls"][name] > before[name])
            before = ev["pulls"]
    plan = (lambda b, w: pf.race_plan(settings)[w][names[b]]) \
        if settings.allocator == "halving" else \
        (lambda b, w: pf.bandit_pull_plan(settings, b, 0))
    n += sum(backend_calls(names[b], plan(b, w))
             for w, bs in waves.items() for b in bs)
    final = pf.final_plan(settings)
    n += sum(backend_calls(name, final[name]) for name in
             {r.search["portfolio"]["winner"] for r in results})
    return n + (2 if settings.fidelity == "measured" else 0)


def se_launches_now(ops) -> int:
    return ops.job_objective.launches + ops.strategy_eval.launches


def reset_launches(ops) -> None:
    ops.job_objective.launches = 0
    for w in (*ops.KERNEL_WRAPPERS.values(), *ops.BACKWARD_WRAPPERS.values(),
              *ops.OPTIMIZER_WRAPPERS.values()):
        w.launches = 0


def phase_search(torch, port_core, ops, ref, dev, jobs, meta, exhaustive,
                 artifact, card) -> list[tuple]:
    """Phase 11: Sobol, GA, DE and the portfolio through their entry points
    on the card (each against the exhaustive optimum of phase 4 and its
    launch arithmetic), the bandit portfolio over the Fig. 7 jobs with the
    kernel and with the plain version, the halving allocator, and the
    measured-fidelity rung pinned and live.  Returns each path as (name,
    drive, strategy_eval launches) for phase 10."""
    from repro_torch import obs as port_obs
    from repro_torch import search as port_search
    from repro_torch.core import calibration as cal
    macro = port_core.get_macro("vanilla-dcim")
    wl = port_core.bert_large_workload()
    by = {m: r for r, m in zip(exhaustive, meta)}
    ex_energy = by[("bert-large", "st", "ee")].metrics["energy_pj"]
    sync = lambda: torch.cuda.synchronize() if dev.type == "cuda" else None
    paths: list[tuple] = []
    # every drive passes engine=: the engine is timed and counted, never
    # the service's store (a repeat would be a store hit)
    eng = port_core.default_engine(dev)

    def key_of(job, method, settings):
        return port_core.job_key(job, method, settings)

    def timelines(keys):
        return [port_obs.flight_recorder().timeline(k) for k in keys]

    def timed(drive):
        reset_launches(ops)
        sync()
        t0 = time.perf_counter()
        out = drive()
        sync()
        return out, time.perf_counter() - t0, se_launches_now(ops)

    def check_metrics(label, r):
        if not all(math.isfinite(r.metrics[k]) and r.metrics[k] > 0
                   for k in ("tops_w", "gops", "area_mm2", "energy_pj")):
            fail(f"{label}: non-finite metrics {r.metrics}")
        if r.metrics["area_mm2"] > FIG7_BUDGET_MM2 * 1.001:
            fail(f"{label}: over budget, {r.metrics['area_mm2']} mm^2")

    # 11.1 each method alone, co_explore's defaults, bert-large ee
    solo_job = lambda m: port_core.ExploreJob(
        macro, wl, FIG7_BUDGET_MM2, space=port_core.DesignSpace(),
        search_method=m)
    for m in SEARCH_METHODS:
        settings = port_search.get_backend(m).default_settings()
        drive = lambda m=m: port_core.co_explore(macro, wl, FIG7_BUDGET_MM2,
                                                 method=m, engine=eng)
        r, wall, n = timed(drive)
        check_metrics(m, r)
        ratio = r.metrics["energy_pj"] / ex_energy
        if ratio > SEARCH_TOL.get(m, 1.01):
            fail(f"{m}: energy {ratio:.5f}x the exhaustive optimum")
        want = search_launches(m, settings, [r], timelines(
            [key_of(solo_job(m), m, settings)]))
        if n != want:
            fail(f"{m}: {n} strategy_eval launches, its settings give {want}")
        extra = f"; pulls {json.dumps(r.search['portfolio']['pulls'])}, " \
            f"winner {r.search['portfolio']['winner']}" \
            if m == "portfolio" else ""
        print(f"[search] {m}: {r.summary()} in {wall:.3f} s, {n} launches "
              f"(= settings); energy {ratio:.5f}x exhaustive{extra}; {card}",
              flush=True)
        paths.append((f"{m} alone", drive, n))

    # 11.2 the bandit portfolio over the 28 Fig. 7 jobs, kernel and plain
    ps = port_search.PortfolioSettings()
    keys = [key_of(j, "portfolio", ps) for j in jobs]
    engine = port_core.ExplorationEngine(device=dev)
    drive = lambda: engine.run(jobs, method="portfolio", settings=ps,
                               keys=keys)
    res, wall, n = timed(drive)
    tls = timelines(keys)
    groups: dict[int, list[int]] = {}
    for i, j in enumerate(jobs):
        groups.setdefault(ops_bucket(j), []).append(i)
    want = sum(search_launches("portfolio", ps, [res[i] for i in idxs],
                               [tls[i] for i in idxs])
               for idxs in groups.values())
    if n != want:
        fail(f"Fig. 7 portfolio: {n} launches, its pulls give {want}")
    plain_engine = port_core.ExplorationEngine(
        device=dev, evaluator=ref.job_objective_ref)
    t0 = time.perf_counter()
    plain = plain_engine.run(jobs, method="portfolio", settings=ps, keys=keys)
    sync()
    wall_plain = time.perf_counter() - t0
    ratios = []
    for r, q, m in zip(res, plain, meta):
        if r.config != q.config or float(r.sa.best_value) != float(
                q.sa.best_value) or r.search["portfolio"]["pulls"] != \
                q.search["portfolio"]["pulls"]:
            fail(f"Fig. 7 portfolio {m}: kernel {r.config} "
                 f"{float(r.sa.best_value)!r} "
                 f"{r.search['portfolio']['pulls']} vs plain {q.config} "
                 f"{float(q.sa.best_value)!r} "
                 f"{q.search['portfolio']['pulls']}")
        check_metrics(f"Fig. 7 portfolio {m}", r)
        metric = "energy_pj" if m[2] == "ee" else "latency_cycles"
        ratios.append(r.metrics[metric] / by[m].metrics[metric])
        if ratios[-1] < 1 - 1e-6:
            fail(f"Fig. 7 portfolio {m} beat the exhaustive optimum: "
                 f"{ratios[-1]}")
    print("[search] Fig. 7 portfolio / exhaustive objective per job: "
          + ", ".join(f"{m[0]} {m[1]} {m[2]} {x:.5f}"
                      for m, x in zip(meta, ratios)))
    print(f"[search] Fig. 7 portfolio (bandit), {len(jobs)} jobs: wall "
          f"{wall:.3f} s with the kernel, {wall_plain:.3f} s with the plain "
          f"version; "
          f"{n} launches (= pulls); worst ratio {max(ratios):.5f}; configs, "
          f"best values and pulls identical to the plain version's; {card}",
          flush=True)
    paths.append(("Fig. 7 portfolio", drive, n))

    # 11.3 the halving allocator, twice; not worse than a rung-0 solo run
    hs = port_search.PortfolioSettings(allocator="halving")
    hjob = solo_job("portfolio")
    drive = lambda: port_core.co_explore(macro, wl, FIG7_BUDGET_MM2,
                                         method="portfolio", settings=hs,
                                         engine=eng)
    h1, wall, n = timed(drive)
    h2 = drive()
    if h1.config != h2.config or h1.metrics != h2.metrics or \
            h1.search["portfolio"] != h2.search["portfolio"]:
        fail("halving portfolio does not replay in one process")
    want = search_launches("portfolio", hs, [h1],
                           timelines([key_of(hjob, "portfolio", hs)]))
    if n != want:
        fail(f"halving portfolio: {n} launches, its pulls give {want}")
    rung0 = port_search.race_plan(hs)[0]
    best = float(h1.sa.best_value)
    for name in hs.backends:
        solo = port_core.co_explore(macro, wl, FIG7_BUDGET_MM2, method=name,
                                    settings=rung0[name], engine=eng)
        if best > float(solo.sa.best_value) or \
                h1.search["portfolio"]["race"][name] > float(
                    solo.sa.best_value):
            fail(f"halving portfolio worse than its rung-0 {name} run")
    check_metrics("halving", h1)
    print(f"[search] halving: {h1.summary()} in {wall:.3f} s, {n} launches; "
          f"replays; not worse than any rung-0 solo run; pulls "
          f"{json.dumps(h1.search['portfolio']['pulls'])}; {card}",
          flush=True)
    paths.append(("halving", drive, n))

    # 11.4 the measured-fidelity rung: pinned artifact, then live
    ms = port_search.PortfolioSettings(fidelity="measured")
    drive = lambda: port_core.co_explore(macro, wl, FIG7_BUDGET_MM2,
                                         method="portfolio", settings=ms,
                                         engine=eng)
    os.environ[cal.CALIBRATION_ENV] = str(artifact)
    cal.reset_calibration_state()
    pinned, wall, n = timed(drive)
    tf = pinned.search["two_fidelity"]
    if tf["source"] != "artifact" or not tf["analytic_ranking"] or \
            sorted(tf["measured_ranking"]) != list(range(tf["topk"])):
        fail(f"pinned measured rung: {json.dumps(tf)}")
    want = search_launches("portfolio", ms, [pinned], timelines(
        [key_of(solo_job("portfolio"), "portfolio", ms)]))
    if n != want:
        fail(f"measured portfolio: {n} launches, its pulls give {want}")
    tech = cal.DEFAULT_TECH.with_corrections(
        cal.load_calibration(str(artifact))[0])
    m = port_core.evaluate_config(macro, pinned.config, wl, tech=tech,
                                  device=dev)
    for k in ("energy_pj", "latency_cycles", "tops_w", "gops", "area_mm2"):
        if pinned.metrics[k] != m[k]:
            fail(f"measured winner {k}: {pinned.metrics[k]} vs "
                 f"evaluate_config under the corrected tech {m[k]}")
    print(f"[search] measured (pinned artifact {tf['calibration_version']}):"
          f" {pinned.summary()} in {wall:.3f} s, {n} launches; rank "
          f"correlation {tf['rank_correlation']:.4f} over top "
          f"{tf['topk']}; analytic winner {tf['analytic_winner']}, measured "
          f"winner {tf['measured_winner']}; metrics = evaluate_config under "
          f"the corrected tech; {card}", flush=True)
    paths.append(("measured, pinned", drive, n))

    live_key = []

    def live():
        pin = os.environ.pop(cal.CALIBRATION_ENV)
        cal.reset_calibration_state()
        try:
            # the key the engine computes: nothing measured yet ("live")
            live_key[:] = [key_of(solo_job("portfolio"), "portfolio", ms)]
            return drive()
        finally:
            os.environ[cal.CALIBRATION_ENV] = pin
            cal.reset_calibration_state()
    live_r, wall, n = timed(live)
    launched = {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()}
    want = search_launches("portfolio", ms, [live_r], timelines(live_key))
    if ops.job_objective.launches != want:
        fail(f"live measured portfolio: {ops.job_objective.launches} "
             f"launches, its pulls give {want}")
    if live_r.search["two_fidelity"]["source"] != "live":
        fail(f"unpinned measured rung: source "
             f"{live_r.search['two_fidelity']['source']}")
    if not all(launched[k] > 0 for k in NEW_KERNELS):
        fail(f"the live measured rung launched no kernel for some wrapper: "
             f"{launched}")
    check_metrics("measured, live", live_r)
    print(f"[search] measured (live fit "
          f"{live_r.search['two_fidelity']['calibration_version']}): "
          f"{live_r.summary()} in {wall:.3f} s; launches "
          f"{json.dumps(launched)} (job_objective "
          f"{ops.job_objective.launches})"
          f"; {card}", flush=True)
    paths.append(("measured, live", live, n))
    return paths


#: the ten schedule sums held against the closed form's fields
#: (tests/test_cost_vs_compiler.py)
SCHEDULE_VS_COST = dict(
    v_bits="v_ema_bits", s_bits="s_ema_bits", spill_bits="spill_ema_bits",
    y_bits="y_ema_bits", is_rd_bits="is_rd_bits", is_wr_bits="is_wr_bits",
    os_rd_bits="os_rd_bits", os_wr_bits="os_wr_bits",
    compute_cycles="compute_cycles", update_cycles="update_cycles",
)
#: small operators whose address-level traces phase 13.2 replays
TRACE_CASES = (((2, 2, 4, 8, 2), (37, 200, 150)),
               ((1, 1, 2, 4, 1), (9, 70, 40)),
               ((3, 2, 16, 64, 8), (21, 500, 120)))
#: phase 13.5's checkpoint: after this round, then resumed to the end
RESUME_AFTER = 4


def phase_verify(torch, port_core, ops, dev, jobs, meta, exhaustive, engine,
                 card) -> tuple[list[tuple], int]:
    """Phase 13: verify and scale.  The instruction-flow compiler against
    the kernel on phase 4's 28 winners (schedule sums equal to the fp64
    closed form on the card, the cycle simulator inside its bounds, the
    simulation gap), trace replay, the systolic baseline, the single-job
    SA / exhaustive API with a kernel objective, and the distributed DSE
    on 1 and 4 slots with checkpoint, resume and elastic resume.  The SA,
    exhaustive and distributed runs are each held against the same run
    with the plain version on the same device, and each SA and distributed
    run has one traced repeat for the device's busy share.  Returns
    the paths phase 10 re-drives as (name, drive, strategy_eval launches),
    and the launches of the runs it does not re-drive."""
    import tempfile

    from repro_torch.core import compiler, cost_model, distributed, systolic
    from repro_torch.core.pruning import candidates_with_bw, prune_space
    from repro_torch.kernels import ref
    sync = lambda: torch.cuda.synchronize() if dev.type == "cuda" else None
    t_phase = time.perf_counter()
    paths: list[tuple] = []
    macro = jobs[0].macro
    rows = [np.array([[*r.config.as_tuple(), r.config.bw]], np.float64)
            for r in exhaustive]
    # each job's exhaustive optimum as an objective value (fp32, the sweep's)
    optimum = [float(v[0]) for v in engine.candidate_values(jobs, rows)]

    # ---- 13.1 the compiler against the kernel ----------------------------
    buckets: dict[int, list[int]] = {}
    for i, j in enumerate(jobs):
        buckets.setdefault(ops_bucket(j), []).append(i)
    strat: dict[int, np.ndarray] = {}
    kernel_lat: dict[int, float] = {}

    def winners_strategies():
        for idxs in buckets.values():
            job = cost_model.stack_job_params([job_rows(jobs[i]) for i in idxs],
                                              torch.float32, dev)
            cand = torch.as_tensor(np.stack([rows[i] for i in idxs]),
                                   dtype=torch.float32).to(dev)
            _, lat, _, idx = ops.job_objective(job, cand, 1e3, totals=True)
            for jx, i in enumerate(idxs):
                strat[i] = idx[jx, 0].cpu().numpy()
                kernel_lat[i] = float(lat[jx, 0])
    reset_launches(ops)
    winners_strategies()
    sync()
    paths.append(("13.1 winners' strategies", winners_strategies,
                  se_launches_now(ops)))

    t0 = time.perf_counter()
    compiled, over = [], collections.Counter()
    for i, (job, r) in enumerate(zip(jobs, exhaustive)):
        wl_ops = job.merged_workload().ops
        names = [str(port_core.ALL_STRATEGIES[s])
                 for s in strat[i][:len(wl_ops)]]
        if names != list(r.per_op_strategy.values()):
            fail(f"{meta[i]}: the kernel's strategies {names} differ from "
                 f"phase 4's {list(r.per_op_strategy.values())}")
        for op, s_idx in zip(wl_ops, strat[i]):
            s = port_core.ALL_STRATEGIES[int(s_idx)]
            args = (macro, r.config, op.m, op.k, op.n, s)
            if compiler.schedule_sets(*args) > compiler.MAX_SETS:
                over[i] += 1
                continue
            compiled.append((i, op, s, compiler.compile_schedule(*args)))
    compile_s = time.perf_counter() - t0
    n_sets = sum(len(rec["planes"]) for *_, rec in compiled)

    # the closed form of every compiled operator in one fp64 call on dev
    col = lambda f: torch.tensor([f(i, op, s) for i, op, s, _ in compiled],
                                 dtype=torch.float64, device=dev)
    cfg_of = lambda i: exhaustive[i].config
    cb = cost_model.matmul_cost(
        col(lambda i, op, s: op.m), col(lambda i, op, s: op.k),
        col(lambda i, op, s: op.n), col(lambda i, op, s: s.spatial == "R"),
        col(lambda i, op, s: s.temporal == "WP"),
        col(lambda i, op, s: s.tiling == "PF"),
        *[col(lambda i, op, s, f=f: getattr(cfg_of(i), f))
          for f in ("mr", "mc", "scr", "is_kb", "os_kb", "bw")],
        1.0, macro, dtype=torch.float64, device=dev)
    closed = {f: getattr(cb, c).cpu().numpy()
              for f, c in SCHEDULE_VS_COST.items()}
    for n, (i, op, s, rec) in enumerate(compiled):
        tot = compiler.schedule_totals(rec)
        for f in SCHEDULE_VS_COST:
            if tot[f] != closed[f][n]:
                fail(f"{meta[i]} op {(op.m, op.k, op.n)} {s}: schedule {f} "
                     f"{tot[f]} != closed form {closed[f][n]!r} (fp64)")

    t0 = time.perf_counter()
    sim_total: collections.Counter = collections.Counter()
    for i, op, s, rec in compiled:
        cfg = cfg_of(i)
        overlap = bool(macro.update_during_compute) and cfg.scr >= 2
        sim = port_core.simulate_schedule(rec, cfg.bw, overlap, device=dev,
                                          dtype=torch.float64)
        lb, ub = port_core.analytic_latency_bounds(rec, cfg.bw)
        if not lb <= sim["latency_cycles"] <= ub:
            fail(f"{meta[i]} op {(op.m, op.k, op.n)} {s}: simulated "
                 f"{sim['latency_cycles']} outside [{lb}, {ub}]")
        sim_total[i] += op.count * sim["latency_cycles"]
    sim_s = time.perf_counter() - t0
    gaps = [sim_total[i] / kernel_lat[i] for i in range(len(jobs))
            if not over[i]]
    print(f"[verify] 13.1: {len(compiled)} operators of the 28 winners "
          f"compiled under the kernel's strategies ({n_sets} sets, "
          f"{compile_s:.2f} s); schedule sums equal the fp64 closed form on "
          f"the card in all ten fields; every simulated latency inside its "
          f"bounds ({sim_s:.2f} s); operators over MAX_SETS = "
          f"{compiler.MAX_SETS} (refused, not simulated) per job: "
          + ", ".join(f"{' '.join(m)} {over[i]}" for i, m in enumerate(meta)))
    print("[verify] 13.1 simulation gap, sum(count x simulated latency) / "
          "kernel total latency, per job: " + "; ".join(
              f"{' '.join(meta[i])} {sim_total[i] / kernel_lat[i]:.5f}"
              for i in range(len(jobs)) if not over[i])
          + (f"; range {min(gaps):.5f}-{max(gaps):.5f}" if gaps else ""))

    # ---- 13.2 trace replay -------------------------------------------------
    rng = np.random.default_rng(7)
    replayed = 0
    for cfg_t, (m, k, n) in TRACE_CASES:
        cfg = port_core.AcceleratorConfig(*cfg_t)
        x = rng.integers(-4, 4, (m, k)).astype(np.float64)
        w = rng.integers(-4, 4, (k, n)).astype(np.float64)
        for s in port_core.ALL_STRATEGIES:
            if not port_core.strategy_feasible(macro, cfg, m, k, n, s):
                continue
            y = port_core.replay_trace(
                port_core.compile_trace(macro, cfg, m, k, n, s), x, w,
                macro, cfg, s)
            if not np.array_equal(y, x @ w):
                fail(f"trace replay of {s} on {(m, k, n)} is not x @ w")
            replayed += 1
    print(f"[verify] 13.2: {replayed} traces replayed under all 8 "
          "strategies, each equal to x @ w")

    # ---- 13.3 the systolic baseline (Fig. 1) -------------------------------
    sweep = systolic.buffer_sweep(area_budget_mm2=5.0, m=512, k=2048, n=2048)
    best = min(sweep, key=lambda r: r["total_cycles"])
    print("[verify] 13.3 Fig. 1 buffer sweep, 5 mm^2, 512x2048x2048 (buf KB: "
          "total cycles): " + ", ".join(
              f"{r['buf_kb']}: {r['total_cycles']}" for r in sweep)
          + f"; argmin {best['buf_kb']} KB ({best['rows']}x{best['cols']} "
          "PEs)")

    # ---- 13.4 the single-job API on bert-large, kernel objective -----------
    i_bert = meta.index(("bert-large", "st", "ee"))
    jb = jobs[i_bert]
    jp = cost_model.stack_job_params([job_rows(jb)], torch.float32, dev)
    fn = ops.objective_fn(jp)
    # the same objective through the plain version, on the same device
    plain_fn = lambda cfg: ref.job_objective_ref(
        jp, cfg.reshape(1, -1, cfg.shape[-1]).contiguous()).reshape(
            cfg.shape[:-1])
    settings = engine.sa_settings                # phase 6's
    run_sa = lambda f: port_core.simulated_annealing(
        f, jb.design_space(), jb.bw, settings, device=dev)
    reset_launches(ops)
    sync()
    t0 = time.perf_counter()
    sa = run_sa(fn)
    sync()
    sa_s = time.perf_counter() - t0
    sa_launches = se_launches_now(ops)
    ratio = float(sa.best_value) / optimum[i_bert]
    if ratio > 1.01:
        fail(f"simulated_annealing is {ratio:.5f}x the exhaustive optimum")
    if sa_launches != settings.n_steps + 1:
        fail(f"simulated_annealing made {sa_launches} launches, expected "
             f"{settings.n_steps + 1}")
    t0 = time.perf_counter()
    sa_plain = run_sa(plain_fn)
    sync()
    sa_plain_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(sa, sa_plain)):
        fail("simulated_annealing with the kernel differs from the same run "
             "with the plain version: best per chain "
             f"{sa.best_per_chain.tolist()} vs "
             f"{sa_plain.best_per_chain.tolist()}")
    sa_busy = traced_busy(torch, lambda: run_sa(fn), sync)
    paths.append(("13.4 simulated_annealing", lambda: run_sa(fn),
                  sa_launches))
    cands, _ = prune_space(jb.design_space(), jb.macro, jb.area_budget_mm2,
                           jb.bw, jb.tech)
    cands = candidates_with_bw(cands, jb.bw)
    reset_launches(ops)
    sync()
    t0 = time.perf_counter()
    best_cfg, best_val = port_core.exhaustive_search(fn, cands, device=dev)
    sync()
    ex_s = time.perf_counter() - t0
    ex_launches = se_launches_now(ops)
    if not (np.array_equal(best_cfg, rows[i_bert][0])
            and best_val == optimum[i_bert]):
        fail(f"exhaustive_search found {best_cfg} ({best_val!r}), phase 4 "
             f"{rows[i_bert][0]} ({optimum[i_bert]!r})")
    plain_cfg, plain_val = port_core.exhaustive_search(plain_fn, cands,
                                                       device=dev)
    if not (np.array_equal(best_cfg, plain_cfg) and best_val == plain_val):
        fail(f"exhaustive_search with the kernel found {best_cfg} "
             f"({best_val!r}), with the plain version {plain_cfg} "
             f"({plain_val!r})")
    paths.append(("13.4 exhaustive_search", lambda: port_core
                  .exhaustive_search(fn, cands, device=dev), ex_launches))
    print(f"[verify] 13.4 bert-large: simulated_annealing "
          f"{[float(x) for x in sa.best_cfg]} at {ratio:.5f}x phase 4's "
          f"optimum, {sa_launches} launches, {sa_s:.3f} s, every chain's best "
          f"and the trace equal to the run with the plain version on the "
          f"card ({sa_plain_s:.3f} s); traced repeat: {busy_text(*sa_busy)}; "
          f"exhaustive_search over {len(cands)} pruned candidates equals "
          f"phase 4's winner and value bit for bit ({best_val!r}) and the "
          f"plain version's, {ex_launches} launches, {ex_s:.3f} s; {card}")

    # ---- 13.5 the distributed DSE on 1 and 4 slots -------------------------
    sa_d = port_core.SASettings()
    kw = dict(settings=sa_d, chains_per_device=4, rounds=8, sync_every=50)
    n_jobs = len(jobs)
    expect = lambda slots, rounds: slots * (1 + rounds * kw["sync_every"])
    extra = 0
    def same_state(a_dir: str, b_dir: str) -> bool:
        with np.load(os.path.join(a_dir, "dse_state.npz")) as a, \
                np.load(os.path.join(b_dir, "dse_state.npz")) as b:
            return sorted(a.files) == sorted(b.files) and all(
                np.array_equal(a[f], b[f]) for f in a.files)

    def same_results(xs, ys) -> bool:
        return all(x.config == y.config and x.best_value == y.best_value
                   and x.trace == y.trace for x, y in zip(xs, ys))

    with tempfile.TemporaryDirectory(prefix="cim-tuner-dse-") as tmp:
        ckpt = {name: os.path.join(tmp, name)
                for name in ("1", "plain1", "full", "plain4", "cut",
                             "elastic")}
        for slots in (1, 4):
            mesh = [dev] * slots
            k_dir = ckpt["full" if slots == 4 else "1"]
            reset_launches(ops)
            sync()
            t0 = time.perf_counter()
            res = distributed.distributed_co_explore_jobs(
                mesh, jobs, checkpoint_dir=k_dir, **kw)
            sync()
            wall = time.perf_counter() - t0
            launches = se_launches_now(ops)
            if launches != expect(slots, kw["rounds"]):
                fail(f"distributed on {slots} slots: {launches} launches, "
                     f"expected {expect(slots, kw['rounds'])}")
            for r, m in zip(res, meta):
                if len(r.trace) != kw["rounds"] or any(
                        b > a for a, b in zip(r.trace, r.trace[1:])):
                    fail(f"distributed {m}: trace {r.trace} not monotone")
            # the same run with the plain version on the same device: the
            # draws are the same, so every config, best, trace and the
            # final population must be too
            t0 = time.perf_counter()
            plain = distributed.distributed_co_explore_jobs(
                mesh, jobs, checkpoint_dir=ckpt[f"plain{slots}"],
                evaluator=ref.job_objective_ref, **kw)
            sync()
            plain_wall = time.perf_counter() - t0
            if not same_results(res, plain):
                fail(f"distributed on {slots} slots: the kernel run's "
                     "configs, bests or traces differ from the plain "
                     "version's")
            if not same_state(k_dir, ckpt[f"plain{slots}"]):
                fail(f"distributed on {slots} slots: the kernel run's final "
                     "population differs from the plain version's")
            busy = traced_busy(torch, lambda mesh=mesh: distributed
                               .distributed_co_explore_jobs(mesh, jobs, **kw),
                               sync)
            ratios = [r.best_value / optimum[i] for i, r in enumerate(res)]
            print(f"[verify] 13.5 distributed_co_explore_jobs, 28 Fig. 7 "
                  f"jobs, {slots} slot(s) of {dev}: {launches} launches = "
                  f"{slots} x (1 + {kw['rounds']} x {kw['sync_every']}), "
                  f"wall {wall:.3f} s; configs, bests, traces and final "
                  f"population equal to the run with the plain version on "
                  f"the card (wall {plain_wall:.3f} s); traced repeat: "
                  f"{busy_text(*busy)}; ratio to phase 4's optimum "
                  f"{min(ratios):.5f}-{max(ratios):.5f}: " + ", ".join(
                      f"{' '.join(m)} {q:.5f}" for m, q in zip(meta, ratios))
                  + f"; {card}", flush=True)
            paths.append((f"13.5 distributed, {slots} slot(s)",
                          lambda mesh=mesh: distributed
                          .distributed_co_explore_jobs(mesh, jobs, **kw),
                          launches))

        # checkpoint after RESUME_AFTER rounds, resume to the end on 4 slots
        # (must equal the uninterrupted run), and elastically on 1
        mesh4 = [dev] * 4
        reset_launches(ops)
        distributed.distributed_co_explore_jobs(
            mesh4, jobs, checkpoint_dir=ckpt["cut"],
            **dict(kw, rounds=RESUME_AFTER))
        shutil.copytree(ckpt["cut"], ckpt["elastic"])
        resumed = distributed.distributed_co_explore_jobs(
            mesh4, jobs, checkpoint_dir=ckpt["cut"], resume=True, **kw)
        sync()
        cut_launches = se_launches_now(ops)
        want = expect(4, RESUME_AFTER) + 4 * (kw["rounds"] - RESUME_AFTER) \
            * kw["sync_every"]
        if cut_launches != want:
            fail(f"checkpoint + resume: {cut_launches} launches, expected "
                 f"{want}")
        if not same_state(ckpt["full"], ckpt["cut"]):
            fail("the resumed run's final population differs from the "
                 "uninterrupted run's")
        if not same_results(resumed, res):
            fail("the resumed run's results differ from the uninterrupted "
                 "run's")
        reset_launches(ops)
        elastic = distributed.distributed_co_explore_jobs(
            [dev], jobs, checkpoint_dir=ckpt["elastic"], resume=True, **kw)
        sync()
        el_launches = se_launches_now(ops)
        if any(len(r.trace) != kw["rounds"] for r in elastic):
            fail("the elastic resume did not run to the last round")
        extra = cut_launches + el_launches
        worst = max(r.best_value / optimum[i] for i, r in enumerate(elastic))
        print(f"[verify] 13.5 checkpoint after round {RESUME_AFTER} and "
              f"resume on 4 slots: final population and results equal to "
              f"the uninterrupted run's ({cut_launches} launches); elastic "
              f"resume 4 -> 1 slot ran to round {kw['rounds']} "
              f"({el_launches} launches, worst job {worst:.5f}x its "
              "optimum)")
    print(f"[verify] phase 13 took {time.perf_counter() - t_phase:.1f} s; "
          f"{n_jobs} jobs; {card}", flush=True)
    return paths, extra


def http_json(url: str, payload=None, timeout: float = 60.0):
    """GET (or POST ``payload`` as JSON) ``url``; the decoded answer."""
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def sse_events(url: str, timeout: float) -> list[tuple[str, dict, float]]:
    """Every ``(event, data, seconds since the request)`` of one SSE
    stream, up to its ``end`` event (the server closes the stream by
    ``timeout``; each socket read is bounded too)."""
    import urllib.request
    t0 = time.perf_counter()
    out, event, data = [], None, []
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().rstrip("\r\n")
            if line.startswith("event:"):
                event = line[6:].strip()
            elif line.startswith("data:"):
                data.append(line[5:].strip())
            elif not line and data:
                out.append((event, json.loads("".join(data)),
                            time.perf_counter() - t0))
                if event == "end":
                    break
                event, data = None, []
    if not out or out[-1][0] != "end":
        fail(f"SSE stream {url} ended without an end event")
    if out[-1][1].get("remaining"):
        fail(f"SSE stream {url} timed out: {out[-1][1]}")
    return out


def prometheus_families(text: str) -> set[str]:
    """The families of a Prometheus text exposition; fails on a line that
    is neither a comment nor ``name{labels} value`` (exemplars allowed)."""
    sample = re.compile(r"^[A-Za-z_:][\w:]*(\{[^}]*\})?\s+(\S+)(\s+\S+)?$")
    families = set()
    for n, line in enumerate(text.splitlines(), 1):
        if line.startswith("# TYPE "):
            families.add(line.split()[2])
        if not line or line.startswith("#"):
            continue
        m = sample.match(line.split(" # ", 1)[0])
        if m is None:
            fail(f"/v1/metrics line {n} is not Prometheus text: {line!r}")
        float(m.group(2))
    return families


def wait_for(cond, what: str, timeout: float, step: float = 0.005):
    """Poll ``cond()`` until it is true; fail after ``timeout`` s."""
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            fail(f"timed out after {timeout} s waiting for {what}")
        time.sleep(step)


def phase_service(torch, port_core, ops, dev, jobs, meta, results,
                  sweep_wall, card) -> int:
    """Phase 12: the DSE service on the card.  An in-process
    ``DSEServer`` (so the launch counters can be read) over a fresh store:
    the 28 Fig. 7 exhaustive jobs over HTTP against phase 4's results, the
    warm store, continuous batching of portfolio jobs into a running race
    against their solo runs, pareto / metrics / timeline, then the
    ``serve`` and ``explore`` CLI as subprocesses and SIGTERM.  Returns
    the strategy_eval launches of its cold run (12.1)."""
    import dataclasses
    import signal
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs as port_obs
    from repro_torch import search as port_search
    from repro_torch import service as port_service
    from repro_torch.service.server import DSEServer, ServerConfig
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="cim-tuner-smoke-service-"))
    engine = port_core.ExplorationEngine(device=dev)
    # the default QueueConfig: a POST holds the window open until its
    # last spec is admitted, so one window takes all 28
    client = port_service.ServiceClient(
        engine=engine, store=port_service.ResultStore(str(tmp / "store")))
    srv = DSEServer(client=client,
                    config=ServerConfig(port=0, stream_ping_s=1.0)).start()
    url = srv.url
    stats = lambda: http_json(f"{url}/v1/stats", timeout=30)
    # a result as the wire carries it (JSON lists for tuples)
    ser = lambda r: json.loads(json.dumps(port_service.serialize_result(r)))
    try:
        # 12.1 the 28 Fig. 7 jobs, posted as specs, read back over SSE
        specs = [port_service.job_to_spec(j, "exhaustive") for j in jobs]
        buckets = {ops_bucket(j) for j in jobs}
        d0 = stats()["queue"]["dispatches"]
        reset_launches(ops)
        t0 = time.perf_counter()
        posted = http_json(f"{url}/v1/jobs", specs)["jobs"]
        keys = [s["key"] for s in posted]
        events = sse_events(f"{url}/v1/stream?keys={','.join(keys)}"
                            "&timeout=300", timeout=330)
        http_wall = time.perf_counter() - t0
        launched = se_launches_now(ops)
        if launched == 0:
            fail("the service launched no strategy_eval kernel")
        dispatches = stats()["queue"]["dispatches"] - d0
        if dispatches != len(buckets):
            fail(f"28 Fig. 7 jobs in {dispatches} dispatches, not one per "
                 f"bucket ({len(buckets)})")
        index = {k: i for i, k in enumerate(keys)}
        records, order = {}, []
        for event, obj, at in events[:-1]:
            if event != "result" or obj["status"] != "done":
                fail(f"service stream: {event} {json.dumps(obj)[:300]}")
            i = index[obj["key"]]
            records[i] = obj["result"]
            order.append((i, at))
        if sorted(records) != list(range(len(jobs))):
            fail("the service stream missed a job")
        for i, r in enumerate(results):
            want = ser(r)
            got = records[i]
            for field in ("config", "per_op_strategy", "metrics"):
                if got[field] != want[field]:
                    fail(f"service {meta[i]} {field}: {got[field]} vs phase "
                         f"4's {want[field]}")
        # the stream arrives bucket by bucket, each at its own time
        seq = [ops_bucket(jobs[i]) for i, _ in order]
        runs = [b for n, b in enumerate(seq) if n == 0 or seq[n - 1] != b]
        if len(runs) != len(buckets):
            fail(f"service results interleave buckets: {seq}")
        done_at = {b: max(at for i, at in order if ops_bucket(jobs[i]) == b)
                   for b in buckets}
        print("[service] 12.1 completion order: " + ", ".join(
            f"P={b} ({seq.count(b)} jobs, last at {done_at[b]:.4f} s)"
            for b in runs))
        print(f"[service] 12.1 28 Fig. 7 jobs over HTTP: {http_wall:.4f} s "
              f"(phase 4 in process, median: {sweep_wall:.4f} s), "
              f"{dispatches} dispatches (one per bucket, window "
              f"{client.queue.config.batch_window_s} s), {launched} "
              f"strategy_eval launches; configs, per-operator strategies "
              f"and metrics equal phase 4's bit for bit; {card}",
              flush=True)

        # 12.1 again on the emptied store, traced: the device's busy time
        # (torch.profiler) and the service's own spans (the POST, the
        # window, each bucket's engine.run, persisting, the stream)
        client.store.clear()
        d1 = stats()["queue"]["dispatches"]
        port_obs.tracer().clear()
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            keys2 = [s["key"] for s in
                     http_json(f"{url}/v1/jobs", specs)["jobs"]]
            events2 = sse_events(f"{url}/v1/stream?keys={','.join(keys2)}"
                                 "&timeout=300", timeout=330)
            torch.cuda.synchronize()
            traced_wall = time.perf_counter() - t0
        if keys2 != keys or stats()["queue"]["dispatches"] - d1 != dispatches:
            fail("the traced repeat of 12.1 did not run as the first did")
        for event, obj, _ in events2[:-1]:
            got, want = obj["result"], records[index[obj["key"]]]
            if any(got[f] != want[f]
                   for f in ("config", "per_op_strategy", "metrics")):
                fail(f"traced repeat differs for {obj['key']}")
        busy_us = device_us(torch, trace)
        spans = port_obs.tracer().events()
        span = lambda name, **a: [e for e in spans if e["name"] == name
                                  and all(e["args"].get(k) == v
                                          for k, v in a.items())]
        post = span("server.request", endpoint="/v1/jobs", method="POST")
        batch = span("queue.batch")
        runs = span("engine.run")
        sse = span("server.request", endpoint="/v1/stream")
        if (len(post), len(batch), len(runs), len(sse)) != \
                (1, 1, len(buckets), 1):
            fail(f"12.1 spans: {len(post)} POST, {len(batch)} batches, "
                 f"{len(runs)} engine runs, {len(sse)} streams")
        end = lambda e: e["ts"] + e["dur"]
        run_ms = [e["dur"] / 1e3 for e in sorted(runs, key=lambda e: e["ts"])]
        parts = {
            "POST (parse, key, probe the store, enqueue)": post[0]["dur"],
            "POST end to dispatch (window)": batch[0]["ts"] - end(post[0]),
            "engine.run, " + " + ".join(f"{t:.2f}" for t in run_ms) + " ms":
                sum(e["dur"] for e in runs),
            "rest of the dispatch (bucket, persist, resolve)":
                batch[0]["dur"] - sum(e["dur"] for e in runs),
            "dispatch end to the stream's end": end(sse[0]) - end(batch[0]),
        }
        parts["client and HTTP, the rest of the wall"] = \
            traced_wall * 1e6 - (end(sse[0]) - post[0]["ts"])
        print(f"[service] 12.1 traced repeat: wall {traced_wall:.4f} s, "
              f"device busy {busy_us / 1e3:.3f} ms: busy share "
              + (f"{busy_us * 1e-6 / traced_wall:.4f}" if busy_us
                 else "not measured (no device time in the trace)")
              + "; spans (ms): " + "; ".join(
                  f"{k} {v / 1e3:.3f}" for k, v in parts.items())
              + f"; {card}", flush=True)

        # 12.2 the same 28 specs again: every job from the store
        reset_launches(ops)
        t0 = time.perf_counter()
        warm = http_json(f"{url}/v1/jobs", specs)["jobs"]
        warm_wall = time.perf_counter() - t0
        if any(s["status"] != "done" or s["source"] != "store"
               for s in warm):
            fail("a resubmitted job was not answered from the store: "
                 + json.dumps([(s["status"], s.get("source"))
                               for s in warm]))
        if any(s["result"][f] != records[i][f] for i, s in enumerate(warm)
               for f in ("config", "per_op_strategy", "metrics")):
            fail("store answers differ from the cold run's records")
        if stats()["queue"]["dispatches"] - d1 != dispatches or \
                se_launches_now(ops):
            fail("the warm resubmission reached the engine")
        print(f"[service] 12.2 warm store: 28 of 28 from the store in "
              f"{warm_wall:.4f} s, 0 new dispatches, 0 launches; {card}",
              flush=True)

        # 12.3 continuous batching: late portfolio jobs join a running race
        ps = port_search.PortfolioSettings()
        lead = meta.index(("bert-large", "st", "ee"))
        late = [i for i, m in enumerate(meta)
                if m[0] != "bert-large" and m[1:] == ("st", "ee")
                and ops_bucket(jobs[i]) == ops_bucket(jobs[lead])][:3]
        if len(late) != 3:
            fail(f"fewer than 3 P={ops_bucket(jobs[lead])} Fig. 7 jobs")
        solo = {i: engine.run([jobs[i]], method="portfolio",
                              settings=ps)[0] for i in [lead, *late]}
        spec = lambda i: port_service.job_to_spec(jobs[i], "portfolio",
                                                  settings=ps)
        admitted0 = stats()["scheduler"]["admitted"]
        t0 = time.perf_counter()
        race_keys = [http_json(f"{url}/v1/jobs", [spec(lead)])
                     ["jobs"][0]["key"]]
        wait_for(lambda: client.queue.stats_snapshot()["scheduler"]
                 ["inflight_groups"] == 1, "the race to start", 30)
        for i in late:
            race_keys.append(http_json(f"{url}/v1/jobs", [spec(i)])
                             ["jobs"][0]["key"])
            time.sleep(0.05)
        raced = {obj["key"]: obj for event, obj, _ in sse_events(
            f"{url}/v1/stream?keys={','.join(race_keys)}&timeout=300",
            timeout=330) if event == "result"}
        race_wall = time.perf_counter() - t0
        admitted = stats()["scheduler"]["admitted"] - admitted0
        if admitted < 1:
            fail("no late portfolio job was admitted into the running race")
        for i, key in zip([lead, *late], race_keys):
            got, want = raced[key]["result"], ser(solo[i])
            for field in ("config", "metrics"):
                if got[field] != want[field]:
                    fail(f"raced {meta[i]} {field} differs from its solo "
                         f"run: {got[field]} vs {want[field]}")
            if got["search"]["portfolio"] != want["search"]["portfolio"]:
                fail(f"raced {meta[i]} portfolio (winner, best, pulls) "
                     f"differs from its solo run: "
                     f"{got['search']['portfolio']} vs "
                     f"{want['search']['portfolio']}")
        print(f"[service] 12.3 continuous batching: bert-large bandit "
              f"portfolio + 3 late P={ops_bucket(jobs[lead])} jobs "
              f"({', '.join(meta[i][0] for i in late)}), {admitted} "
              f"admitted into the running race; wall {race_wall:.4f} s; "
              f"each equals its solo engine= run (config, final best, "
              f"pulls); {card}", flush=True)

        # 12.4 pareto, metrics, timeline
        macro = port_core.get_macro("vanilla-dcim")
        wl = port_core.bert_large_workload()
        fronts = [obj for event, obj, _ in sse_events(
            f"{url}/v1/pareto?macro=vanilla-dcim&workloads=bert-large"
            f"&area_budget_mm2={FIG7_BUDGET_MM2}&timeout=120", timeout=150)
            if event == "frontier"]
        want = port_core.pareto_explore(macro, wl, FIG7_BUDGET_MM2,
                                        engine=engine)
        got = fronts[0]["frontier"] if len(fronts) == 1 else None
        if got != [{"config": dataclasses.asdict(p["config"]),
                    "gops": p["gops"], "tops_w": p["tops_w"]}
                   for p in want]:
            fail(f"/v1/pareto frontier differs from pareto_explore's: "
                 f"{json.dumps(fronts)[:400]}")
        import urllib.request
        with urllib.request.urlopen(f"{url}/v1/metrics", timeout=30) as resp:
            families = prometheus_families(resp.read().decode())
        need = {"cim_queue_submitted_total", "cim_queue_dispatches_total",
                "cim_engine_jobs_total", "cim_sched_admissions_total",
                "cim_http_requests_total"}
        if len(families) < 12 or not need <= families:
            fail(f"/v1/metrics families: {sorted(families)}")
        tl = http_json(f"{url}/v1/jobs/{race_keys[0]}/timeline")["timeline"]
        if tl["method"] != "portfolio" or not tl["events"]:
            fail(f"portfolio timeline: {json.dumps(tl)[:300]}")
        t_h = []
        for _ in range(5):
            t1 = time.perf_counter()
            health = http_json(f"{url}/healthz", timeout=10)
            t_h.append(time.perf_counter() - t1)
        if health.get("port") != "repro_torch" or \
                health.get("device_type") != dev.type:
            fail(f"/healthz: {health}")
        print(f"[service] 12.4 /v1/pareto: {len(got)} frontier points equal "
              f"pareto_explore(engine=) bit for bit; /v1/metrics "
              f"{len(families)} families parse; timeline of the race: "
              f"{len(tl['events'])} events; /healthz round trip "
              f"{statistics.median(t_h) * 1e3:.3f} ms (median of 5), device "
              f"{health['device']}; {card}", flush=True)
    finally:
        srv.shutdown(drain=False)
        client.queue.close(timeout=60)

    # 12.5 the CLI: serve on the card, explore against it, SIGTERM
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CIM_TUNER_RESULT_STORE=str(tmp / "serve-store"))
    env.pop("CIM_TUNER_SERVICE_URL", None)
    port_file = tmp / "port.txt"
    t0 = time.perf_counter()
    server = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "serve", "--port",
         "0", "--port-file", str(port_file), "--device", dev.type],
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        wait_for(lambda: port_file.exists() and port_file.read_text()
                 or server.poll() is not None, "serve to bind", 120, 0.05)
        if server.poll() is not None:
            fail(f"serve exited {server.returncode}:\n"
                 f"{server.communicate(timeout=30)[0]}")
        cli_url = f"http://127.0.0.1:{port_file.read_text().strip()}"

        def healthy():
            try:
                return http_json(f"{cli_url}/healthz", timeout=5)
            except OSError:
                return None
        wait_for(healthy, "serve's first healthy answer", 120, 0.05)
        first_healthy = time.perf_counter() - t0
        if healthy().get("device_type") != dev.type:
            fail(f"serve is not on {dev.type}: {healthy()}")
        pick = [meta.index(("bert-large", "st", o)) for o in ("ee", "th")]
        jobs_file = tmp / "jobs.json"
        jobs_file.write_text(json.dumps([specs[i] for i in pick]))
        t1 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.service", "explore",
             str(jobs_file), "--url", cli_url, "--json", "--device",
             dev.type], cwd=ROOT,
            env=dict(env, CIM_TUNER_RESULT_STORE=str(tmp / "client-store")),
            capture_output=True, text=True, timeout=300)
        explore_wall = time.perf_counter() - t1
        if proc.returncode != 0:
            fail(f"explore --url exited {proc.returncode}:\n{proc.stderr}")
        out = [json.loads(line) for line in proc.stdout.splitlines()]
        if len(out) != 2 or any(
                rec["result"][f] != records[i][f] for rec, i in zip(out, pick)
                for f in ("config", "per_op_strategy", "metrics")):
            fail(f"explore --json output differs from 12.1's records:\n"
                 f"{proc.stdout[:600]}")
        t1 = time.perf_counter()
        server.send_signal(signal.SIGTERM)
        served, _ = server.communicate(timeout=30)
        stop_wall = time.perf_counter() - t1
        if server.returncode != 0 or "draining" not in served:
            fail(f"serve on SIGTERM: exit {server.returncode}:\n{served}")
    finally:
        if server.poll() is None:
            server.kill()
            server.communicate(timeout=30)
    shutil.rmtree(tmp, ignore_errors=True)
    # the client's own clock starts once it is built: the rest of the
    # wall is the client process's start (imports, /healthz)
    in_client = max(rec["elapsed_s"] for rec in out)
    print(f"[service] 12.5 CLI: serve's first healthy answer "
          f"{first_healthy:.3f} s after start; explore --url --json, 2 "
          f"bert-large jobs, {explore_wall:.3f} s ({in_client:.3f} s after "
          f"the client was built, the server's first dispatch in its "
          f"process included), equal to 12.1's records; SIGTERM: "
          f"\"draining\", exit 0 in {stop_wall:.3f} s; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s; {card}", flush=True)
    return launched


#: phase 14: the serving models at full width and depth, each with the
#: length of its 14.a prompt and the one kernel its path launches: the
#: dense GQA decoder at head width 128 and the attention-free model whose
#: paths the kernels first carried, then h2o-danube-3-4b (head width 120,
#: run on the kernels' 128; its 4,096-token window holds the prompt) and
#: gemma-7b (256, 8.54 B parameters, 17 GB in bf16)
SERVE_ARCHS = {"yi-6b": (4096, "flash_attention"),
               "falcon-mamba-7b": (2048, "selective_scan"),
               "h2o-danube-3-4b": (4096, "flash_attention"),
               "gemma-7b": (4096, "flash_attention")}
#: the archs whose serve CLI 14.c runs in a fresh process
SERVE_CLI_ARCHS = ("yi-6b", "falcon-mamba-7b")
SERVE_BATCH, SERVE_PROMPTS, SERVE_NEW = 4, (256, 512), 32
#: kernel path against the plain twins on the card, on the same weights:
#: max |logits - plain| over max |plain logit|, and the share of positions
#: whose top-1 token agrees.  Set from the CPU rehearsal
#: (tests/test_torch_kernel_path.py): with the kernels' arithmetic models
#: or plain versions standing in for them, the gap of the random-weight
#: stacks grows with depth and width to a floor of 0.048-0.051 of max
#: |logit| (top-1 0.88-0.93) at 64 Mamba layers of width 1024-4096, where
#: fp32 reorderings of the scan, rounded to bf16 at every layer, have
#: spread through the whole stack (yi-6b's 32 layers: 0.022, top-1
#: 0.965).  The bar is twice the floor: a wrong kernel moves the logits
#: by about their own size
SERVE_REL_TOL = 0.1
SERVE_TOP1 = 0.8


def logit_gap(got, want) -> dict:
    """max |got - want|, the same over max |want|, and the top-1
    agreement over the positions of logits [..., V]."""
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return {"max_abs": diff, "rel": diff / scale, "top1": top1}


def check_gap(label: str, gap: dict) -> None:
    if not (gap["rel"] <= SERVE_REL_TOL and gap["top1"] >= SERVE_TOP1):
        fail(f"{label}: kernel path against plain twins {gap} breaks "
             f"rel {SERVE_REL_TOL} / top-1 {SERVE_TOP1}")


def teacher_forced(model, params, padded, tokens, cache_len: int):
    """Last-position logits [B, n + 1, V] of ``model`` over the prompt
    batch, then after each of ``tokens`` [B, n] fed in turn: prefill and
    one decode per token, as ``ServeEngine.generate`` runs them."""
    b, t = padded.shape
    logits, caches = model.prefill(params, {
        "tokens": padded,
        "caches": model.init_cache(b, cache_len, padded.device)})
    steps = [logits[:, -1]]
    for i in range(tokens.shape[1]):
        logits, caches = model.decode(params, caches, tokens[:, i:i + 1])
        steps.append(logits[:, -1])
    import torch
    return torch.stack(steps, dim=1)


class KernelSpans:
    """Wraps a kernel wrapper: CUDA events around each launch, and a copy
    of the first inputs of each launch shape, to time the kernel later on
    the path's own data. It costs copies, so no counted run goes through
    it."""

    def __init__(self, torch, fn):
        self.torch, self.fn = torch, fn
        self.spans: list = []
        self.inputs: dict[tuple, tuple] = {}

    def __call__(self, *args, **kw):
        torch = self.torch
        key = tuple(tuple(a.shape) for a in args[:1]) + (
            tuple(args[1].shape), dtype_of(args[0]), kw.get("causal"))
        if key not in self.inputs:
            self.inputs[key] = (tuple(a.clone() for a in args), dict(kw))
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.fn(*args, **kw)
        e.record()
        self.spans.append((s, e))
        return out

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.spans)

    # standing in for a wrapper in ``ops`` (the autograd Functions call the
    # module's names), it passes the wrapper's launch count through
    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n


def expect_launches(label: str, got: dict, kernel: str, n: int) -> None:
    """Fail unless ``kernel`` launched ``n`` times and no other kernel."""
    want = {k: (n if k == kernel else 0) for k in got}
    if got != want:
        fail(f"{label}: launches {got}, expected {want}")


def phase_serve(torch, ops, ref, dev, card, configs=None) -> dict:
    """Phase 14: ``ServeEngine`` at full width and depth on the card for
    each of ``SERVE_ARCHS``, weights from the port's own init (seed 0):
    14.a a seeded prompt's prefill through the kernels (launch counts
    reset just before and read just after; the kernel's CUDA-event time
    and its share of the wall) against the plain twins on the same
    weights; 14.b ``generate`` (4 left-padded prompts of 256-512 tokens,
    32 new, greedy) with its launches, the plain twins teacher-forced on
    its tokens and held at every step; 14.c ``python -m
    repro_torch.launch.serve`` as a subprocess for ``SERVE_CLI_ARCHS``.
    ``configs`` maps an arch to the config to serve (default: every arch
    at its full config; given, only its archs). Returns each kernel's
    launches on the path (by arch and sub-phase) and its timed launch
    shapes."""
    import functools

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, layers, ssm
    from repro_torch.obs.profile import PROFILE_ENV
    from repro_torch.serve import GenerationConfig, ServeEngine

    # the serve path as a user runs it: phase 9's in-process microbench
    # left the profiling hooks on (a synchronise after every launch, which
    # also breaks the CUDA-graph timing of the launch shapes)
    os.environ.pop(PROFILE_ENV, None)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    wrappers = ops.KERNEL_WRAPPERS
    out = {name: {"launches": {}, "cases": []} for _, name in
           SERVE_ARCHS.values()}

    def counted(fn):
        """``fn()`` with every kernel count reset just before and read just
        after, and its wall."""
        reset_launches(ops)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, {
            k: w.launches for k, w in wrappers.items()}

    for arch, (t_len, kernel) in SERVE_ARCHS.items():
        if configs is not None and arch not in configs:
            continue
        t_arch = time.perf_counter()
        cfg = configs.get(arch) if configs else get_arch(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = ServeEngine(cfg, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        model, params = engine.model, engine.params
        plain = build_model(cfg, attention=layers.attention_any,
                            scan=ssm.plain_scan)
        spans = KernelSpans(torch, wrappers[kernel])
        route = {"attention": functools.partial(layers.flash_prefill,
                                                kernel=spans)} \
            if kernel == "flash_attention" else \
            {"scan": functools.partial(ssm.kernel_scan, kernel=spans)}
        timed = build_model(cfg, **route)
        print(f"[serve] {arch}: {model.param_count(params):,} parameters "
              f"initialised on the card in {init_s:.2f} s (seed 0); {card}",
              flush=True)

        # ---- 14.a prefill: kernels against plain twins -------------------
        prompt = {"tokens": torch.as_tensor(
            rng.integers(1, cfg.vocab, (1, t_len)), device=dev)}
        model.prefill(params, prompt)                       # warm-up
        (logits, _), wall, launches = counted(
            lambda: model.prefill(params, prompt))
        expect_launches(f"{arch} 14.a prefill", launches, kernel,
                        cfg.n_layers)
        out[kernel]["launches"][f"{arch} 14.a prefill"] = launches[kernel]
        timed.prefill(params, prompt)
        spans.spans.clear()
        _, timed_wall, _ = counted(lambda: timed.prefill(params, prompt))
        kernel_ms = spans.ms()
        plain.prefill(params, prompt)                       # warm-up
        (want, _), plain_wall, plain_launches = counted(
            lambda: plain.prefill(params, prompt))
        if any(plain_launches.values()):
            fail(f"{arch}: the plain twins launched {plain_launches}")
        gap = logit_gap(logits, want)
        check_gap(f"{arch} 14.a prefill 1x{t_len}", gap)
        del logits, want
        print(f"[serve] {arch} 14.a prefill 1x{t_len}: wall {wall:.4f} s "
              f"(plain twins {plain_wall:.4f} s); {launches[kernel]} "
              f"{kernel} launches, {kernel_ms:.3f} ms by CUDA events = "
              f"{kernel_ms * 1e-3 / timed_wall:.4f} of the timed run's "
              f"wall {timed_wall:.4f} s; max |logits - plain| "
              f"{gap['max_abs']:.4g} = {gap['rel']:.4g} of max |logit| "
              f"(bar {SERVE_REL_TOL}), top-1 agreement {gap['top1']:.4f}; "
              f"{card}", flush=True)

        # ---- 14.b generate --------------------------------------------------
        prompts = [list(rng.integers(1, cfg.vocab, rng.integers(
            SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1)))
            for _ in range(SERVE_BATCH)]
        gen = GenerationConfig(max_new_tokens=SERVE_NEW)
        engine.generate(prompts, GenerationConfig(max_new_tokens=2))
        res, gen_wall, launches = counted(
            lambda: engine.generate(prompts, gen))
        n_decode = res["tokens"].shape[1]        # one decode per token
        per_call = cfg.n_layers
        want_n = per_call if kernel == "flash_attention" else \
            per_call * (1 + n_decode)
        expect_launches(f"{arch} 14.b generate", launches, kernel, want_n)
        out[kernel]["launches"][f"{arch} 14.b generate"] = launches[kernel]
        padded = torch.as_tensor(engine._pad_batch(prompts), device=dev)
        tokens = torch.as_tensor(res["tokens"], device=dev)
        cache_len = padded.shape[1] + SERVE_NEW
        spans.spans.clear()
        steps = teacher_forced(timed, params, padded, tokens, cache_len)
        gen_kernel_ms = spans.ms()
        same = bool((steps[:, :-1].argmax(-1) == tokens).all())
        plain_steps = teacher_forced(plain, params, padded, tokens, cache_len)
        # the bar at every step; top-1 over all of them (4 rows a step)
        gaps = [logit_gap(steps[:, i], plain_steps[:, i])
                for i in range(steps.shape[1])]
        worst = max(gaps, key=lambda g: g["rel"])
        top1_all = logit_gap(steps, plain_steps)["top1"]
        check_gap(f"{arch} 14.b worst step", dict(worst, top1=top1_all))
        del steps, plain_steps
        print(f"[serve] {arch} 14.b generate {SERVE_BATCH} prompts of "
              f"{[len(p) for p in prompts]} tokens (left-padded to "
              f"{padded.shape[1]}), {n_decode} new, greedy: prefill_s "
              f"{res['prefill_s']:.4f}, decode_s {res['decode_s']:.4f}, "
              f"tokens_per_s {res['tokens_per_s']:.2f} (wall "
              f"{gen_wall:.4f} s); {launches[kernel]} {kernel} launches "
              f"({n_decode} decode calls); the kernel path teacher-forced "
              f"on its tokens: {gen_kernel_ms:.3f} ms of {kernel} by CUDA "
              f"events, reproduces them: {same}; plain twins teacher-forced "
              f"over {n_decode + 1} steps: worst max |d| "
              f"{worst['max_abs']:.4g} = {worst['rel']:.4g} of max |logit|, "
              f"top-1 agreement {top1_all:.4f}; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{card}", flush=True)

        # the launch shapes of 14.a and 14.b, on the path's own inputs
        for key, (args, kw) in spans.inputs.items():
            label = (f"serve {arch} "
                     + "x".join(map(str, (*args[0].shape, args[4].shape[1])
                                    if kernel == "selective_scan" else
                                    (*args[0].shape[:2], args[1].shape[1],
                                     args[0].shape[2])))
                     + f" {dtype_of(args[0])}")
            out[kernel]["cases"].append(measure_case(
                torch, ref, kernel, wrappers[kernel], args, kw, label, card))
        del engine, model, params, plain, timed, spans, route, prompt, padded
        torch.cuda.empty_cache()
        held = torch.cuda.memory_reserved() / 2**30
        print(f"[serve] {arch} took {time.perf_counter() - t_arch:.1f} s "
              f"before 14.c; {card}", flush=True)
        if arch not in SERVE_CLI_ARCHS:
            continue

        # ---- 14.c the CLI ---------------------------------------------------
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
             "--batch", str(SERVE_BATCH), "--prompt-len",
             str(SERVE_PROMPTS[1]), "--new-tokens", str(SERVE_NEW)],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        lines = proc.stdout.splitlines()
        if proc.returncode != 0 or len(lines) < 2 or \
                not lines[0].startswith("prefill ") or \
                lines[1] != "sampled tokens:":
            fail(f"launch.serve --arch {arch} exited {proc.returncode}:\n"
                 f"{proc.stdout}\n{proc.stderr}")
        print(f"[serve] {arch} 14.c python -m repro_torch.launch.serve "
              f"--batch {SERVE_BATCH} --prompt-len {SERVE_PROMPTS[1]} "
              f"--new-tokens {SERVE_NEW}: exit 0 in "
              f"{time.perf_counter() - t0:.2f} s (this process holding "
              f"{held:.2f} GiB): {lines[0]}; {card}", flush=True)
    print(f"[serve] phase 14 took {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)
    return out



# ---------------------------------------------------------------------- #
# phase 15: training
# ---------------------------------------------------------------------- #
#: the backward kernels of the training path: source, the TPU kernel whose
#: function they differentiate (the reference has no backward kernel: it
#: differentiates jnp attention and the jnp scan), and the forward wrapper
BWD_KERNELS = {
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:59", "flash_attention"),
    "selective_scan_bwd": (
        "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "src/repro/kernels/selective_scan.py:62", "selective_scan"),
}
BWD_DESIGNS = {
    "flash_attention_bwd": "tensor cores: bf16 wgmma, 64x64 tiles by a "
                           "2-stage TMA ring, one consumer warpgroup and a "
                           "producer warp a block; head widths up to 256 "
                           "(compiled at 64, 128, 256; at 256 each pass in "
                           "two 128-column halves over the grid); dq pass "
                           "over q tiles "
                           "(sweep 1 D = rowsum(P dP) in fp32, sweep 2 dS K) "
                           "then dk/dv pass over kv tiles (P^T dO, dS^T Q "
                           "from registers), P from the forward's lse; 11 "
                           "products a pair: P rounded to bf16 once, dS "
                           "split into bf16 hi + lo; no atomics",
    "selective_scan_bwd": "CUDA cores, chunk-parallel: T in chunks of 32 "
                          "steps, a lane per state, S lanes per (batch, "
                          "channel), 4 channel groups a block; chunk "
                          "summaries, a walk over the chunks for entry "
                          "states and incoming gradients, then every chunk's "
                          "recompute and reverse recurrence at once; sums "
                          "over s by shuffle trees, over channels in shared "
                          "memory, then a fixed-order reduce; no atomics",
}
#: the backward libraries on the tensor cores: the mangled names of their
#: instantiations and how many there are (each needs HGMMA and UTMALDG in
#: its SASS and no spills)
BWD_TC_KERNELS = {"flash_attention_bwd": (("dq_kernelILi", "dkdv_kernelILi"),
                                          6)}
#: gradients of the backward kernels against autograd of the plain
#: versions on the same inputs, row by row: each row's max |kernel - plain|
#: <= tol x that row's max |plain| + floor x the tensor's max |plain| (the
#: call's largest gradient where the plain tensor is all 0: dq of one
#: query that sees one key).
#: Attention's rows are a query's dq and a key's dk and dv: under causal
#: masking their sizes spread over two orders of magnitude in a 4,096-row
#: head (dq of query t falls like 1/sqrt(t)), so a bar on the tensor's
#: largest value would pass a kernel that drops a far tile.  Each gradient
#: is rounded to bf16 once (2^-9 of the row's largest value); the floor
#: covers rows that are 0 or nearly so in the plain version (a causal query
#: that sees one key, a row that one key dominates), where the kernel's
#: fp32 dP - D leaves about 2^-24 of |dP|: after training, |dP| is large
#: against the tensor's gradients, and such a row reached 2^-15.4 of the
#: tensor's largest value.  The scan (fp32, one row: the whole tensor):
#: sums over channels and time in another order.
BWD_TOL = {"flash_attention_bwd": (2 ** -6, 2 ** -12, True),
           "selective_scan_bwd": (1e-4, 0.0, False)}
#: the forward kernel's log-sum-exp against the plain one (its scores are
#: fp32 products of bf16 inputs on the tensor cores, the exponentials
#: ex2.approx)
LSE_ATOL = 1e-3
#: operations a backward kernel needs: attention per (query, key) pair the
#: five products QK^T, dO V^T, P^T dO, dS^T Q, dS K (2 d each, on the
#: tensor cores in bf16) and P = exp(s - lse), dS = P (dP - D) (4, fp32);
#: the scan per (b, t, i, s) the forward recompute (exp, 2 products, 1 add)
#: and the reverse step (g, d(da), the four sums' terms, the da sum: 26)
BWD_PRODUCT_FLOPS, BWD_SOFTMAX_FLOPS, SCAN_BWD_FLOPS = 10, 4, 30

#: 15.a: the backward kernels' cases, the training path's full-width shape
#: first (BH, T, S, d, causal / B, T, I, S): yi-6b's layer; T and S not
#: multiples of the 64-row tiles; the Whisper encoder's non-causal d 64;
#: T != S both ways; the falcon-mamba-7b layer; S of 1, 4, 8 and 16 lanes
#: with T not a multiple of the 32-step chunk
ATTN_BWD_CASES = ((32, 4096, 4096, 128, True, "yi-6b layer"),
                  (4, 333, 333, 128, True, "ragged"),
                  (8, 1500, 1500, 64, False, "whisper-small encoder"),
                  (2, 200, 333, 64, True, "T != S"),
                  (2, 333, 200, 128, False, "T != S"),
                  (32, 4096, 4096, 120, True, "h2o-danube-3-4b layer"),
                  (16, 4096, 4096, 256, True, "gemma-7b layer"),
                  (4, 333, 333, 120, True, "ragged"),
                  (4, 333, 333, 256, True, "ragged"),
                  (2, 200, 333, 120, True, "T != S"),
                  (2, 333, 200, 256, False, "T != S"))
SCAN_BWD_CASES = ((*FALCON_SCAN, "falcon-mamba-7b layer"),
                  *((2, 333, 100, s, "ragged") for s in (1, 4, 8, 16)))
#: phase 15: configs of phase 14 at full width, depth cut to TRAIN_LAYERS
#: (fp32 masters, gradients and two AdamW moments cost 16 B a parameter:
#: yi-6b's 6.06 B would need 97 GB) or to the arch's TRAIN_DEPTH, each
#: with its sequence length (one sequence a batch) and the forward kernel
#: of its path; gemma-7b at 4 layers is 1.89 B parameters (its 786 M
#: embedding is tied), 30 GB of state, close to yi-6b's 8 layers
TRAIN_ARCHS = {"yi-6b": (4096, "flash_attention"),
               "falcon-mamba-7b": (2048, "selective_scan"),
               "gemma-7b": (4096, "flash_attention")}
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 10, 5
TRAIN_DEPTH = {"gemma-7b": 4}
#: the archs that also save checkpoints and run the resumed sub-run (the
#: others run their 10 steps once, their kernels timed in that run)
TRAIN_RESUMED = ("yi-6b", "falcon-mamba-7b")
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
#: one step of the kernel path against the plain twins on the same weights
#: and batch: the loss's relative gap and each leaf's relative gradient gap
#: (Frobenius norm).  Set from the CPU rehearsal
#: (scripts/train_gap_rehearsal.py: 8 layers of yi-6b at d 512, head 64,
#: and of falcon-mamba-7b at d_inner 512, 512 tokens, two seeds, through
#: the autograd Functions' plain route against the reference's branches):
#: worst leaf gap 0.018-0.020, loss gap at most 1.5e-4.  The gap grows with
#: width (as the logits' did in phase 14), so the bars are 5x the worst
#: leaf and 65x the loss; a wrong backward kernel moves a gradient by about
#: its own size.  Held at the trainer's starting weights and again after
#: training, there also against the exact twin (the kernel path with fp32
#: attention under autograd in the kernels' place), which separates the
#: twins' bf16 rounding from a fault in or around the kernels: peaked
#: softmax rows after training make dS = P (dP - D) cancel, and a D taken
#: from the bf16 output put the kernel path 0.167 from both twins.  Where
#: the plain twins are themselves beyond the gradient bar from the exact
#: twin after training (gemma-7b), the kernel path is held to the exact
#: twin and must be closer to it than they are
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 0.1
#: the resumed run's losses against the uninterrupted run's (the embedding
#: gradient's scatter-add on the card sums in no fixed order)
RESUME_RTOL = 1e-3
#: 15.a: the optimizer's kernels on full-width leaf tables (arch, depth):
#: the benchmark's two configurations at the depth that leaves room for
#: the plain version beside them (p, g, m and v, copies of p, m and v, and
#: one leaf's temporaries: about 30 GB for yi-6b at 2 layers)
OPT_CASES = (("yi-6b", 2), ("falcon-mamba-7b", 2))
#: the norm's sums of squares and the norm against the plain version's,
#: relative (the kernels add in another order); the update is held bit
#: for bit given the same norm
OPT_NORM_RTOL = 1e-6
#: the optimizer's kernels as the kernels line reports them: source, what
#: they replace, the calls of ``OPTIMIZER_WRAPPERS`` they stand for, and
#: the bytes a parameter each must move (the update reads g, p, m and v
#: and writes p, m and v; the norm reads g)
OPT_KERNELS = {
    "adamw_apply": ("src/repro_torch/kernels/csrc/adamw.cu",
                    "src/repro_torch/kernels/ref.py adamw_apply_ref",
                    ("adamw_apply",), 28),
    "adamw_norm": ("src/repro_torch/kernels/csrc/adamw.cu",
                   "src/repro_torch/kernels/ref.py adamw_sumsq_ref + "
                   "adamw_norm_ref", ("adamw_sumsq", "adamw_norm"), 4),
}
OPT_DESIGN = ("CUDA cores, multi-tensor: one table of every leaf (8 int64 "
              "a row, uploaded from pinned memory on the stream), chunks of "
              "65,536 elements, a block a chunk, 64-bit offsets, float4 with "
              "a scalar tail (scalar for a misaligned leaf); the norm in two "
              "launches of per-chunk then per-leaf sums in a fixed order "
              "and one of the leaves in order; the update in one launch, "
              "the plain version's fp32 operations in its order (__f*_rn, "
              "no contraction), the clip scale read on the device")


def check_bwd_build(build, name: str, lib: Path, report: str) -> None:
    """Print a backward library's registers and spills per kernel and, for
    a tensor-core kernel (``BWD_TC_KERNELS``), the ``HGMMA`` / ``UTMALDG``
    counts of each instantiation's SASS; fail on spills there or on an
    instantiation without wgmma or TMA loads."""
    table = ptxas_table(report)
    print(f"[build]   {name}: " + ", ".join(
        f"{k} {regs} registers, spills {st}/{ld} bytes"
        for k, regs, st, ld in table))
    if name not in BWD_TC_KERNELS:
        return
    if any(st or ld for _, _, st, ld in table):
        fail(f"{name}: a kernel spills registers")
    names, want = BWD_TC_KERNELS[name]
    tc = {k: (v["HGMMA"], v["UTMALDG"])
          for k, v in sass_counts(build, lib).items()
          if any(n in k for n in names)}
    print(f"[sass] {lib.name}: {len(tc)} tensor-core instantiations, each "
          "HGMMA/UTMALDG: " + ", ".join(f"{short_name(k)} {h}/{u}"
                                        for k, (h, u) in sorted(tc.items())))
    if len(tc) != want or any(h == 0 or u == 0 for h, u in tc.values()):
        fail(f"{name}: expected {want} instantiations, each with HGMMA and "
             f"UTMALDG, in the SASS; found {tc}")


def bwd_plain(ref, kernel: str, args: tuple, kwargs: dict):
    if kernel == "flash_attention_bwd":
        q, k, v, do, _lse = args
        return ref.attention_bwd_ref(q, k, v, do, **kwargs)
    return ref.selective_scan_bwd_ref(*args)


def bwd_library(torch, kernel: str, args: tuple, kwargs: dict):
    """The backward of ``scaled_dot_product_attention`` on the same q, k,
    v and do (a yardstick only: the port never calls it), else None."""
    if kernel != "flash_attention_bwd":
        return None
    import torch.nn.functional as F
    q, k, v, do, _lse = args
    qq, kk, vv = (x.detach().unsqueeze(0).requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv,
                                         is_causal=kwargs["causal"])
    dd = do.unsqueeze(0)
    return lambda: torch.autograd.grad(out, (qq, kk, vv), dd,
                                       retain_graph=True)


def bwd_bound_ms(kernel: str, args: tuple, kwargs: dict) -> tuple:
    """Least time on an H100 for one backward call: the larger of its bytes
    (each input read once, each output written once) over HBM and its
    operations over the peak for their type."""
    from repro_torch.obs import profile
    size = lambda xs: sum(x.numel() * x.element_size() for x in xs)
    # the outputs have the shapes and types of the first inputs: dq, dk, dv
    # of q, k, v; dxi, ddt, dB, dC, da, dh0 of xi, dt, bmat, cmat, a, h0
    if kernel == "flash_attention_bwd":
        q, k = args[:2]
        nbytes = size(args) + size(args[:3])
        pairs = profile.attention_pairs(q.shape[0], q.shape[1], k.shape[1],
                                        kwargs["causal"])
        t_ops = pairs * BWD_PRODUCT_FLOPS * q.shape[2] / \
            PRODUCT_PEAK["bfloat16"] + pairs * BWD_SOFTMAX_FLOPS / \
            FP_PEAK["float32"]
    else:
        xi, a = args[0], args[4]
        nbytes = size(args) + size(args[:6])
        t_ops = xi.numel() * a.shape[1] * SCAN_BWD_FLOPS / FP_PEAK["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes else \
        (t_bytes * 1e3, "bytes")


def check_bwd(label: str, kernel: str, got: tuple, want: tuple) -> tuple:
    """(max |got - want| over the gradients, the worst row's error over its
    bar); fails on a shape, dtype, non-finite value or a row that breaks
    the kernel's stated bar (``BWD_TOL``)."""
    import torch
    tol, floor, by_row = BWD_TOL[kernel]
    worst, share = 0.0, 0.0
    call_max = max(float(w.float().abs().max()) if w.numel() else 0.0
                   for w in want)
    for n, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{label}: gradient {n} kernel {tuple(g.shape)} {g.dtype} "
                 f"vs plain {tuple(w.shape)} {w.dtype}")
        if not bool(torch.isfinite(g).all()):
            fail(f"{label}: gradient {n} is not finite")
        width = g.shape[-1] if by_row and g.dim() else max(g.numel(), 1)
        g2, w2 = g.float().reshape(-1, width), w.float().reshape(-1, width)
        err = (g2 - w2).abs().amax(1)
        size = w2.abs().amax(1)
        scale = float(size.max()) or call_max
        bar = tol * size + floor * scale
        bad = (err > bar).nonzero()
        if len(bad):
            r = int(bad[0])
            where = f"row {divmod(r, g.shape[-2])}" if by_row and g.dim() == 3 \
                else f"row {r}"
            fail(f"{label}: gradient {n} {where} max |kernel - plain| "
                 f"{float(err[r]):.3e} breaks {tol} x its max |plain| "
                 f"{float(size[r]):.3e} + {floor} x the tensor's "
                 f"{scale:.3e} ({len(bad)} of {len(err)} rows)")
        nz = bar > 0
        if bool(nz.any()):
            share = max(share, float((err[nz] / bar[nz]).max()))
        worst = max(worst, float(err.max()))
    return worst, share


def measure_bwd_case(torch, ref, ops, kernel, args, kwargs, label,
                     card) -> dict:
    """One backward call on the card against autograd of its plain
    version: error, bit-reproducibility, the kernel's, the plain
    version's and (attention) SDPA backward's times, per call and from a
    CUDA graph, and the bound."""
    fn = ops.BACKWARD_WRAPPERS[kernel]
    got = fn(*args, **kwargs)
    again = fn(*args, **kwargs)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{kernel} {label}: two launches differ")
    want = bwd_plain(ref, kernel, args, kwargs)
    err, share = check_bwd(f"{kernel} {label}", kernel, got, want)
    del got, again, want
    ms = timed_ms(torch, lambda: fn(*args, **kwargs))
    plain_ms = timed_ms(torch, lambda: bwd_plain(ref, kernel, args, kwargs))
    lib = bwd_library(torch, kernel, args, kwargs)
    library_ms = timed_ms(torch, lib) if lib is not None else None
    g_ms = graph_ms(torch, lambda: fn(*args, **kwargs))
    lib_g_ms = graph_ms(torch, lib) if lib is not None else None
    b_ms, b_by = bwd_bound_ms(kernel, args, kwargs)
    fmt = lambda x: f"{x:.4f} ms" if x is not None else "none"
    print(f"[train] {kernel} {label}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA backward {fmt(library_ms)}, bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.4f} of bound; graph-replayed "
          f"kernel {fmt(g_ms)}, SDPA backward {fmt(lib_g_ms)}; max |kernel - "
          f"plain| {err:.3e}, worst row at {share:.4f} of its bar (tol, "
          f"floor, by row {BWD_TOL[kernel]}); two launches bit-identical; "
          f"{card}", flush=True)
    return dict(label=label, max_abs_err=err, row_share=share, ms=ms,
                plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                graph_ms=g_ms, library_graph_ms=lib_g_ms)


def optimizer_leaves(torch, arch: str, layers: int, card):
    """(p, g, m, v, decay) of the arch's trainable tree at full width and
    ``layers`` deep (``build_model(...).abstract_params``: the training
    path's leaves, shapes and decay rule), on the card, seeded."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_arch(arch), n_layers=layers)
    model = build_model(cfg)
    tree = model.abstract_params(trainable=True)
    decay = [nd >= 2 for nd in model.reference_ndims(tree)]
    gen = torch.Generator(card).manual_seed(0)
    out = {k: [] for k in "pgmv"}
    for t in tree.parameters():
        for k, lo, hi in (("p", -0.02, 0.02), ("g", -1e-3, 1e-3),
                          ("m", -1e-4, 1e-4), ("v", 0.0, 1e-7)):
            out[k].append(torch.empty(t.shape, device=card).uniform_(
                lo, hi, generator=gen))
    return out["p"], out["g"], out["m"], out["v"], decay


def measure_optimizer_case(torch, ops, ref, arch: str, layers: int, card,
                           check: bool = True, loop: bool = True) -> dict:
    """The optimizer's kernels on one leaf table (:func:`optimizer_leaves`):
    with ``check``, the norm's sums and the norm within ``OPT_NORM_RTOL``
    of the plain version's and one update bit-equal to the plain version's
    on copies given the same norm; then the table's host build, the norm
    (``adamw_sumsq`` + ``adamw_norm``) and the update (``adamw_apply``)
    timed by CUDA events, per call and from a CUDA graph, against their
    bounds; with ``loop``, the plain versions timed too (the per-leaf path
    the kernels replace)."""
    from repro_torch.optim import AdamWConfig

    p, g, m, v, decay = optimizer_leaves(torch, arch, layers, card)
    n = sum(t.numel() for t in p)
    c = AdamWConfig()
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    sched = {"lr": f32(3e-4), "b1c": f32(0.1), "b2c": f32(0.05)}
    hyper = dict(b1=c.b1, b2=c.b2, eps=c.eps, weight_decay=c.weight_decay,
                 grad_clip=c.grad_clip)
    on_card = {k: x.to(card) for k, x in sched.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = ops.adamw_table(g, p, m, v, decay)
    host_ms = 1e3 * (time.perf_counter() - t0)
    sums = ops.adamw_sumsq(table)
    gnorm = ops.adamw_norm(sums)
    rec = {"arch": arch, "layers": layers, "leaves": len(p), "params": n,
           "table_host_ms": host_ms}
    if check:
        want_sums = ref.adamw_sumsq_ref(g)
        rec["sums_rel_err"] = rel_err(sums, want_sums)
        rec["norm_rel_err"] = rel_err(gnorm, ref.adamw_norm_ref(want_sums))
        if max(rec["sums_rel_err"], rec["norm_rel_err"]) > OPT_NORM_RTOL:
            fail(f"adamw {arch} depth {layers}: sums / norm relative error "
                 f"{rec['sums_rel_err']:.3e} / {rec['norm_rel_err']:.3e} "
                 f"breaks {OPT_NORM_RTOL}")
        copies = [[x.clone() for x in xs] for xs in (p, m, v)]
        ops.adamw_apply(table, gnorm, **sched, **hyper)
        ref.adamw_apply_ref(copies[0], g, copies[1], copies[2], decay, gnorm,
                            **on_card, **hyper)
        torch.cuda.synchronize()
        rec["unequal_leaves"] = sum(
            not torch.equal(a, b) for xs, ys in zip((p, m, v), copies)
            for a, b in zip(xs, ys))
        if rec["unequal_leaves"]:
            fail(f"adamw {arch} depth {layers}: {rec['unequal_leaves']} of "
                 f"{3 * len(p)} p, m and v leaves differ from the plain "
                 f"version given the same norm")
        del copies, want_sums
    norm = lambda: ops.adamw_norm(ops.adamw_sumsq(table))
    apply = lambda: ops.adamw_apply(table, gnorm, **sched, **hyper)
    bound = lambda name: 1e3 * OPT_KERNELS[name][3] * n / HBM_BYTES_PER_S
    rec.update(norm_ms=timed_ms(torch, norm),
               norm_graph_ms=graph_ms(torch, norm),
               norm_bound_ms=bound("adamw_norm"),
               apply_ms=timed_ms(torch, apply),
               apply_graph_ms=graph_ms(torch, apply),
               apply_bound_ms=bound("adamw_apply"))
    rec["apply_share"] = rec["apply_bound_ms"] / rec["apply_ms"]
    rec["norm_share"] = rec["norm_bound_ms"] / rec["norm_ms"]
    if loop:
        rec["loop_norm_ms"] = timed_ms(torch, lambda: ref.adamw_norm_ref(
            ref.adamw_sumsq_ref(g)))
        rec["loop_apply_ms"] = timed_ms(torch, lambda: ref.adamw_apply_ref(
            p, g, m, v, decay, gnorm, **on_card, **hyper))
    del p, g, m, v, table, sums, gnorm
    torch.cuda.empty_cache()
    return rec


def attn_bwd_args(torch, ops, ref, rng, dev, bh, t, s, d, causal) -> tuple:
    """q, k, v, do, lse of one attention backward: bf16 inputs from
    ``rng``, lse from the forward kernel (whose output must be the same
    bits without the lse, and whose lse must match the plain one)."""
    mk = lambda n: torch.as_tensor(rng.standard_normal((bh, n, d)),
                                   dtype=torch.float32).to(dev).bfloat16()
    q, k, v, do = mk(t), mk(s), mk(s), mk(t)
    o, lse = ops.flash_attention(q, k, v, causal=causal, return_lse=True)
    if not torch.equal(o, ops.flash_attention(q, k, v, causal=causal)):
        fail(f"flash_attention {bh}x{t}x{s}x{d}: the output changes when "
             f"the kernel also writes the log-sum-exp")
    lse_err = float((lse - ref.attention_lse_ref(q, k, causal=causal))
                    .abs().max())
    if lse_err > LSE_ATOL:
        fail(f"flash_attention {bh}x{t}x{s}x{d}: log-sum-exp off by "
             f"{lse_err:.3e} (atol {LSE_ATOL})")
    return q, k, v, do, lse


def scan_bwd_args(torch, rng, dev, b, t, i, s) -> tuple:
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    return (f(rng.standard_normal((b, t, i))),
            f(np.abs(rng.standard_normal((b, t, i))) * 0.1),
            f(rng.standard_normal((b, t, s))), f(rng.standard_normal((b, t, s))),
            f(-np.abs(rng.standard_normal((i, s)))),
            f(rng.standard_normal((b, i, s))), f(rng.standard_normal((b, t, i))),
            f(rng.standard_normal((b, i, s))))


def step_grads(model, params, batch) -> tuple:
    """One step's loss and each leaf's gradient through ``model``."""
    import torch
    leaves = list(params.parameters())
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(leaves, grads)]


def grad_gaps(params, got, want) -> dict:
    """The loss's relative gap and the worst leaf's relative gradient gap
    (Frobenius norm) of one step ``got`` against ``want`` (each from
    :func:`step_grads` on the same weights and batch)."""
    (l1, g1), (l2, g2) = got, want
    gaps = {}
    for (n, _), a, b in zip(params.named_parameters(), g1, g2):
        den = float(b.float().norm())
        gaps[n] = float((a.float() - b.float()).norm()) / den if den else \
            float(a.float().norm())
    worst = max(gaps, key=gaps.get)
    return {"loss": l1, "plain_loss": l2, "loss_rel": abs(l1 - l2) / abs(l2),
            "worst_leaf": worst, "worst_gap": gaps[worst],
            "median_gap": statistics.median(gaps.values())}


def exact_attention(q, k, v, *, causal: bool):
    """The exact twin's attention core: the plain version in fp32 (bf16
    out), differentiated by autograd, behind the kernel path's own
    ``flash_prefill`` (kv heads expanded, heads folded, remat)."""
    from repro_torch.kernels import ref
    return ref.attention_ref(q, k, v, causal=causal)


class Recorder(KernelSpans):
    """Stands in for a kernel wrapper in ``ops`` and keeps a copy of each
    call's inputs and outputs."""

    def __init__(self, torch, fn):
        super().__init__(torch, fn)
        self.calls: list = []

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        self.calls.append((tuple(a.clone() for a in args), dict(kw),
                           tuple(o.clone() for o in out)))
        return out


def train_cli(torch, cuda: bool, configs, card: str) -> None:
    """15.c: ``python -m repro_torch.launch.train`` on the first of
    ``TRAIN_ARCHS`` in a fresh process (4 steps at depth TRAIN_LAYERS on
    the card; the reduced config on the CPU when ``configs`` is given).
    It runs before 15.b: the trainer runs leave allocator segments this
    process cannot give back, and the fresh process needs the card's
    memory."""
    import gc
    import tempfile

    # this process lets go of its cached blocks first and reports what it
    # still holds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2**30 if cuda else 0.0
    live = torch.cuda.memory_allocated() / 2**30 if cuda else 0.0
    arch, (t_len, _) = next(iter(TRAIN_ARCHS.items()))
    tmp = tempfile.mkdtemp(prefix="cim-tuner-train-cli-")
    cmd = ["--arch", arch, "--steps", "4", "--batch", "1", "--seq",
           str(t_len), "--ckpt-dir", tmp]
    cmd += ["--set", f"n_layers={TRAIN_LAYERS}"] if not configs else \
        ["--smoke", "--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *cmd], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    shutil.rmtree(tmp, ignore_errors=True)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines or \
            not lines[0].startswith("step     1 loss") or \
            not lines[-1].startswith("straggler steps:"):
        fail(f"launch.train exited {proc.returncode}:\n{proc.stdout}\n"
             f"{proc.stderr}")
    print(f"[train] 15.c python -m repro_torch.launch.train {' '.join(cmd)}: "
          f"exit 0 in {time.perf_counter() - t0:.2f} s (this process holding "
          f"{held:.2f} GiB, {live:.2f} GiB of it in live tensors); printed: "
          + " | ".join(lines) + f"; {card}", flush=True)


def phase_train(torch, ops, ref, dev, card, configs=None, rng=None,
                after_cli=None) -> dict:
    """Phase 15: 15.a each backward kernel against its plain version at
    the full-width shapes of the training path and at ragged ones, timed,
    and on the card the optimizer's kernels on the leaf tables of
    ``OPT_CASES`` (:func:`measure_optimizer_case`); 15.b per config of
    ``TRAIN_ARCHS`` (default: full width, depth ``TRAIN_LAYERS``;
    ``configs`` maps an arch to another config) the ``Trainer`` for
    ``TRAIN_STEPS`` steps on the synthetic stream with a checkpoint every
    ``TRAIN_CKPT_EVERY`` (launch counts reset just before and read just
    after), a run of ``TRAIN_CKPT_EVERY`` steps resumed by a third to the
    end, one step of the kernel path against the plain twins (and, after
    training, against the exact twin), the kernels' share of a step and
    peak memory; 15.c (``train_cli``, before 15.b).  Returns each backward
    kernel's training launches and measured cases, the forward kernels'
    and the optimizer's training launches, and the optimizer's cases.
    ``after_cli`` (a callable) runs right after 15.c, while this process
    still holds the least memory."""
    import dataclasses
    import functools
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, layers, ssm
    from repro_torch.obs.profile import PROFILE_ENV
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    os.environ.pop(PROFILE_ENV, None)
    t_phase = time.perf_counter()
    rng = rng or np.random.default_rng(15)
    cuda = dev.type == "cuda"
    out = {name: {"launches": 0, "by_arch": {}, "cases": []}
           for name in BWD_KERNELS}
    out["forward_launches"] = {}
    out["forward_by_arch"] = {}
    out["optimizer_launches"] = {k: 0 for k in ops.OPTIMIZER_WRAPPERS}
    out["optimizer_by_arch"] = {}
    out["optimizer"] = []
    wrappers = {**ops.KERNEL_WRAPPERS, **ops.BACKWARD_WRAPPERS,
                **ops.OPTIMIZER_WRAPPERS}

    # ---- 15.a the backward kernels against their plain versions ----------
    for bh, t, s, d, causal, what in ATTN_BWD_CASES:
        args = attn_bwd_args(torch, ops, ref, rng, dev, bh, t, s, d, causal)
        out["flash_attention_bwd"]["cases"].append(measure_bwd_case(
            torch, ref, ops, "flash_attention_bwd", args, {"causal": causal},
            f"{what} {bh}x{t}x{s}x{d} causal={causal}", card))
    for b_, t, i, s_st, what in SCAN_BWD_CASES:
        args = scan_bwd_args(torch, rng, dev, b_, t, i, s_st)
        out["selective_scan_bwd"]["cases"].append(measure_bwd_case(
            torch, ref, ops, "selective_scan_bwd", args, {},
            f"{what} {b_}x{t}x{i}x{s_st}", card))
    del args
    if cuda:
        torch.cuda.empty_cache()
        from repro_torch.kernels import adamw as aw
        from repro_torch.kernels import build
        # the loop names are not `arch` and `layers` (15.b's loop variable
        # and the models module)
        for opt_arch, opt_depth in OPT_CASES:
            r = measure_optimizer_case(torch, ops, ref, opt_arch, opt_depth,
                                       dev)
            out["optimizer"].append(r)
            print(f"[train] adamw {opt_arch} depth {opt_depth} at full width, "
                  f"{r['leaves']} leaves, {r['params']:,} parameters: "
                  f"update {r['apply_ms']:.4f} ms (graph "
                  f"{r['apply_graph_ms']:.4f}), bound "
                  f"{r['apply_bound_ms']:.4f} ms (28 B a parameter), "
                  f"{r['apply_share']:.4f} of bound, "
                  f"plain {r['loop_apply_ms']:.4f} ms; norm "
                  f"{r['norm_ms']:.4f} ms (graph {r['norm_graph_ms']:.4f}), "
                  f"bound {r['norm_bound_ms']:.4f} ms (4 B), "
                  f"{r['norm_share']:.4f} of bound, plain "
                  f"{r['loop_norm_ms']:.4f} ms; table built in "
                  f"{r['table_host_ms']:.3f} ms on the host; p, m and v "
                  f"bit-equal to the plain version given the same norm "
                  f"({r['unequal_leaves']} leaves differ), sums / norm "
                  f"relative error {r['sums_rel_err']:.3e} / "
                  f"{r['norm_rel_err']:.3e} (bar {OPT_NORM_RTOL}); {card}",
                  flush=True)
        ptx = ptxas_table(build.ptxas_report(aw.SOURCE, aw.NVCC_FLAGS))
        print("[build] adamw: " + ", ".join(
            f"{k} {regs} registers, spills {st}/{ld} bytes"
            for k, regs, st, ld in ptx), flush=True)
        if any(st or ld for _, _, st, ld in ptx):
            fail("adamw: a kernel spills registers")
        print(f"[train] after 15.a this process holds "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of it in live "
              f"tensors; {card}", flush=True)
    train_cli(torch, cuda, configs, card)
    if after_cli is not None:
        after_cli()

    # ---- 15.b the trainer -------------------------------------------------
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    for arch, (t_len, kernel) in TRAIN_ARCHS.items():
        if configs is not None and arch not in configs:
            continue
        t_arch = time.perf_counter()
        bwd = kernel + "_bwd"
        resumed_arch = arch in TRAIN_RESUMED
        cfg = configs.get(arch) if configs else dataclasses.replace(
            get_arch(arch), n_layers=TRAIN_DEPTH.get(arch, TRAIN_LAYERS))
        tmp = tempfile.mkdtemp(prefix=f"cim-tuner-train-{arch}-")
        saves: list[float] = []

        def trainer(name, steps, save=True):
            tr = Trainer(cfg, TrainerConfig(
                steps=steps, seq_len=t_len, global_batch=1,
                ckpt_every=TRAIN_CKPT_EVERY, ckpt_dir=os.path.join(tmp, name),
                ckpt_keep=1, log_every=1, seed=0,
                optimizer=AdamWConfig(peak_lr=TRAIN_LR,
                                      warmup_steps=TRAIN_WARMUP,
                                      total_steps=TRAIN_STEPS)), dev)
            ckpt_save = tr.ckpt.save

            def timed_save(*a, **kw):
                if not save:                  # a run without checkpoints
                    return None
                sync()
                t0 = time.perf_counter()
                path = ckpt_save(*a, **kw)
                saves.append(time.perf_counter() - t0)
                return path
            tr.ckpt.save = timed_save
            return tr

        # the trainer's starting weights (seed 0): one step of the kernel
        # path against the plain twins, held (the regime of the rehearsal)
        kernel_model = build_model(cfg)
        plain_model = build_model(cfg, attention=layers.attention_any,
                                  scan=ssm.plain_scan)
        full = trainer("full", TRAIN_STEPS, save=resumed_arch)
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in full.stream.global_batch_at(0).items()}
        # the exact twin: the kernel path with each kernel's plain fp32
        # version under autograd in its place (attention), or the plain
        # twins where they already compute in fp32 (the scans)
        exact_model = build_model(cfg, attention=functools.partial(
            layers.flash_prefill, kernel=exact_attention)) \
            if kernel == "flash_attention" else plain_model
        params = kernel_model.init(0, dev, trainable=True)
        gap = grad_gaps(params, step_grads(kernel_model, params, batch),
                        step_grads(plain_model, params, batch))
        del params
        if gap["loss_rel"] > TRAIN_LOSS_TOL or \
                gap["worst_gap"] > TRAIN_GRAD_TOL:
            fail(f"{arch} 15.b: kernel path against plain twins {gap} breaks "
                 f"loss {TRAIN_LOSS_TOL} / gradient {TRAIN_GRAD_TOL}")

        # the uninterrupted run, counted; an arch without the resumed run
        # has its kernel launches timed by CUDA events in this one
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        spans = {} if resumed_arch else {
            kernel: KernelSpans(torch, getattr(ops, kernel)),
            bwd: KernelSpans(torch, getattr(ops, bwd))}
        saved = {k: getattr(ops, k) for k in spans}
        reset_launches(ops)
        sync()
        t0 = time.perf_counter()
        try:
            for k, sp in spans.items():
                setattr(ops, k, sp)
            params, opt = full.train(log=lambda s: None)
            sync()
        finally:
            for k, fn in saved.items():
                setattr(ops, k, fn)
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        n_params = sum(p.numel() for p in params.parameters())
        want = {k: 0 for k in launches}
        want[kernel] = 2 * cfg.n_layers * TRAIN_STEPS     # forward + remat
        want[bwd] = cfg.n_layers * TRAIN_STEPS
        # the optimizer: the norm's three launches and the update's one
        want.update(adamw_sumsq=2 * TRAIN_STEPS, adamw_norm=TRAIN_STEPS,
                    adamw_apply=TRAIN_STEPS)
        if launches != want:
            fail(f"{arch} 15.b: launches {launches}, expected {want}")
        taken = (ops.adamw_apply.leaves, ops.adamw_apply.elements)
        if taken != (len(list(params.parameters())),
                     sum(p.numel() for p in params.parameters())):
            fail(f"{arch} 15.b: the last update took {taken} (leaves, "
                 f"elements) of the trainer's parameters")
        out[bwd]["launches"] += launches[bwd]
        out[bwd]["by_arch"][arch] = launches[bwd]
        out["forward_launches"][kernel] = \
            out["forward_launches"].get(kernel, 0) + launches[kernel]
        out["forward_by_arch"][arch] = {kernel: launches[kernel]}
        out["optimizer_by_arch"][arch] = {
            k: launches[k] for k in ops.OPTIMIZER_WRAPPERS}
        for k in ops.OPTIMIZER_WRAPPERS:
            out["optimizer_launches"][k] += launches[k]
        hist = full.history
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses) or \
                any(r["skipped"] for r in hist):
            fail(f"{arch} 15.b: losses {losses}")
        if not losses[-1] < losses[0]:
            fail(f"{arch} 15.b: the loss did not fall: {losses}")
        if resumed_arch and full.ckpt.latest_step() != TRAIN_STEPS:
            fail(f"{arch} 15.b: no checkpoint at step {TRAIN_STEPS}")
        steps_s = [r["sec_per_step"] for r in hist[1:]]
        sec = statistics.median(steps_s)
        peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
        shutil.rmtree(os.path.join(tmp, "full"), ignore_errors=True)
        if not resumed_arch:
            del opt
            kernel_ms = {k: sp.ms() for k, sp in spans.items()}
            step_ms = sum(r["sec_per_step"] for r in hist) * 1e3
            rhist, gaps, resume_wall = [], [], None
            del spans
        else:
            del params, opt
            # interrupted after TRAIN_CKPT_EVERY steps, resumed to the end;
            # the resumed run's kernel launches timed by CUDA events
            trainer("resumed", TRAIN_CKPT_EVERY).train(log=lambda s: None)
            resumed = trainer("resumed", TRAIN_STEPS)
            spans = {kernel: KernelSpans(torch, getattr(ops, kernel)),
                     bwd: KernelSpans(torch, getattr(ops, bwd))}
            saved = {k: getattr(ops, k) for k in spans}
            for k, sp in spans.items():
                setattr(ops, k, sp)
            try:
                t0 = time.perf_counter()
                params, opt = resumed.train(log=lambda s: None)
                sync()
                resume_wall = time.perf_counter() - t0
                del opt
            finally:
                for k, fn in saved.items():
                    setattr(ops, k, fn)
            kernel_ms = {k: sp.ms() for k, sp in spans.items()}
            # the spans keep copies of inputs, scattered over the allocator's
            # segments: let them go
            del spans
            rhist = resumed.history
            if [r["step"] for r in rhist] != list(
                    range(TRAIN_CKPT_EVERY + 1, TRAIN_STEPS + 1)):
                fail(f"{arch} 15.b: the resumed run ran steps "
                     f"{[r['step'] for r in rhist]}")
            gaps = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(rhist, hist[TRAIN_CKPT_EVERY:])]
            if max(gaps) > RESUME_RTOL:
                fail(f"{arch} 15.b: resumed losses {[r['loss'] for r in rhist]} "
                     f"vs uninterrupted {losses[TRAIN_CKPT_EVERY:]}")
            step_ms = sum(r["sec_per_step"] for r in rhist) * 1e3
        shutil.rmtree(tmp, ignore_errors=True)


        # the trained weights: one step through the kernel path, held
        # against the exact twin (a fault in or around the kernels -- the
        # kv-head expansion's backward, the saved lse, remat -- moves a
        # gradient by about its own size) and the plain twins, with each
        # of its backward launches held against autograd of the kernel's
        # plain version on the launch's own inputs
        rec = Recorder(torch, getattr(ops, bwd))
        setattr(ops, bwd, rec)
        try:
            k_step = step_grads(kernel_model, params, batch)
        finally:
            setattr(ops, bwd, rec.fn)
        if len(rec.calls) != cfg.n_layers:
            fail(f"{arch} 15.b: {len(rec.calls)} {bwd} launches in one step")
        checks = [check_bwd(f"{arch} 15.b trained step, launch {n}", bwd, got,
                            bwd_plain(ref, bwd, a, kw))
                  for n, (a, kw, got) in enumerate(rec.calls)]
        path_err = max(c[0] for c in checks)
        path_share = max(c[1] for c in checks)
        del rec
        p_step = step_grads(plain_model, params, batch)
        gap_trained = grad_gaps(params, k_step, p_step)
        if exact_model is plain_model:
            gap_exact, gap_twins = gap_trained, None
        else:
            e_step = step_grads(exact_model, params, batch)
            gap_exact = grad_gaps(params, k_step, e_step)
            gap_twins = grad_gaps(params, p_step, e_step)
            del e_step
        del k_step, p_step, params, batch
        print(f"[train] {arch} depth {cfg.n_layers}, d {cfg.d_model}, "
              f"{n_params:,} parameters (fp32 masters), 1 x {t_len} tokens a "
              f"step: {TRAIN_STEPS} steps in {wall:.2f} s, losses "
              f"{[round(x, 4) for x in losses]}; sec_per_step {sec:.4f} "
              f"(median of steps 2-{TRAIN_STEPS}), {t_len / sec:.1f} tokens/s; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}"
              f" = {2 * cfg.n_layers} {kernel} (forward + remat), "
              f"{cfg.n_layers} {bwd} and 4 adamw (every leaf in the last "
              f"update's table) a step; peak memory {peak:.2f} GiB; "
              f"{card}", flush=True)
        kernels_text = (
            ", ".join(f"{k} {v:.1f} ms" for k, v in kernel_ms.items())
            + f" = {sum(kernel_ms.values()) / step_ms:.4f} of the steps' "
            f"{step_ms:.1f} ms; {card}")
        if resumed_arch:
            print(f"[train] {arch} resumed at step {TRAIN_CKPT_EVERY} to "
                  f"{TRAIN_STEPS} in {resume_wall:.2f} s: losses "
                  f"{[round(r['loss'], 4) for r in rhist]}, max relative gap "
                  f"to the uninterrupted run {max(gaps):.3e} (bar "
                  f"{RESUME_RTOL}); checkpoint saves "
                  f"{[round(x, 2) for x in saves]} s; kernels by CUDA events "
                  f"over its {len(rhist)} steps: " + kernels_text, flush=True)
        else:
            print(f"[train] {arch} (no checkpoint or resumed run): kernels by "
                  f"CUDA events over the counted run's {len(hist)} steps: "
                  + kernels_text, flush=True)
        print(f"[train] {arch} one step, kernel path against the plain twins "
              f"on the same weights and batch: at the starting weights loss "
              f"{gap['loss']:.5f} vs {gap['plain_loss']:.5f} (relative gap "
              f"{gap['loss_rel']:.3e}, bar {TRAIN_LOSS_TOL}), worst leaf "
              f"gradient gap {gap['worst_gap']:.4f} at {gap['worst_leaf']} "
              f"(bar {TRAIN_GRAD_TOL}), median {gap['median_gap']:.4f}; "
              f"{card}", flush=True)
        twins = "" if gap_twins is None else (
            f"; the plain twins against the exact twin: worst leaf "
            f"{gap_twins['worst_gap']:.4f} at {gap_twins['worst_leaf']}, "
            f"median {gap_twins['median_gap']:.4f}")
        exact_what = "the plain twins (fp32 scans)" if gap_twins is None \
            else "fp32 attention by autograd behind flash_prefill"
        print(f"[train] {arch} after {TRAIN_STEPS} steps, one step of the "
              f"kernel path against the exact twin ({exact_what}): loss gap "
              f"{gap_exact['loss_rel']:.3e} (bar {TRAIN_LOSS_TOL}), worst "
              f"leaf gradient gap {gap_exact['worst_gap']:.4f} at "
              f"{gap_exact['worst_leaf']} (bar {TRAIN_GRAD_TOL}), median "
              f"{gap_exact['median_gap']:.4f}; against the plain twins "
              f"worst leaf {gap_trained['worst_gap']:.4f} at "
              f"{gap_trained['worst_leaf']}, median "
              f"{gap_trained['median_gap']:.4f}{twins}; that step's "
              f"{cfg.n_layers} {bwd} launches against autograd of the plain "
              f"version on their own inputs: max |kernel - plain| "
              f"{path_err:.3e}, worst row at {path_share:.4f} of its bar "
              f"{BWD_TOL[bwd]}; {card}", flush=True)
        # held after every gap is printed, so that a failure shows them all.
        # The plain twins' autograd rounds dP and dS to bf16 (the rounding
        # points the backward kernel keeps out); where that alone puts them
        # beyond the gradient bar from the exact twin (gemma-7b after
        # training), they cannot tell a kernel fault from their own
        # rounding: the kernel path is then held to the exact twin under
        # the bar and must be closer to it than the plain twins are
        twins_apart = gap_twins is not None and \
            gap_twins["worst_gap"] > TRAIN_GRAD_TOL
        for what, g in (("exact twin", gap_exact),
                        ("plain twins", gap_trained)):
            grad_held = not (what == "plain twins" and twins_apart)
            if g["loss_rel"] > TRAIN_LOSS_TOL or \
                    (grad_held and g["worst_gap"] > TRAIN_GRAD_TOL):
                fail(f"{arch} 15.b: after {TRAIN_STEPS} steps the kernel "
                     f"path against the {what} {g} breaks loss "
                     f"{TRAIN_LOSS_TOL} / gradient {TRAIN_GRAD_TOL}")
        if twins_apart:
            if not gap_exact["worst_gap"] < gap_twins["worst_gap"]:
                fail(f"{arch} 15.b: after {TRAIN_STEPS} steps the kernel "
                     f"path is {gap_exact['worst_gap']:.4f} from the exact "
                     f"twin, no closer than the plain twins "
                     f"({gap_twins['worst_gap']:.4f})")
            print(f"[train] {arch} after {TRAIN_STEPS} steps the plain twins "
                  f"are {gap_twins['worst_gap']:.4f} from the exact twin at "
                  f"{gap_twins['worst_leaf']}, beyond the bar "
                  f"{TRAIN_GRAD_TOL}: the kernel path's gradients are held "
                  f"to the exact twin ({gap_exact['worst_gap']:.4f}), closer "
                  f"than the plain twins; {card}", flush=True)
        out[arch] = dict(sec_per_step=sec, tokens_per_s=t_len / sec,
                         peak_gib=peak, losses=losses,
                         resume_gap=max(gaps) if gaps else None,
                         kernel_share=sum(
                             kernel_ms.values()) / step_ms,
                         trained_gap=gap_trained["worst_gap"],
                         exact_gap=gap_exact["worst_gap"],
                         path_err=path_err, path_share=path_share, **gap)
        if cuda:
            torch.cuda.empty_cache()
        print(f"[train] {arch} took {time.perf_counter() - t_arch:.1f} s; "
              f"{card}", flush=True)

    print(f"[train] phase 15 took {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)
    return out


# ---------------------------------------------------------------------- #
# phase 16: the sharded paths on a 1x1 DeviceMesh, cim_sweep, the cell report
# ---------------------------------------------------------------------- #
#: 16.a: the training cell (arch, tokens, depth) and its steps (the steps
#: after two warm-up steps, as in the cell report's ``--measure``, are
#: timed); held against the unsharded step: every leaf and loss within
#: this relative gap (a mesh of one rank computes the same ops on the
#: same data)
SHARD_TRAIN, SHARD_STEPS, SHARD_RTOL = ("yi-6b", 4096, 8), 12, 1e-6
#: 16.b: the serving engine on the mesh (arch, prompt tokens, new tokens)
SHARD_SERVE = ("falcon-mamba-7b", 2048, 4)
#: 16.d: the cell report's --measure against 16.a, relative: peak memory,
#: and the step time as the fastest timed step of each.  The sharded step
#: is host-sensitive (its host work is near the card's), and the host's
#: speed drifts over a run, so the two are timed one right after the
#: other, and a busy host only adds to a step.
MEASURE_RTOL = 0.10


def dryrun_measure(cuda: bool, configs, card: str) -> dict:
    """16.d's measured cell, ``python -m repro_torch.launch.dryrun --arch
    yi-6b --shape train_4k --set n_layers=8 --batch 1 --measure`` in a
    fresh process (run after 15.c, while this process holds the least
    memory); the reduced config on the CPU when ``configs`` is given."""
    import gc

    gc.collect()
    if cuda:
        import torch
        torch.cuda.empty_cache()
    arch, t_len, depth = SHARD_TRAIN
    cmd = ["--arch", arch, "--shape", "train_4k", "--set",
           f"n_layers={depth}", "--batch", "1", "--measure"]
    if configs:
        cfg = configs[arch]
        cmd += [f"--set={k}={getattr(cfg, k)}" for k in (
            "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab")]
        cmd += ["--set", f"seq={t_len}", "--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cmd], cwd=ROOT,
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"launch.dryrun --measure exited {proc.returncode}:\n"
             f"{proc.stdout}\n{proc.stderr}")
    rec = json.loads(lines[0])
    if rec.get("status") != "OK" or "measured" not in rec:
        fail(f"launch.dryrun --measure: {rec}")
    rec["wall_s"] = time.perf_counter() - t0
    print(f"[sharded] 16.d python -m repro_torch.launch.dryrun "
          f"{' '.join(cmd)}: exit 0 in {rec['wall_s']:.2f} s: "
          + json.dumps(rec["measured"]) + f"; {card}", flush=True)
    return rec


def shard_train(torch, ops, dev, card, configs=None) -> dict:
    """16.a on a 1x1 ``DeviceMesh`` (one rank; NCCL on the card): the
    training cell of ``build_cell`` for ``SHARD_STEPS`` steps against the
    unsharded step from the same seed (losses and every updated leaf,
    kernel launches a step, sec_per_step, fastest step, peak memory).
    Run right after :func:`dryrun_measure`'s fresh process, which 16.d
    holds to it.  ``configs`` maps an arch to its config (the CPU
    rehearsal's reduced ones)."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell, make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, AdamWConfig

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wrappers = {**ops.KERNEL_WRAPPERS, **ops.BACKWARD_WRAPPERS,
                **ops.OPTIMIZER_WRAPPERS}
    counts = lambda: {k: w.launches for k, w in wrappers.items()}
    mesh = make_debug_mesh(1, 1, device_type=dev.type)
    arch, t_len, depth = SHARD_TRAIN
    cfg = configs[arch] if configs else dataclasses.replace(
        get_arch(arch), n_layers=depth)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=t_len,
                                global_batch=1)
    opt_cfg = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=TRAIN_STEPS)
    stream = SyntheticLMStream(DataConfig(seq_len=t_len, global_batch=1,
                                          vocab=cfg.vocab, seed=0))
    cell, _ = build_cell(cfg, shape, mesh, optimizer=AdamW(opt_cfg))
    runs = {}
    for name, model, step in (
            ("unsharded", build_model(cfg), make_train_step(
                build_model(cfg), AdamW(opt_cfg))),
            ("sharded", cell.model, cell)):
        if cuda:
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        params = model.init(0, dev, trainable=True)
        opt = AdamW(opt_cfg).init(params)
        reset_launches(ops)
        losses, secs = [], []
        for i in range(SHARD_STEPS):
            batch = {k: torch.as_tensor(v).to(dev)
                     for k, v in stream.global_batch_at(i).items()}
            sync()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(float(metrics["loss"]))
            sync()
            secs.append(time.perf_counter() - t0)
        launches = counts()
        leaves = {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
                  .detach().cpu() for n, p in params.named_parameters()}
        placed = sorted({str(tuple(p.placements)) for p in
                         params.parameters() if hasattr(p, "placements")})
        runs[name] = dict(losses=losses, secs=secs, leaves=leaves,
                          launches=launches, placed=placed,
                          sec_per_step=statistics.median(
                              secs[dryrun.MEASURE_WARMUP:]),
                          fastest=min(secs[dryrun.MEASURE_WARMUP:]),
                          peak=(torch.cuda.max_memory_allocated() - base)
                          if cuda else 0)
        want = {k: 0 for k in launches}
        want["flash_attention"] = 2 * cfg.n_layers * SHARD_STEPS
        want["flash_attention_bwd"] = cfg.n_layers * SHARD_STEPS
        want.update(adamw_sumsq=2 * SHARD_STEPS, adamw_norm=SHARD_STEPS,
                    adamw_apply=SHARD_STEPS)
        if cuda and launches != want:
            fail(f"16.a {name}: launches {launches}, expected {want}")
        del params, opt, batch, metrics
    a, b = runs["sharded"], runs["unsharded"]
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                         b["losses"]))
    gaps = {n: float((a["leaves"][n].float() - v.float()).norm()
                     / max(float(v.float().norm()), 1e-30))
            for n, v in b["leaves"].items()}
    worst = max(gaps, key=gaps.get)
    equal = sum(torch.equal(a["leaves"][n], v) for n, v in b["leaves"].items())
    print(f"[sharded] 16.a {arch} depth {cfg.n_layers}, 1 x {t_len} tokens, "
          f"{SHARD_STEPS} steps through build_cell on the 1x1 mesh (leaf "
          f"placements {a['placed']}): losses {a['losses']} vs unsharded "
          f"{b['losses']} (max relative gap {loss_gap:.3e}); leaves "
          f"bit-equal {equal} of {len(gaps)}, worst relative gap "
          f"{gaps[worst]:.3e} at {worst} (bar {SHARD_RTOL}); launches a step "
          f"{ {k: v / SHARD_STEPS for k, v in a['launches'].items() if v} }; "
          f"sec_per_step (median of steps {dryrun.MEASURE_WARMUP + 1}-"
          f"{SHARD_STEPS}) sharded "
          f"{a['sec_per_step']:.4f} s vs unsharded {b['sec_per_step']:.4f} s "
          f"(steps {[round(x, 4) for x in a['secs']]} / "
          f"{[round(x, 4) for x in b['secs']]}); peak memory "
          f"{a['peak'] / 2**30:.2f} / {b['peak'] / 2**30:.2f} GiB; {card}",
          flush=True)
    if loss_gap > SHARD_RTOL or gaps[worst] > SHARD_RTOL:
        fail(f"16.a: the sharded cell is {loss_gap:.3e} (loss) / "
             f"{gaps[worst]:.3e} ({worst}) from the unsharded step")
    out = dict(sec_per_step=a["sec_per_step"], fastest=a["fastest"],
               unsharded_sec_per_step=b["sec_per_step"], peak=a["peak"],
               launches=a["launches"], bit_equal=equal, leaves=len(gaps))
    del runs, a, b, cell
    if cuda:
        torch.cuda.empty_cache()
    return out


def phase_sharded(torch, ops, dev, card, measured: dict, trained: dict,
                  configs=None) -> dict:
    """Phase 16 on a 1x1 ``DeviceMesh`` (one rank; NCCL on the card):
    ``trained`` is 16.a's record (:func:`shard_train`); 16.b
    ``ServeEngine(cfg, mesh)``'s prefill against the device engine's on
    the same weights, then greedy decode steps with equal tokens; 16.c
    ``roofline.cim_sweep`` over the ten archs on the card; 16.d the
    abstract cell report of every arch x shape and ``measured`` (from
    :func:`dryrun_measure`) against 16.a.  ``configs`` maps an arch to
    its config (the CPU rehearsal's reduced ones).  Returns each kernel's
    launches in the counted runs."""
    import tempfile

    from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serve import GenerationConfig, ServeEngine
    from repro_torch.service import reset_default_service

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wrappers = {**ops.KERNEL_WRAPPERS, **ops.BACKWARD_WRAPPERS}
    counts = lambda: {k: w.launches for k, w in wrappers.items()}
    mesh = make_debug_mesh(1, 1, device_type=dev.type)
    print(f"[sharded] mesh {mesh}; {card}", flush=True)
    out: dict = {"train": trained}

    # ---- 16.b ServeEngine(cfg, mesh) against the device engine ----------
    arch, t_len, n_new = SHARD_SERVE
    cfg = configs[arch] if configs else get_arch(arch)
    plain = ServeEngine(cfg, dev)
    meshed = ServeEngine(cfg, mesh, params=plain.params)
    prompt = np.random.default_rng(16).integers(1, cfg.vocab, (1, t_len))
    logits = {}
    for name, eng in (("device", plain), ("mesh", meshed)):
        eng._prefill(eng.params, {"tokens": eng._tokens(prompt)})   # warm-up
        reset_launches(ops)
        sync()
        t0 = time.perf_counter()
        lg, _ = eng._prefill(eng.params, {"tokens": eng._tokens(prompt)})
        sync()
        wall = time.perf_counter() - t0
        launches = counts()
        if cuda:
            expect_launches(f"16.b {name} prefill", launches,
                            "selective_scan", cfg.n_layers)
        logits[name] = lg.full_tensor() if hasattr(lg, "full_tensor") \
            else lg
        prefill_n, prefill_wall = launches["selective_scan"], wall
    gap = logit_gap(logits["mesh"], logits["device"])
    check_gap(f"16.b {arch} prefill on the mesh", gap)
    exact = bool(torch.equal(logits["mesh"], logits["device"]))
    del logits
    gen = GenerationConfig(max_new_tokens=n_new)
    reset_launches(ops)
    res_mesh = meshed.generate([list(prompt[0])], gen)
    gen_launches = counts()["selective_scan"]
    res_dev = plain.generate([list(prompt[0])], gen)
    if not np.array_equal(res_mesh["tokens"], res_dev["tokens"]):
        fail(f"16.b: the mesh engine decoded {res_mesh['tokens']}, the "
             f"device engine {res_dev['tokens']}")
    print(f"[sharded] 16.b {arch} ServeEngine(cfg, mesh), 1 x {t_len} "
          f"prompt: {prefill_n} selective_scan launches (local_map) in "
          f"{prefill_wall:.4f} s, logits against the device engine's on the same weights: max "
          f"|d| {gap['max_abs']:.4g} = {gap['rel']:.4g} of max |logit| (bar "
          f"{SERVE_REL_TOL}), top-1 {gap['top1']:.4f}, bit-equal {exact}; "
          f"generate {n_new} greedy tokens {res_mesh['tokens'].tolist()} "
          f"equal to the device engine's, {gen_launches} selective_scan "
          f"launches; prefill_s {res_mesh['prefill_s']:.4f} / "
          f"{res_dev['prefill_s']:.4f} s, decode_s {res_mesh['decode_s']:.4f}"
          f" / {res_dev['decode_s']:.4f} s (mesh / device); {card}",
          flush=True)
    out["serve"] = dict(launches=prefill_n + gen_launches, exact=exact,
                        gap=gap)
    del plain, meshed
    if cuda:
        torch.cuda.empty_cache()

    # ---- 16.c the CIM sweep through the DSE service ----------------------
    store = tempfile.mkdtemp(prefix="cim-tuner-smoke-sweep-")
    os.environ["CIM_TUNER_RESULT_STORE"] = store
    reset_default_service()
    archs = list(configs) if configs else list(ARCH_IDS)
    reset_launches(ops)
    sync()
    t0 = time.perf_counter()
    rows = roofline.cim_sweep(archs, 5.0, "vanilla-dcim", seq=512,
                              method="exhaustive", device=dev.type,
                              emit=lambda s: print(f"[sharded] 16.c {s}",
                                                   flush=True))
    sync()
    sweep_s = time.perf_counter() - t0
    se_n = ops.job_objective.launches + ops.strategy_eval.launches
    reset_default_service()
    shutil.rmtree(store, ignore_errors=True)
    if len(rows) != len(archs) or any(r["cached"] for r in rows) or not all(
            math.isfinite(r[k]) and r[k] > 0 for r in rows
            for k in ("tops_w", "gops")):
        fail(f"16.c: cim_sweep rows {rows}")
    if cuda and se_n == 0:
        fail("16.c: cim_sweep launched no strategy_eval kernel")
    print(f"[sharded] 16.c cim_sweep over {len(rows)} archs (seq 512, "
          f"vanilla-dcim, 5 mm^2, exhaustive): {sweep_s:.3f} s, {se_n} "
          f"strategy_eval launches; {card}", flush=True)
    out["sweep"] = dict(rows=rows, wall_s=sweep_s, launches=se_n)

    # ---- 16.d the cell report ------------------------------------------
    t0 = time.perf_counter()
    report = [dryrun.run_cell(a_id, s_id, device=dev.type)
              for a_id in ARCH_IDS for s_id in SHAPES]
    for r in report:
        if r["status"] == "OK" and not (r["state_bytes"] > 0 and
                                        r["model_flops"] > 0):
            fail(f"16.d: cell record {r}")
    print(f"[sharded] 16.d the abstract cell report, {len(report)} cells "
          f"in {time.perf_counter() - t0:.2f} s (arch shape status state "
          f"GB fits): " + "; ".join(
              f"{r['arch']} {r['shape']} {r['status']}"
              + (f" {r['state_bytes'] / 1e9:.1f} {r['fits']}"
                 if r["status"] == "OK" else "") for r in report)
          + f"; {card}", flush=True)
    m = measured["measured"]
    fastest = out["train"]["fastest"]
    step_gap = abs(m["step_s_min"] - fastest) / fastest
    print(f"[sharded] 16.d --measure (fresh process) against 16.a: fastest "
          f"step {m['step_s_min']:.4f} s vs {fastest:.4f} s (gap "
          f"{step_gap:.4f}; medians {m['step_s']:.4f} / "
          f"{out['train']['sec_per_step']:.4f} s), peak "
          + (f"{m['peak_bytes'] / 2**30:.2f} GiB vs "
             f"{out['train']['peak'] / 2**30:.2f} GiB, model FLOPs share "
             f"{m['model_flops_share']:.4f}" if cuda else "not measured (CPU)")
          + f", launches a step {m['launches_per_step']}; {card}",
          flush=True)
    if cuda:
        peak_gap = abs(m["peak_bytes"] - out["train"]["peak"]) / \
            out["train"]["peak"]
        if step_gap > MEASURE_RTOL or peak_gap > MEASURE_RTOL:
            fail(f"16.d: the measured cell is {step_gap:.4f} (step) / "
                 f"{peak_gap:.4f} (peak) from 16.a (bar {MEASURE_RTOL})")
        want = {"flash_attention": 2.0 * SHARD_TRAIN[2],
                "flash_attention_bwd": 1.0 * SHARD_TRAIN[2]}
        if m["launches_per_step"] != want:
            fail(f"16.d: launches a step {m['launches_per_step']}, expected "
                 f"{want}")
    print(f"[sharded] phase 16 took {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)
    return out


class PhaseClock:
    """The wall of each phase, printed as the phase ends, and their sum."""

    def __init__(self, card: str):
        self.card, self.walls = card, {}
        self.start = self.last = time.perf_counter()

    def done(self, phase: str) -> None:
        now = time.perf_counter()
        self.walls[phase] = now - self.last
        self.last = now
        print(f"[phase] {phase} took {self.walls[phase]:.1f} s; {self.card}",
              flush=True)

    def summary(self) -> None:
        print("[phase] walls: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in self.walls.items())
              + f"; the whole run {time.perf_counter() - self.start:.1f} s; "
              f"{self.card}", flush=True)


def main() -> None:
    import tempfile

    import torch

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        fail("no CUDA card: torch.cuda.is_available() is false")
    # the service behind co_explore keeps its results in a store of this
    # run's own, removed at the end
    store_root = tempfile.mkdtemp(prefix="cim-tuner-smoke-store-")
    os.environ["CIM_TUNER_RESULT_STORE"] = store_root
    os.environ.pop("CIM_TUNER_SERVICE_URL", None)
    try:
        from repro_torch import core as port_core
        from repro_torch.core import cost_model
        from repro_torch.core.pruning import (DesignSpace, candidates_with_bw,
                                              enumerate_space, prune_space)
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels import cim_matmul as cm_k
        from repro_torch.kernels import flash_attention as fa_k
        from repro_torch.kernels import flash_attention_bwd as fab_k
        from repro_torch.kernels import selective_scan as ss_k
        from repro_torch.kernels import selective_scan_bwd as ssb_k
        from repro_torch.kernels import strategy_eval as se
    except ImportError as e:
        fail(f"the port is not importable from {ROOT / 'src'}: {e}")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; cards {torch.cuda.device_count()}")
    print(card)
    clock = PhaseClock(card)

    # the plain versions and the library calls compute fp32 products in
    # true fp32, not in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clock.done("1 device")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    variant_proc, variant_lib = start_fmad_variant(se, build)
    # slice 2's libraries build meanwhile, one nvcc each (read in phase 7),
    # and the training path's backward kernels (read in phase 15)
    new_libs = [cm_k, fa_k, ss_k]
    bwd_libs = [fab_k, ssb_k]
    pool = concurrent.futures.ThreadPoolExecutor(len(new_libs) + len(bwd_libs))
    new_builds = [pool.submit(build.build, m.SOURCE, m.NVCC_FLAGS)
                  for m in new_libs]
    bwd_builds = [pool.submit(build.build, m.SOURCE, m.NVCC_FLAGS)
                  for m in bwd_libs]
    se.build()
    lib_s = time.perf_counter() - t0
    variant_out, _ = variant_proc.communicate()
    if variant_proc.returncode != 0:
        fail(f"fmad variant build failed:\n{variant_out}")
    print(f"[build] {se.library_path().name} in {lib_s:.2f} s "
          "(both builds started together)")
    print(se.ptxas_report().strip())

    clock.done("2 build")

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
        b_ms, b_by = bound_ms(cand, job.ops, params)
        timing[dname] = dict(
            ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=float((got - want).abs().max()),
            flops=needed_flops(job.ops, params, cand.shape[1]),
            shape=list(cand.shape) + [job.ops.shape[1]])
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

    clock.done("3 kernel")

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
    busy_us, wall_traced = traced_busy(
        torch, lambda: engine.run(jobs, method="exhaustive"),
        torch.cuda.synchronize)
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

    clock.done("4 main path")

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

    clock.done("5 Table II")

    # ---- 6. SA through co_explore's defaults -----------------------------
    # timed and counted drives pass engine= (co_explore's documented
    # bypass of the service), so a repeat runs the engine, not the store
    direct = port_core.default_engine("cuda")
    ops.job_objective.launches = 0
    ops.strategy_eval.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sa = port_core.co_explore(port_core.get_macro("vanilla-dcim"), wl,
                              FIG7_BUDGET_MM2, engine=direct)
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

    clock.done("6 SA")

    # ---- 7. build slice 2's kernels; the tensor cores in their SASS -------
    for (name, m), fut in zip(zip(NEW_KERNELS, new_libs), new_builds):
        lib = fut.result()
        report = build.ptxas_report(m.SOURCE, m.NVCC_FLAGS)
        print(f"[build] {lib.name} (started in phase 2): "
              f"{ptxas_summary(report)}; full report in "
              f"{lib.name}.ptxas.txt")
        for kname, regs, st, ld in ptxas_table(report):
            if kname.startswith(("tc::", "tf::")):
                print(f"[build]   {kname}: {regs} registers, {st} bytes of "
                      f"spill stores, {ld} of spill loads")
        counts = sass_counts(build, lib)
        total = lambda op: sum(v[op] for v in counts.values())
        print(f"[sass] {lib.name}: HGMMA {total('HGMMA')}, UTMALDG "
              f"{total('UTMALDG')}, MUFU.RCP {total('MUFU.RCP')} over "
              f"{len(counts)} kernels")
        if name not in TC_KERNELS:
            print(f"[sass] {lib.name}: MUFU.RCP per kernel: " + ", ".join(
                f"{short_name(k)} {v['MUFU.RCP']}"
                for k, v in sorted(counts.items())))
        for route, (names, want) in TC_KERNELS.get(name, {}).items():
            tc = {k: (v["HGMMA"], v["UTMALDG"]) for k, v in counts.items()
                  if any(t in k for t in names)}
            print(f"[sass] {lib.name}: {route} tensor-core instantiations "
                  f"{len(tc)}, each HGMMA/UTMALDG: "
                  + ", ".join(f"{short_name(k)} {h}/{u}"
                              for k, (h, u) in sorted(tc.items())))
            if len(tc) != want:
                fail(f"{name}: {len(tc)} {route} tensor-core kernels in the "
                     f"SASS, expected {want}")
            if any(h == 0 for h, _ in tc.values()):
                fail(f"{name}: a {route} instantiation has no HGMMA: "
                     + ", ".join(short_name(k) for k, (h, _) in tc.items()
                                 if h == 0))
    pool.shutdown()

    clock.done("7 build")

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
    # every bf16 tile set of the tensor-core routes: a ragged matmul whose K
    # and N need TMA padding; attention with T != S, both ragged
    a = on_card(rng.standard_normal((257, 300)), torch.bfloat16)
    b = on_card(rng.standard_normal((300, 250)), torch.bfloat16)
    for tiling in ("AF", "PF"):
        for bm in cm_k.TILES:
            for bn in cm_k.TILES:
                for bk in cm_k.TILES:
                    kw = {"tiling": tiling, "bm": bm, "bn": bn, "bk": bk}
                    check_close(f"cim_matmul {kw} (257, 300, 250) bf16",
                                ops.cim_matmul(a, b, **kw),
                                plain_of(ref, "cim_matmul", (a, b), kw),
                                *tolerance("cim_matmul", "bfloat16", kw))
                    n_checked += 1
    # every compiled head width, and 120 and 16 on a wider one
    for d in (*fa_k.HEAD_DIMS, 120, 16):
        for t, s_len in ((200, 333), (333, 200)):
            q, k, v = (on_card(rng.standard_normal((2, ln, d)),
                               torch.bfloat16) for ln in (t, s_len, s_len))
            for causal in (False, True):
                for bq, bk in fa_k.WIDTH_TILES[fa_k.compiled_width(d)]:
                    kw = {"causal": causal, "bq": bq, "bk": bk}
                    check_close(
                        f"flash_attention {kw} (2, {t}, {s_len}, {d}) "
                        "bf16", ops.flash_attention(q, k, v, **kw),
                        plain_of(ref, "flash_attention", (q, k, v), kw),
                        *tolerance("flash_attention", "bfloat16", kw))
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
    micro = obs_profile._microbench_cases(tuple(NEW_KERNELS),
                                          np.random.default_rng(0), dev)
    # the same shapes in bf16, for the two kernels with a tensor-core route
    # and the scan (its a and h0 stay fp32)
    micro += [(kernel, tiling, fn,
               tuple(x.to(torch.bfloat16) if kernel in TC_KERNELS or n < 4
                     else x for n, x in enumerate(args)), kwargs)
              for kernel, tiling, fn, args, kwargs in micro
              if kernel in TC_KERNELS or kernel == "selective_scan"]
    for kernel, tiling, fn, args, kwargs in micro:
        new_cases[kernel].append(measure_case(
            torch, ref, kernel, fn, args, kwargs,
            f"{fn.__bucket_fn__(*args, **kwargs)} {tiling} "
            f"{dtype_of(args[0])}", card))
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
    # the prefills of the archs at the other head widths, bf16: 120 (run on
    # the kernels' 128) and 256; recurrentgemma-9b's local attention at
    # its 2,048-token window
    for name, (bh, t, d) in (("h2o-danube-3-4b prefill", (32, 4096, 120)),
                             ("gemma-7b prefill", (16, 4096, 256)),
                             ("recurrentgemma-9b local", (16, 2048, 256))):
        qkv = tuple(on_card(rng.standard_normal((bh, t, d)), torch.bfloat16)
                    for _ in range(3))
        full.append(("flash_attention", ops.flash_attention, qkv,
                     {"causal": True}, f"{name} {bh}x{t}x{t}x{d} causal=True"))
    for dtype in (torch.float32, torch.bfloat16):
        full.append(("selective_scan", ops.selective_scan,
                     falcon_scan_args(rng, on_card, dtype, dev),
                     FALCON_TILING, "falcon-mamba-7b "
                     + "x".join(map(str, FALCON_SCAN)) + " ct{ct}xci{ci}"
                     .format(**FALCON_TILING)))
    for kernel, fn, args, kwargs, label in full:
        new_cases[kernel].append(measure_case(
            torch, ref, kernel, fn, args, kwargs,
            f"{label} {dtype_of(args[0])}", card))
        del args
    del full
    torch.cuda.empty_cache()
    # the fp32 (3xTF32) routes at every tile set, on the ragged shapes of
    # the bf16 sweep above, each checked and timed
    a = on_card(rng.standard_normal((257, 300)))
    b = on_card(rng.standard_normal((300, 250)))
    for tiling in ("AF", "PF"):
        for bm in cm_k.TILES:
            for bn in cm_k.TILES:
                for bk in cm_k.TILES:
                    kw = {"tiling": tiling, "bm": bm, "bn": bn, "bk": bk}
                    new_cases["cim_matmul"].append(measure_case(
                        torch, ref, "cim_matmul", ops.cim_matmul, (a, b), kw,
                        f"{tiling} bm{bm}xbn{bn}xbk{bk} 257x300x250 float32",
                        card))
    for d in (*fa_k.HEAD_DIMS, 120, 16):
        for t, s_len in ((200, 333), (333, 200)):
            qkv = tuple(on_card(rng.standard_normal((2, ln, d)))
                        for ln in (t, s_len, s_len))
            for causal in (False, True):
                for bq, bk in fa_k.WIDTH_TILES[fa_k.compiled_width(d)]:
                    kw = {"causal": causal, "bq": bq, "bk": bk}
                    new_cases["flash_attention"].append(measure_case(
                        torch, ref, "flash_attention", ops.flash_attention,
                        qkv, kw, f"bq{bq}xbk{bk} 2x{t}x{s_len}x{d} "
                        f"causal={causal} float32", card))

    clock.done("8 kernels")

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
                                      method="exhaustive", tech=cm.tech,
                                      engine=direct)
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

    clock.done("9 calibrate")

    # ---- 11. search: Sobol, GA, DE, the portfolio (before phase 10) ------
    search_paths = phase_search(torch, port_core, ops, ref, dev, jobs, meta,
                                results, artifact, card)

    clock.done("11 search")

    # ---- 13. verify and scale (before phase 10, which records its paths) -
    verify_paths, verify_extra = phase_verify(
        torch, port_core, ops, dev, jobs, meta, results, engine, card)

    clock.done("13 verify")

    # ---- 10. strategy_eval at each of the main path's launch shapes -------
    # each path once more, untimed, its launches recorded by shape
    shapes = LaunchShapes(se)
    fp64_shapes: set = set()
    path_counts: dict[str, collections.Counter] = {}
    for name, drive, timed_launches in (
            ("Fig. 7 sweep", lambda: engine.run(jobs, method="exhaustive"),
             main_launches),
            ("SA", lambda: port_core.co_explore(macro, wl, FIG7_BUDGET_MM2,
                                                engine=direct),
             sa_launches),
            ("microbench", lambda: obs_profile.run_microbench(
                kernels=("strategy_eval",)), cal_launches["strategy_eval"]),
            ("calibrated job", lambda: port_core.co_explore(
                macro, wl, FIG7_BUDGET_MM2, method="exhaustive",
                tech=cm.tech, engine=direct), explore_launches),
            *search_paths, *verify_paths):
        if name == search_paths[0][0]:
            fp64_shapes = set(shapes.counts)      # phases 4, 6 and 9
        reset_launches(ops)
        before = collections.Counter(shapes.counts)
        with shapes:
            drive()
            torch.cuda.synchronize()
        path_counts[name] = shapes.counts - before
        recorded = sum(path_counts[name].values())
        counted = se_launches_now(ops)
        if not recorded == counted == timed_launches:
            fail(f"{name}: {recorded} strategy_eval launches recorded, "
                 f"{counted} counted, {timed_launches} in its timed run")
    se_launches = sum(shapes.counts.values())
    se_rows = strategy_eval_rows(torch, se, ref, cost_model, shapes,
                                 se_instantiations(build, se), card,
                                 fp64_shapes)
    graph32 = {(*r["shape"], r["totals"]): r["graph_ms"] or 0.0
               for r in se_rows if r["dtype"] == "float32"}
    for name, counts in path_counts.items():
        spent = sum(c * graph32[(*k[:3], k[4])] for k, c in counts.items())
        print(f"[strategy_eval] {name}: {sum(counts.values())} launches "
              f"over {len(counts)} shapes, launches x graph time (fp32) = "
              f"{spent:.4f} ms of device time; {card}", flush=True)

    clock.done("10 strategy_eval")

    # ---- 12. the DSE service on the card ---------------------------------
    service_launches = phase_service(torch, port_core, ops, dev, jobs, meta,
                                     results, wall, card)
    shutil.rmtree(store_root, ignore_errors=True)

    clock.done("12 service")

    # ---- 14. serve: yi-6b, falcon-mamba-7b, h2o-danube-3-4b, gemma-7b ------
    serve = phase_serve(torch, ops, ref, dev, card)

    clock.done("14 serve")

    # ---- 15. train: yi-6b, falcon-mamba-7b (depth 8), gemma-7b (depth 4) ---
    for (name, m), fut in zip(zip(BWD_KERNELS, bwd_libs), bwd_builds):
        lib = fut.result()
        report = build.ptxas_report(m.SOURCE, m.NVCC_FLAGS)
        print(f"[build] {lib.name} (started in phase 2): "
              f"{ptxas_summary(report)}; full report in {lib.name}.ptxas.txt")
        check_bwd_build(build, name, lib, report)
    # 16.d's measured cell runs in a fresh process right after 15.c, while
    # this process holds the least memory (after 15.b the card lacks room),
    # and 16.a's timed cell right after it, on the same host's time
    measured: dict = {}
    trained: dict = {}

    def sharded_cells():
        measured.update(dryrun_measure(True, None, card))
        trained.update(shard_train(torch, ops, dev, card))

    train = phase_train(torch, ops, ref, dev, card, after_cli=sharded_cells)
    clock.done("15 train")

    # ---- 16. sharded: build_cell and ServeEngine on a 1x1 mesh, cim_sweep,
    # the cell report ------------------------------------------------------
    sharded = phase_sharded(torch, ops, dev, card, measured, trained)
    clock.done("16 sharded")
    clock.summary()

    t32 = timing["float32"]
    # phase 16's counted runs: 16.a's sharded training cell, 16.b's mesh
    # engine (prefill and generate), 16.c's sweep
    shard_n = dict(sharded["train"]["launches"])
    shard_n["selective_scan"] += sharded["serve"]["launches"]
    shard_n["strategy_eval"] = sharded["sweep"]["launches"]
    new_lines = []
    for name, (source, replaces) in NEW_KERNELS.items():
        # the serve path's kernels report its first shape (14.a's prefill)
        # and its launches; cim_matmul the calibration path's
        on_path = serve.get(name)
        first = on_path["cases"][0] if on_path else new_cases[name][0]
        new_lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (sum(on_path["launches"].values()) if on_path
                         else cal_launches[name]) + shard_n[name],
            "sharded_launches": shard_n[name],
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "design": DESIGNS[name],
            "shape": first["label"],
            "calibration_launches": cal_launches[name],
            **({"serve_launches": on_path["launches"],
                "serve_cases": on_path["cases"],
                "train_launches": train["forward_launches"][name],
                "train_launches_by_arch": {
                    arch: n[name] for arch, n in
                    train["forward_by_arch"].items() if name in n}}
               if on_path else {}),
            "cases": new_cases[name]})
    for name, (source, replaces, forward) in BWD_KERNELS.items():
        # the training path's launches (15.b); its full-width case first
        first = train[name]["cases"][0]
        new_lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": train[name]["launches"] + shard_n[name],
            "launches_by_arch": train[name]["by_arch"],
            "sharded_launches": shard_n[name],
            **{k: first[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
            "differentiates": forward,
            "note": "no TPU counterpart: the reference differentiates jnp "
                    "(src/repro/models/layers.py:130-192, "
                    "src/repro/models/ssm.py:96-132)",
            "design": BWD_DESIGNS[name], "shape": first["label"],
            "cases": train[name]["cases"]})
    for name, (source, replaces, calls, nbytes) in OPT_KERNELS.items():
        # the training path's launches (15.b, 16.a); 15.a's yi-6b table
        first = train["optimizer"][0]
        key = name.split("_")[1]
        count = lambda n: sum(n[k] for k in calls)
        new_lines.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": count(train["optimizer_launches"]) + count(shard_n),
            "launches_by_arch": {arch: count(n) for arch, n in
                                 train["optimizer_by_arch"].items()},
            "sharded_launches": count(shard_n),
            "max_abs_err": 0.0 if key == "apply" else None,
            "max_rel_err": first["norm_rel_err"] if key == "norm" else 0.0,
            "ms": first[f"{key}_ms"], "graph_ms": first[f"{key}_graph_ms"],
            "plain_ms": first[f"loop_{key}_ms"],
            "bound_ms": first[f"{key}_bound_ms"],
            "bound_by": f"bytes ({nbytes} B a parameter)",
            "library_ms": None,
            "note": "no TPU counterpart: the reference's optimizer is jnp "
                    "(src/repro/optim/adamw.py)",
            "design": OPT_DESIGN,
            "shape": f"{first['arch']} depth {first['layers']} at full "
                     f"width: {first['leaves']} leaves, {first['params']} "
                     f"parameters",
            "cases": train["optimizer"]})
    print(json.dumps({"kernels": [{
        "name": "strategy_eval", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        # the paths phase 10 recorded, the service's cold run (12.1) and
        # phase 13's checkpoint and resume runs
        "launches": se_launches + service_launches + verify_extra
        + shard_n["strategy_eval"],
        "service_launches": service_launches,
        "sharded_launches": shard_n["strategy_eval"],
        "verify_launches": verify_extra + sum(
            sum(path_counts[name].values()) for name, *_ in verify_paths),
        "max_abs_err": t32["max_abs_err"], "ms": t32["ms"],
        "plain_ms": t32["plain_ms"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": None,
        "design": DESIGNS["strategy_eval"],
        "float64": {k: timing["float64"][k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")},
        "shapes": se_rows,
    }, *new_lines]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
