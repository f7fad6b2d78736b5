"""Kernel profiling tier: wall-clock histograms + roofline utilization.

Profiling hooks around the kernel wrappers (``repro_torch.kernels.ops``)
record, per ``(kernel, bucket)`` series:

``cim_kernel_us`` (histogram)
    Wall clock per call in microseconds (timed to completion with
    ``torch.cuda.synchronize``), with the producing span's id as the
    bucket exemplar.
``cim_kernel_flops_per_call`` / ``cim_kernel_bytes_per_call`` (gauges)
    The work of one call, counted from its shapes by one documented
    formula per kernel (:func:`work_counts`).
``cim_kernel_roofline_utilization`` (gauge)
    Achieved FLOP/s over the roofline-attainable rate
    ``min(peak_flops, peak_bw * arithmetic_intensity)``.

Everything is gated on ``CIM_TUNER_PROFILE`` (checked per call, so the
hooks cost one env lookup when off).  Peak rates default to one NVIDIA
H100 SXM (NVIDIA's data sheet, 700 W): 67e12 FLOP/s in fp32 outside the
tensor cores and 3.35e12 B/s of HBM; ``CIM_TUNER_PEAK_FLOPS`` /
``CIM_TUNER_PEAK_BW`` override them.

:func:`run_microbench` is the measurement half of the calibration tier:
it times the port's kernels over a small tiling sweep -- the reference's
cases, drawn from ``np.random.default_rng(seed)`` in the same order -- and
returns :class:`MeasurementRecord` dicts with the reference's schema

    {"kernel": str,   # cim_matmul | flash_attention | selective_scan
                      # | strategy_eval
     "bucket": str,   # shape bucket, e.g. "128x128x128"
     "tiling": str,   # tiling variant, e.g. "AF", "bq64xbk64", "ct16xci16"
     "us":     float, # one call's wall clock, microseconds
     "flops":  float | None,   # work counted from the shapes
     "bytes":  float | None,
     "seed":   int}   # RNG seed the inputs were drawn from

which ``repro_torch.core.calibration.fit_corrections`` consumes.  The
reference takes ``flops`` / ``bytes`` from XLA's cost analysis; the port
counts them from shapes, so the two differ on purpose where XLA's count is
off (a loop body it does not count, interpret-mode intermediates).
"""
from __future__ import annotations

import os
import threading
import time
import typing

import numpy as np

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = [
    "PROFILE_ENV",
    "KERNEL_US_BUCKETS",
    "MeasurementRecord",
    "profiling_enabled",
    "instrument",
    "roofline_utilization",
    "peak_flops",
    "peak_bw",
    "work_counts",
    "summary",
    "run_microbench",
    "record_measurements",
    "take_measurements",
]

PROFILE_ENV = "CIM_TUNER_PROFILE"

#: per-call kernel wall clock is microseconds, not seconds
KERNEL_US_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                     500.0, 1e3, 2.5e3, 5e3, 1e4, 2.5e4, 1e5, 2.5e5, 1e6)

#: one NVIDIA H100 SXM (data sheet, dense, 700 W): fp32 outside the tensor
#: cores, and HBM bandwidth
DEFAULT_PEAK_FLOPS = 67e12
DEFAULT_PEAK_BW = 3.35e12

_REG = _metrics.registry()
_M_US = _REG.histogram(
    "cim_kernel_us", "Per-call kernel wall clock (microseconds)",
    ("kernel", "bucket"), buckets=KERNEL_US_BUCKETS)
_M_FLOPS = _REG.gauge(
    "cim_kernel_flops_per_call",
    "Work counted from shapes: FLOPs per kernel call", ("kernel", "bucket"))
_M_BYTES = _REG.gauge(
    "cim_kernel_bytes_per_call",
    "Work counted from shapes: bytes read and written per kernel call",
    ("kernel", "bucket"))
_M_ROOF = _REG.gauge(
    "cim_kernel_roofline_utilization",
    "Achieved FLOP/s over the roofline-attainable rate",
    ("kernel", "bucket"))
_M_RUNTIME = _REG.gauge(
    "cim_kernel_profile_runtime_seconds",
    "Wall clock of the last kernel micro-profile pass")


def profiling_enabled() -> bool:
    """Whether ``CIM_TUNER_PROFILE`` turns the kernel hooks on."""
    return os.environ.get(PROFILE_ENV, "") not in ("", "0", "false", "no")


def _env_float(var: str, default: float) -> float:
    raw = os.environ.get(var)
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def peak_flops() -> float:
    """Peak FLOP/s the roofline is drawn against
    (``CIM_TUNER_PEAK_FLOPS``, default H100 SXM fp32)."""
    return _env_float("CIM_TUNER_PEAK_FLOPS", DEFAULT_PEAK_FLOPS)


def peak_bw() -> float:
    """Peak memory bandwidth in bytes/s (``CIM_TUNER_PEAK_BW``, default
    H100 SXM HBM)."""
    return _env_float("CIM_TUNER_PEAK_BW", DEFAULT_PEAK_BW)


def roofline_utilization(flops: float, nbytes: float,
                         seconds: float) -> float:
    """Achieved FLOP/s over the roofline-attainable rate for one call.

    Attainable is ``min(peak_flops, peak_bw * intensity)`` with
    ``intensity = flops / nbytes``; zero-byte kernels are compute-bound
    by definition."""
    if seconds <= 0 or flops <= 0:
        return 0.0
    achieved = flops / seconds
    if nbytes > 0:
        attainable = min(peak_flops(), peak_bw() * (flops / nbytes))
    else:
        attainable = peak_flops()
    return achieved / attainable if attainable > 0 else 0.0


# --------------------------------------------------------------------- #
# work counted from shapes, one formula per kernel
# --------------------------------------------------------------------- #
#: floating-point operations (add, sub, mul, div, ceil, floor, min, max,
#: compare) of matmul_cost for one (candidate, operator) under strategy
#: s = 4*rev + 2*wp + pf, counted from its formula, plus the argmin's score
#: compare: 101 shared terms, 11/22/16/33 for the IP-AF / IP-PF / WP-AF /
#: WP-PF psum spill, 1 compare
FLOPS_PER_STRATEGY = (113, 124, 118, 135, 113, 124, 118, 135)
#: per (candidate, operator): count-weighted latency and energy sums
FLOPS_PER_OPERATOR = 4
#: per candidate: SRAM bits, area, objective, area penalty, bandwidth rule
FLOPS_PER_CANDIDATE = 38
#: per kept (query, key) pair beyond the 4 d of the two products: scale,
#: running max, subtraction, exp and the denominator's sum
ATTN_SOFTMAX_FLOPS = 5


def matmul_work(m: int, n: int, k: int, itemsize: int) -> tuple[float, float]:
    """``[M, K] @ [K, N]``: 2 M N K flops; each input read once and the
    output written once, (M K + K N + M N) * itemsize bytes."""
    return 2.0 * m * n * k, float((m * k + k * n + m * n) * itemsize)


def attention_pairs(bh: int, t: int, s: int, causal: bool) -> float:
    """(query, key) pairs attention needs: all T S, or with top-left causal
    masking those with key <= query."""
    if not causal:
        return float(bh) * t * s
    full = min(t, s)                       # rows 0..min-1 see q+1 keys
    return float(bh) * (full * (full + 1) / 2 + max(t - s, 0) * s)


def attention_work(bh: int, t: int, s: int, d: int, causal: bool,
                   itemsize: int) -> tuple[float, float]:
    """Streaming-softmax attention: per needed (query, key) pair 4 d flops
    (the q.k and p.v products) plus :data:`ATTN_SOFTMAX_FLOPS`; q, k, v
    read once and the output written once."""
    flops = attention_pairs(bh, t, s, causal) * (4 * d + ATTN_SOFTMAX_FLOPS)
    return flops, float((2 * bh * t * d + 2 * bh * s * d) * itemsize)


def scan_work(b: int, t: int, i: int, s: int, itemsize: int,
              state_itemsize: int = 4) -> tuple[float, float]:
    """Mamba-1 scan: per (b, t, i) one dt * x, and per state s the
    dt * a, its exp, da * h, (dt x) * B, the add, and h * C with its add
    into y: B T I (7 S + 1) flops.  xi, dt, B, C read and y written once
    at the inputs' width; a, h0 read and h_last written once at the
    state's."""
    flops = float(b) * t * i * (7 * s + 1)
    nbytes = (3 * b * t * i + 2 * b * t * s) * itemsize + \
        (i * s + 2 * b * i * s) * state_itemsize
    return flops, float(nbytes)


def strategy_eval_work(n_cands: int, n_ops: int, itemsize: int,
                       allowed: typing.Sequence[bool] = (True,) * 8,
                       ) -> tuple[float, float]:
    """The cost model over ``n_cands`` candidates and ``n_ops`` real
    operators under the allowed strategies (:data:`FLOPS_PER_STRATEGY`
    each, plus :data:`FLOPS_PER_OPERATOR` and
    :data:`FLOPS_PER_CANDIDATE`); candidate rows (6 values) and operator
    rows (5) read once, one objective written per candidate."""
    per_op = sum(f for f, ok in zip(FLOPS_PER_STRATEGY, allowed) if ok) + \
        FLOPS_PER_OPERATOR
    flops = float(n_cands) * (n_ops * per_op + FLOPS_PER_CANDIDATE)
    return flops, float((7 * n_cands + 5 * n_ops) * itemsize)


def work_counts(kernel: str, args: tuple, kwargs: dict,
                ) -> tuple[float, float]:
    """(flops, bytes) of one call of ``kernel`` with these tensor
    arguments (the wrappers' signatures in ``repro_torch.kernels.ops``)."""
    if kernel == "cim_matmul":
        a, b = args[:2]
        (m, k), n = a.shape, b.shape[1]
        return matmul_work(m, n, k, a.element_size())
    if kernel == "flash_attention":
        q, k = args[:2]
        bh, t, d = q.shape
        return attention_work(bh, t, k.shape[1], d,
                              kwargs.get("causal", True), q.element_size())
    if kernel == "selective_scan":
        xi, a = args[0], args[4]
        b, t, i = xi.shape
        return scan_work(b, t, i, a.shape[1], xi.element_size(),
                         a.element_size())
    if kernel == "strategy_eval":
        from repro_torch.core.cost_model import strategy_mask

        cands, ops_arr = args[:2]
        n_ops = int((ops_arr[:, 3] > 0).sum())
        return strategy_eval_work(
            cands.shape[0], n_ops, cands.element_size(),
            strategy_mask(kwargs.get("strategy_set", "st")))
    raise ValueError(f"no work formula for kernel {kernel!r}")


def _synchronize(out) -> None:
    """Wait for the card when ``out`` (a tensor or a tuple of them) lies
    on one."""
    import torch

    first = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(first, torch.Tensor) and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


def profiled_call(kernel: str, fn, bucket: str, args: tuple,
                  kwargs: dict):
    """Run ``fn(*args, **kwargs)`` timed to completion, recording the
    ``cim_kernel_*`` series for ``(kernel, bucket)``."""
    with _trace.span(f"kernel.{kernel}", cat="kernel", kernel=kernel,
                     bucket=bucket) as sp:
        out = fn(*args, **kwargs)
        _synchronize(out)
    _M_US.observe(sp.duration_s * 1e6,
                  exemplar={"span_id": sp.span_id},
                  kernel=kernel, bucket=bucket)
    flops, nbytes = work_counts(kernel, args, kwargs)
    _M_FLOPS.set(flops, kernel=kernel, bucket=bucket)
    _M_BYTES.set(nbytes, kernel=kernel, bucket=bucket)
    _M_ROOF.set(roofline_utilization(flops, nbytes, sp.duration_s),
                kernel=kernel, bucket=bucket)
    return out


def instrument(kernel: str, fn, bucket_fn) -> typing.Callable:
    """Wrap one kernel entry point with the profiling hook.

    ``bucket_fn(*args, **kwargs) -> str`` derives the shape-bucket label;
    with profiling off the wrapper is a single env lookup, so the
    default path stays effectively free."""
    def wrapper(*args, **kwargs):
        if not profiling_enabled():
            return fn(*args, **kwargs)
        return profiled_call(kernel, fn, bucket_fn(*args, **kwargs),
                             args, kwargs)
    wrapper.__name__ = getattr(fn, "__name__", kernel)
    wrapper.__qualname__ = getattr(fn, "__qualname__", kernel)
    wrapper.__doc__ = getattr(fn, "__doc__", None)
    wrapper.__wrapped__ = fn
    wrapper.__bucket_fn__ = bucket_fn
    return wrapper


class MeasurementRecord(typing.TypedDict):
    """One timed kernel call -- the calibration tier's unit of evidence.

    The documented schema (see the module docstring): ``kernel``,
    ``bucket``, ``tiling``, ``us``, ``flops``, ``bytes``, ``seed``."""
    kernel: str
    bucket: str
    tiling: str
    us: float
    flops: typing.Optional[float]
    bytes: typing.Optional[float]
    seed: int


def summary(records: typing.Sequence[MeasurementRecord] | None = None,
            ) -> list[dict]:
    """Per-(kernel, bucket) profile rows, sorted: call count, mean
    microseconds, FLOPs/bytes and roofline utilization.

    With ``records`` (e.g. the return of :func:`run_microbench`) the rows
    aggregate exactly those measurements; without, they come from the
    process-wide metrics registry (everything profiled so far)."""
    if records is not None:
        acc: dict[tuple[str, str], list[MeasurementRecord]] = {}
        for r in records:
            acc.setdefault((r["kernel"], r["bucket"]), []).append(r)
        rows = []
        for (kernel, bucket), group in acc.items():
            us = sum(r["us"] for r in group) / len(group)
            flops = next((r["flops"] for r in group
                          if r["flops"] is not None), 0.0) or 0.0
            nbytes = next((r["bytes"] for r in group
                           if r["bytes"] is not None), 0.0) or 0.0
            rows.append({
                "kernel": kernel,
                "bucket": bucket,
                "calls": len(group),
                "us_per_call": us,
                "flops": flops,
                "bytes": nbytes,
                "roofline_utilization": roofline_utilization(
                    flops, nbytes, us * 1e-6),
            })
        rows.sort(key=lambda r: (r["kernel"], r["bucket"]))
        return rows
    rows = []
    for values, child in _M_US.samples():
        kernel, bucket = values
        s, n = child.snapshot()
        if n == 0:
            continue
        rows.append({
            "kernel": kernel,
            "bucket": bucket,
            "calls": n,
            "us_per_call": s / n,
            "flops": _M_FLOPS.value(kernel=kernel, bucket=bucket),
            "bytes": _M_BYTES.value(kernel=kernel, bucket=bucket),
            "roofline_utilization": _M_ROOF.value(kernel=kernel,
                                                  bucket=bucket),
        })
    rows.sort(key=lambda r: (r["kernel"], r["bucket"]))
    return rows


# --------------------------------------------------------------------- #
# standard micro-profile pass
# --------------------------------------------------------------------- #
_ALL_KERNELS = ("cim_matmul", "flash_attention", "selective_scan",
                "strategy_eval")


def _microbench_cases(kernels: tuple[str, ...], rng, device) -> list[tuple]:
    """(kernel, tiling, fn, args, kwargs) cases for the tiling sweep, on
    ``device``: the reference's cases, drawn from ``rng`` in its order.

    Inputs are drawn once (shared across tiling variants of a kernel) so
    variant timings differ only by tiling, not data."""
    import torch

    from repro_torch.kernels import ops

    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    cases: list[tuple] = []
    if "cim_matmul" in kernels:
        a = f32(rng.standard_normal((128, 128)))
        b = f32(rng.standard_normal((128, 128)))
        for tiling in ("AF", "PF"):
            cases.append(("cim_matmul", tiling, ops.cim_matmul, (a, b),
                          {"tiling": tiling}))
    if "flash_attention" in kernels:
        q = f32(rng.standard_normal((1, 128, 64)))
        k = f32(rng.standard_normal((1, 128, 64)))
        v = f32(rng.standard_normal((1, 128, 64)))
        for bq, bk in ((128, 128), (64, 64)):
            cases.append(("flash_attention", f"bq{bq}xbk{bk}",
                          ops.flash_attention, (q, k, v),
                          {"causal": True, "bq": bq, "bk": bk}))
    if "selective_scan" in kernels:
        bs, t, i, s = 1, 64, 32, 8
        xi = f32(rng.standard_normal((bs, t, i)))
        dt = f32(np.abs(rng.standard_normal((bs, t, i))) * 0.1)
        bm = f32(rng.standard_normal((bs, t, s)))
        cm = f32(rng.standard_normal((bs, t, s)))
        aa = f32(-np.abs(rng.standard_normal((i, s))))
        h0 = torch.zeros((bs, i, s), dtype=torch.float32, device=device)
        for ct, ci in ((16, 16), (32, 32)):
            cases.append(("selective_scan", f"ct{ct}xci{ci}",
                          ops.selective_scan, (xi, dt, bm, cm, aa, h0),
                          {"ct": ct, "ci": ci}))
    if "strategy_eval" in kernels:
        from repro_torch.core.ir import bert_large_workload
        from repro_torch.core.macro import get_macro
        from repro_torch.core.pruning import (
            DesignSpace,
            candidates_with_bw,
            enumerate_space,
        )
        cands = candidates_with_bw(enumerate_space(DesignSpace(
            mr=(1, 2), mc=(1, 2), scr=(1, 4), is_kb=(4, 64),
            os_kb=(4, 64))), 256)
        wl = bert_large_workload().merged().as_arrays()
        cases.append(("strategy_eval", "default", ops.strategy_eval,
                      (f32(cands), f32(wl), get_macro("vanilla-dcim")), {}))
    return cases


def run_microbench(kernels: typing.Sequence[str] | None = None,
                   repeats: int = 3, seed: int = 0, device="cuda",
                   ) -> list[MeasurementRecord]:
    """Time the port's kernels over a small tiling sweep and return one
    :class:`MeasurementRecord` per (case, repeat).

    This is the measurement half of the two-fidelity calibration tier
    (``repro_torch.core.calibration.fit_corrections`` fits correction
    factors from these records) and the shared body of ``python -m
    repro_torch.service profile`` / ``calibrate``.  It runs on the card
    (``device="cuda"``, the default; raises without one) unless the caller
    asks for ``"cpu"``, where each wrapper runs its plain version.  Each
    case is warmed once (the first call builds its kernel) before the
    timed repeats, each timed to completion with
    ``torch.cuda.synchronize``; the ``cim_kernel_*`` registry families are
    populated as a side effect.  Enables ``CIM_TUNER_PROFILE`` for this
    process if unset."""
    if not profiling_enabled():
        os.environ[PROFILE_ENV] = "1"
    import torch

    from repro_torch.core.engine import resolve_device

    dev = resolve_device(device)
    kernels = tuple(kernels) if kernels else _ALL_KERNELS
    unknown = sorted(set(kernels) - set(_ALL_KERNELS))
    if unknown:
        raise ValueError(f"unknown kernels {unknown}; "
                         f"pick from {_ALL_KERNELS}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    records: list[MeasurementRecord] = []
    for kernel, tiling, fn, args, kwargs in _microbench_cases(kernels, rng,
                                                              dev):
        bucket = fn.__bucket_fn__(*args, **kwargs)
        fn(*args, **kwargs)                 # warm-up: builds, loads
        sync()
        flops, nbytes = work_counts(kernel, args, kwargs)
        for _ in range(max(1, repeats)):
            t1 = time.perf_counter()
            fn(*args, **kwargs)
            sync()
            records.append(MeasurementRecord(
                kernel=kernel, bucket=bucket, tiling=tiling,
                us=(time.perf_counter() - t1) * 1e6,
                flops=flops, bytes=nbytes, seed=seed))
    _M_RUNTIME.set(time.perf_counter() - t0)
    return records


# --------------------------------------------------------------------- #
# per-job measurement stash
# --------------------------------------------------------------------- #
#: measured-fidelity runs park their records here keyed by job key, for
#: the result store's ``.measurements.json`` sidecar
_MEASUREMENTS: dict[str, list[MeasurementRecord]] = {}
_MEAS_LOCK = threading.Lock()
_MEAS_CAP = 512


def record_measurements(key: str,
                        records: typing.Sequence[MeasurementRecord],
                        ) -> None:
    """Stash the measurement records backing one job's measured-fidelity
    re-score, keyed by the job's content address (bounded FIFO)."""
    with _MEAS_LOCK:
        if len(_MEASUREMENTS) >= _MEAS_CAP and key not in _MEASUREMENTS:
            _MEASUREMENTS.pop(next(iter(_MEASUREMENTS)))
        _MEASUREMENTS[key] = list(records)


def take_measurements(key: str) -> list[MeasurementRecord] | None:
    """Pop (and return) the stashed records for ``key``, or None."""
    with _MEAS_LOCK:
        return _MEASUREMENTS.pop(key, None)
