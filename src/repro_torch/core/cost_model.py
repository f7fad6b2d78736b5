"""Closed-form latency/energy cost model for the generalized accelerator
template, covering all 8 mapping strategies (paper Sec. III-B/III-C), in
PyTorch tensor code.

Every function here works on broadcastable tensors: where the reference
``vmap``-s a scalar formula over candidates x operators x strategies, the
port writes those axes out as tensor dimensions.  The formulas keep the
reference's operation order term for term, so float32 results round alike
and float64 results are integer-exact where the reference's are.  This
module is the plain version of the ``strategy_eval`` CUDA kernel
(``repro_torch/kernels``): the kernel repeats this arithmetic per thread.

Macro and technology constants come in two flavours, as in the reference:

* static -- a :class:`~repro_torch.core.macro.MacroSpec` /
  ``TechConstants`` pair (python scalars, cast to the working dtype);
* per-job -- :class:`MacroParams` / :class:`TechParams` NamedTuples whose
  leaves are tensors with a job axis (the batched engine's per-job macros).

Loop-nest semantics (NR orientation; R swaps M<->N and streamed/stationary
data widths).  ``V`` = streamed matrix (M x K, via Input SRAM), ``S`` =
stationary matrix (K x N, resident in CIM planes), output M x N via Output
SRAM.  The macro grid covers a physical tile of ``Kp x Np`` per plane
(Kp = MR*AL, Np = MC*PC); S is tiled into tK x tN planes; SCR planes are
co-resident.

    IP-AF:  for n_tile(tN): for k_group(G=ceil(tK/SCR)): for m: for plane
    IP-PF:  for n_group(H=ceil(tN/SCR)): for k_tile(tK): for m: for plane
    WP-AF:  for m_batch(B): for n_tile: for k_group: for m: for plane
    WP-PF:  for m_batch(B): for n_group: for k_tile: for m: for plane

All arithmetic is float: float64 for exact integer semantics (counts
< 2^53), float32 otherwise.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from repro_torch.core.calibration import TechConstants, resolve_tech
from repro_torch.core.macro import MacroSpec
from repro_torch.core.strategies import ALL_STRATEGIES, STRATEGY_SETS

INFEASIBLE = 1e30

#: objective encodings shared by the string API and the batched API
OBJ_CODES: dict[str, int] = {"ee": 0, "th": 1, "edp": 2}

#: (reversed, weight_priority, parallel_first) bits of ALL_STRATEGIES
STRAT_BITS = np.array(
    [[float(s.spatial == "R"), float(s.temporal == "WP"),
      float(s.tiling == "PF")] for s in ALL_STRATEGIES])   # [8, 3]


class MacroParams(typing.NamedTuple):
    """Tensor-friendly view of a :class:`MacroSpec` (+ its energy override).

    Leaves are python floats in the static path and tensors (possibly with
    a job axis) in the batched path -- the cost formulas accept either.
    """

    al: typing.Any
    pc: typing.Any
    icw: typing.Any
    wuw: typing.Any
    dw_in: typing.Any
    dw_w: typing.Any
    dw_psum: typing.Any
    dw_out: typing.Any
    freq_mhz: typing.Any
    update_during_compute: typing.Any   # 0.0 / 1.0 ping-pong capability
    mac_e_pj: typing.Any                # per-MAC energy (macro override baked)


class TechParams(typing.NamedTuple):
    """Tensor-friendly view of :class:`TechConstants` (energy/area/leakage)."""

    e_cim_update_pj_bit: typing.Any
    e_sram_rd_pj_bit: typing.Any
    e_sram_wr_pj_bit: typing.Any
    e_ema_pj_bit: typing.Any
    sys_energy_overhead: typing.Any
    p_leak_mw_mm2: typing.Any
    a_cell_um2_bit: typing.Any
    a_cu_um2: typing.Any
    a_macro_fixed_mm2: typing.Any
    a_sram_mm2_per_mb: typing.Any
    a_sram_fixed_mm2: typing.Any
    a_fixed_mm2: typing.Any


def macro_params(macro: MacroSpec,
                 tech: TechConstants | None = None) -> MacroParams:
    """Scalar (python-float) params of a macro -- the static path."""
    tech = resolve_tech(tech)
    return MacroParams(
        al=float(macro.al), pc=float(macro.pc),
        icw=float(macro.icw), wuw=float(macro.wuw),
        dw_in=float(macro.dw_in), dw_w=float(macro.dw_w),
        dw_psum=float(macro.dw_psum), dw_out=float(macro.dw_out),
        freq_mhz=float(macro.freq_mhz),
        update_during_compute=float(macro.update_during_compute),
        mac_e_pj=float(macro.mac_energy_pj(tech)),
    )


def tech_params(tech: TechConstants | None = None) -> TechParams:
    """Scalar (python-float) params of a technology -- the static path."""
    tech = resolve_tech(tech)
    return TechParams(*[float(getattr(tech, f)) for f in TechParams._fields])


def _t(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _as_params(macro, tech, dtype, device):
    """Normalize (MacroSpec|MacroParams, TechConstants|TechParams|None) to
    tensor leaves of ``dtype`` on ``device``."""
    mp = macro if isinstance(macro, MacroParams) else macro_params(
        macro, tech if isinstance(tech, TechConstants) else None)
    tp = tech if isinstance(tech, TechParams) else tech_params(
        tech if isinstance(tech, TechConstants) else None)
    return (MacroParams(*[_t(v, dtype, device) for v in mp]),
            TechParams(*[_t(v, dtype, device) for v in tp]))


def _dtype_device(*xs, dtype=None, device=None):
    """Working dtype/device: explicit values win, then the first tensor
    argument's, then float32 on the CPU."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            if dtype is None and x.is_floating_point():
                dtype = x.dtype
            if device is None:
                device = x.device
    return dtype or torch.float32, device or torch.device("cpu")


def objective_code(objective) -> typing.Any:
    """Map "ee"/"th"/"edp" to its integer code; pass tensor codes through."""
    if isinstance(objective, str):
        try:
            return OBJ_CODES[objective]
        except KeyError:
            raise ValueError(
                f"unknown objective {objective!r}; "
                f"expected one of {sorted(OBJ_CODES)}") from None
    return objective


def _score(lat, en, code):
    """Per-objective score (lower is better); ``code`` may be a tensor."""
    code = torch.as_tensor(code, device=lat.device)
    return torch.where(code == OBJ_CODES["th"], lat,
                       torch.where(code == OBJ_CODES["edp"], lat * en, en))


def _ceil(a, b):
    return torch.ceil(a / b)


def _fdiv(a, b):
    return torch.floor(a / b)


class CostBreakdown(typing.NamedTuple):
    """Per-operator-call cost terms (cycles, bits, pJ)."""

    latency_cycles: torch.Tensor
    compute_cycles: torch.Tensor
    update_cycles: torch.Tensor
    ema_cycles: torch.Tensor
    ema_bits: torch.Tensor          # total external traffic
    v_ema_bits: torch.Tensor        # streamed-matrix fetch
    s_ema_bits: torch.Tensor        # stationary-matrix (CIM update) fetch
    spill_ema_bits: torch.Tensor    # psum spills
    y_ema_bits: torch.Tensor        # output writeback
    is_rd_bits: torch.Tensor
    is_wr_bits: torch.Tensor
    os_rd_bits: torch.Tensor
    os_wr_bits: torch.Tensor
    update_bits: torch.Tensor       # CIM write traffic (== s_ema_bits)
    macs: torch.Tensor              # padded MACs actually executed
    energy_pj: torch.Tensor
    feasible: torch.Tensor


def matmul_cost(
    m, k, n,
    rev, wp, pf,
    mr, mc, scr, is_kb, os_kb, bw, area_mm2,
    macro,
    tech=None,
    *,
    dtype: torch.dtype | None = None,
    device=None,
) -> CostBreakdown:
    """Cost of (m x k) @ (k x n) calls under strategies on configs.

    Every operand broadcasts: operator dims, strategy bits (0/1 floats:
    reversed, weight_priority, parallel_first), the config and its area.
    ``macro``/``tech`` are a ``MacroSpec``/``TechConstants`` pair or
    ``MacroParams``/``TechParams`` whose leaves broadcast the same way.
    """
    dtype, device = _dtype_device(m, mr, area_mm2, dtype=dtype, device=device)
    mp, tp = _as_params(macro, tech, dtype, device)
    m, k, n = (_t(x, dtype, device) for x in (m, k, n))
    rev, wp, pf = (_t(x, dtype, device) for x in (rev, wp, pf))
    mr, mc, scr = (_t(x, dtype, device) for x in (mr, mc, scr))
    is_bits = _t(is_kb, dtype, device) * 1024.0 * 8.0
    os_bits = _t(os_kb, dtype, device) * 1024.0 * 8.0
    bw = _t(bw, dtype, device)
    area_mm2 = _t(area_mm2, dtype, device)

    # ---- spatial scheduling: orientation + data widths -------------------
    M = torch.where(rev > 0, n, m)
    N = torch.where(rev > 0, m, n)
    K = k
    dws = torch.where(rev > 0, mp.dw_w, mp.dw_in)   # streamed operand width
    dwt = torch.where(rev > 0, mp.dw_in, mp.dw_w)   # stationary operand width
    dw_psum = mp.dw_psum
    dw_out = mp.dw_out

    # per-plane-op / per-plane-update cycles (eqns 3-5)
    cyc_c = torch.clamp_min(_ceil(dws * mp.al, mp.icw), 1.0)
    cyc_u = torch.clamp_min(_ceil(mp.al * dwt, mp.wuw), 1.0)

    # ---- geometry ---------------------------------------------------------
    Kp = mr * mp.al
    Np = mc * mp.pc
    tK = _ceil(K, Kp)
    tN = _ceil(N, Np)
    Kpad = tK * Kp
    Npad = tN * Np
    planes = tK * tN

    G = _ceil(tK, scr)                      # AF groups per output column
    H = _ceil(tN, scr)                      # PF groups per K tile
    remN = tN - (H - 1.0) * scr             # planes in last PF group
    scr_n = torch.minimum(scr, tN)

    # ---- Input SRAM residency --------------------------------------------
    rows_res_raw = _fdiv(is_bits, Kpad * dws)
    wp_feasible = rows_res_raw >= 1.0
    rows_res = torch.minimum(torch.clamp_min(rows_res_raw, 1.0), M)
    B = _ceil(M, rows_res)                  # WP input batches
    remB = M - (B - 1.0) * rows_res         # rows in last batch
    is_feasible = is_bits >= Kp * dws
    fits_all_v = M * Kpad * dws <= is_bits  # whole streamed matrix cached

    # ---- streamed-matrix (V) external traffic ----------------------------
    v_refetch_ip = torch.where(fits_all_v, 1.0, torch.where(pf > 0, H, tN))
    v_bits = M * Kpad * dws * torch.where(wp > 0, 1.0, v_refetch_ip)

    # ---- stationary-matrix (S) external traffic + CIM updates ------------
    fits_all_s = planes <= scr
    s_loads = planes * torch.where((wp > 0) & ~fits_all_s, B, 1.0)
    s_bits = s_loads * Kp * Np * dwt
    update_cycles = s_loads * cyc_u

    # ---- compute ----------------------------------------------------------
    compute_cycles = M * planes * cyc_c      # strategy-invariant
    macs = M * Kpad * Npad                   # padded MACs executed

    # ---- Input SRAM access ------------------------------------------------
    is_wr = v_bits
    is_rd = M * Kpad * dws * torch.where(pf > 0, H, tN)

    # ---- Output SRAM access + psum spills --------------------------------
    os_rows_af = _fdiv(os_bits, Np * dw_psum)

    def _os_rows_pf(q):
        return _fdiv(os_bits, q * Np * dw_psum)

    def _spill(workrows, osrows):
        return torch.clamp_min(workrows - osrows, 0.0)

    spill_af_ip = 2.0 * (G - 1.0) * _spill(M, os_rows_af) * Np * dw_psum * tN
    spill_af_wp = (
        2.0 * (G - 1.0) * Np * dw_psum * tN
        * ((B - 1.0) * _spill(rows_res, os_rows_af) + _spill(remB, os_rows_af))
    )
    spill_af = torch.where(wp > 0, spill_af_wp, spill_af_ip)

    nfull = H - 1.0

    def _pf_spill_rows(workrows):
        return (
            nfull * _spill(workrows, _os_rows_pf(scr_n)) * scr_n
            + _spill(workrows, _os_rows_pf(remN)) * remN
        )
    spill_pf_ip = 2.0 * (tK - 1.0) * Np * dw_psum * _pf_spill_rows(M)
    spill_pf_wp = 2.0 * (tK - 1.0) * Np * dw_psum * (
        (B - 1.0) * _pf_spill_rows(rows_res) + _pf_spill_rows(remB)
    )
    spill_pf = torch.where(wp > 0, spill_pf_wp, spill_pf_ip)
    spill_bits = torch.where(pf > 0, spill_pf, spill_af)

    groups_per_col = torch.where(pf > 0, tK, G)
    os_wr = M * tN * groups_per_col * Np * dw_psum
    os_rd = M * tN * (groups_per_col - 1.0) * Np * dw_psum + M * Npad * dw_psum
    os_feasible = os_bits >= Np * dw_psum

    # ---- output writeback --------------------------------------------------
    y_bits = M * Npad * dw_out

    # ---- totals ------------------------------------------------------------
    ema_bits = v_bits + s_bits + spill_bits + y_bits
    ema_cycles = _ceil(ema_bits, bw)

    overlap = (mp.update_during_compute * (scr >= 2.0)) != 0
    busy = torch.maximum(compute_cycles, ema_cycles)
    latency = torch.where(
        overlap,
        torch.maximum(busy, update_cycles),
        busy + update_cycles,
    )

    feasible = is_feasible & os_feasible & ((wp == 0) | wp_feasible)

    # ---- energy ------------------------------------------------------------
    e_dyn = (
        macs * mp.mac_e_pj
        + s_bits * tp.e_cim_update_pj_bit
        + (is_rd + os_rd) * tp.e_sram_rd_pj_bit
        + (is_wr + os_wr) * tp.e_sram_wr_pj_bit
        + ema_bits * tp.e_ema_pj_bit
    ) * tp.sys_energy_overhead
    lat_s = latency / (mp.freq_mhz * 1e6)
    e_leak = tp.p_leak_mw_mm2 * area_mm2 * lat_s * 1e9  # mW*s -> pJ
    energy = e_dyn + e_leak

    latency = torch.where(feasible, latency, INFEASIBLE)
    energy = torch.where(feasible, energy, INFEASIBLE)

    return CostBreakdown(
        latency_cycles=latency,
        compute_cycles=compute_cycles,
        update_cycles=update_cycles,
        ema_cycles=ema_cycles,
        ema_bits=ema_bits,
        v_ema_bits=v_bits,
        s_ema_bits=s_bits,
        spill_ema_bits=spill_bits,
        y_ema_bits=y_bits,
        is_rd_bits=is_rd,
        is_wr_bits=is_wr,
        os_rd_bits=os_rd,
        os_wr_bits=os_wr,
        update_bits=s_bits,
        macs=macs,
        energy_pj=energy,
        feasible=feasible,
    )


# ---------------------------------------------------------------------- #
# vectorized stacks
# ---------------------------------------------------------------------- #
def _lift(x, n: int):
    """Append ``n`` broadcast axes to a tensor leaf (python floats pass)."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x.reshape(*x.shape, *([1] * n))
    return x


def strategy_table(op_row, cfg_row, area_mm2, macro, tech=None):
    """Costs of ops under all 8 strategies: op_row [..., 5] =
    (m,k,n,count,static), cfg_row [..., 6] = (mr,mc,scr,is_kb,os_kb,bw),
    area [...] -> every field [..., 8]."""
    dtype, device = _dtype_device(cfg_row, op_row)
    op_row, cfg_row = _t(op_row, dtype, device), _t(cfg_row, dtype, device)
    bits = _t(STRAT_BITS, dtype, device)
    o = [op_row[..., i, None] for i in range(3)]
    c = [cfg_row[..., i, None] for i in range(6)]
    return matmul_cost(*o, bits[:, 0], bits[:, 1], bits[:, 2], *c,
                       _lift(_t(area_mm2, dtype, device), 1), macro, tech)


def area_mm2_t(cfg_row, macro, tech=None):
    """Tensor version of template.accelerator_area_mm2: cfg_row [..., >=5]
    -> [...]; per-job ``MacroParams``/``TechParams`` leaves broadcast."""
    dtype, device = _dtype_device(cfg_row)
    mp, tp = _as_params(macro, tech, dtype, device)
    cfg_row = _t(cfg_row, dtype, device)
    mr, mc, scr, is_kb, os_kb = (cfg_row[..., i] for i in range(5))
    cells = mp.al * mp.pc * scr * mp.dw_w * tp.a_cell_um2_bit
    cus = mp.al * mp.pc * tp.a_cu_um2
    macro_area = (cells + cus) * 1e-6 + tp.a_macro_fixed_mm2
    sram = lambda kb: kb * 8.0 / 1024.0 * tp.a_sram_mm2_per_mb \
        + tp.a_sram_fixed_mm2
    return mr * mc * macro_area + sram(is_kb) + sram(os_kb) + tp.a_fixed_mm2


#: the reference's name for the same function
area_mm2_jnp = area_mm2_t


def bandwidth_ok_t(cfg_row, macro):
    """Internal bandwidth (aggregate ICW and WUW) >= the bus width, per row."""
    dtype, device = _dtype_device(cfg_row)
    mp, _ = _as_params(macro, None, dtype, device)
    cfg_row = _t(cfg_row, dtype, device)
    bw = cfg_row[..., 5]
    return (mp.icw * cfg_row[..., 0] >= bw) & (
        mp.wuw * cfg_row[..., 0] * cfg_row[..., 1] >= bw
    )


#: the reference's name for the same function
bandwidth_ok_jnp = bandwidth_ok_t


def _ordered_sum(x):
    """Sum over the last axis from index 0 upward, as the kernel does."""
    total = x[..., 0]
    for p in range(1, x.shape[-1]):
        total = total + x[..., p]
    return total


def workload_cost_core(
    ops_arr, cfg_row, strat_bits, allowed, macro,
    tech=None, objective="ee",
):
    """Best-strategy-per-operator totals with the strategy tables passed in.

    ``ops_arr`` [..., P, 5], ``cfg_row`` [..., 6], ``allowed`` [..., 8] and
    every per-job leaf of ``macro``/``tech``/``objective`` broadcast over
    the batch axes ``...``.  Returns (total latency [...], total energy
    [...], per-operator strategy index [..., P]); the argmin keeps the
    first index on ties, as ``jnp.argmin`` does.
    """
    dtype, device = _dtype_device(cfg_row, ops_arr)
    ops_arr, cfg_row = _t(ops_arr, dtype, device), _t(cfg_row, dtype, device)
    mp, tp = _as_params(macro, tech, dtype, device)
    code = objective_code(objective)
    area = area_mm2_t(cfg_row, mp, tp)

    bits = _t(strat_bits, dtype, device)
    o = [ops_arr[..., i, None] for i in range(3)]                # [..., P, 1]
    c = [cfg_row[..., i, None, None] for i in range(6)]          # [..., 1, 1]
    mp2 = MacroParams(*[_lift(v, 2) for v in mp])
    tp2 = TechParams(*[_lift(v, 2) for v in tp])
    tbl = matmul_cost(*o, bits[:, 0], bits[:, 1], bits[:, 2], *c,
                      area[..., None, None], mp2, tp2)           # [..., P, 8]
    ok = _t(allowed, dtype, device)[..., None, :] > 0
    lat = torch.where(ok, tbl.latency_cycles, INFEASIBLE)
    en = torch.where(ok, tbl.energy_pj, INFEASIBLE)
    idx = torch.argmin(_score(lat, en, _lift(_t(code, None, device), 2)),
                       dim=-1)
    lat = torch.gather(lat, -1, idx[..., None])[..., 0]
    en = torch.gather(en, -1, idx[..., None])[..., 0]
    counts = ops_arr[..., 3]
    return _ordered_sum(lat * counts), _ordered_sum(en * counts), idx


def strategy_mask(strategy_set: str) -> np.ndarray:
    """[8] 0/1 mask of the strategies a strategy set allows."""
    return np.array([1.0 if s in STRATEGY_SETS[strategy_set] else 0.0
                     for s in ALL_STRATEGIES])


def workload_cost(
    ops_arr,                # [..., P, 5] (m, k, n, count, static); count 0 = pad
    cfg_row,                # [..., 6]
    macro,
    tech=None,
    objective="ee",         # "ee" (energy) | "th" (latency) | "edp"
    strategy_set: str = "st",
):
    """Best-strategy-per-operator workload cost on accelerator configs.

    Returns (total_latency_cycles, total_energy_pj, per_op_strategy_idx).
    """
    return workload_cost_core(
        ops_arr, cfg_row, STRAT_BITS, strategy_mask(strategy_set),
        macro, tech, objective)


def objective_value(total_lat, total_en, objective):
    """Objective from workload totals; str or integer-code input."""
    return _score(total_lat, total_en, objective_code(objective))


# ---------------------------------------------------------------------- #
# per-job bundles for the batched exploration engine
# ---------------------------------------------------------------------- #
class JobParams(typing.NamedTuple):
    """Everything the objective needs about a batch of jobs.

    In the engine every leaf carries a leading job axis ``J``: ``ops``
    [J, P, 5] (operator arrays padded to a shared bucket width), the
    ``macro``/``tech`` leaves [J], ``allowed`` [J, 8] and the three scalars
    [J].  :func:`job_params_np` builds one job's leaves as numpy arrays,
    :func:`stack_job_params` stacks them into tensors.
    """

    ops: typing.Any          # [J, P, 5] (m, k, n, count, static)
    macro: MacroParams       # [J] leaves
    tech: TechParams         # [J] leaves
    allowed: typing.Any      # [J, 8] strategy mask
    obj_code: typing.Any     # [J] objective code
    area_budget: typing.Any  # [J] mm^2
    bw: typing.Any           # [J] external bus bits/cycle


def job_params_np(ops_arr: np.ndarray, macro: MacroSpec,
                  tech: TechConstants | None, objective: str,
                  strategy_set: str, area_budget_mm2: float,
                  bw: float) -> JobParams:
    """Numpy-leaved (float64) JobParams of one job, no job axis."""
    tech = resolve_tech(tech)
    return JobParams(
        ops=np.asarray(ops_arr, dtype=np.float64),
        macro=MacroParams(*[np.float64(v)
                            for v in macro_params(macro, tech)]),
        tech=TechParams(*[np.float64(v) for v in tech_params(tech)]),
        allowed=strategy_mask(strategy_set),
        obj_code=np.float64(objective_code(objective)),
        area_budget=np.float64(area_budget_mm2),
        bw=np.float64(bw),
    )


def stack_job_params(rows: typing.Sequence[JobParams], dtype: torch.dtype,
                     device) -> JobParams:
    """Stack per-job numpy JobParams along a new leading job axis."""
    def stack(*xs):
        return torch.as_tensor(np.stack([np.asarray(x) for x in xs]),
                               dtype=dtype, device=device)
    return JobParams(
        ops=stack(*[r.ops for r in rows]),
        macro=MacroParams(*[stack(*xs) for xs in zip(*[r.macro for r in rows])]),
        tech=TechParams(*[stack(*xs) for xs in zip(*[r.tech for r in rows])]),
        allowed=stack(*[r.allowed for r in rows]),
        obj_code=stack(*[r.obj_code for r in rows]),
        area_budget=stack(*[r.area_budget for r in rows]),
        bw=stack(*[r.bw for r in rows]),
    )


def job_terms(job: JobParams, cand, penalty_scale: float = 1e3):
    """Batched objective and its parts over a ``[J, C]`` candidate grid.

    ``cand`` [J, C, 6]; ``job`` leaves carry the leading job axis.  Returns
    (objective [J, C], total latency [J, C], total energy [J, C], per-op
    strategy index [J, C, P]).  The objective has the area penalty (always
    on; jobs carry budgets) and INFEASIBLE where the bandwidth rule fails.
    """
    per_job = lambda x: x[:, None]                    # [J, ...] -> [J, 1, ...]
    macro = MacroParams(*[per_job(v) for v in job.macro])
    tech = TechParams(*[per_job(v) for v in job.tech])
    code = per_job(job.obj_code)
    lat, en, idx = workload_cost_core(
        per_job(job.ops), cand, STRAT_BITS, per_job(job.allowed), macro,
        tech, code)
    val = _score(lat, en, code)
    area = area_mm2_t(cand, macro, tech)
    budget = per_job(job.area_budget)
    excess = torch.clamp_min(area - budget, 0.0) / budget
    val = val * (1.0 + penalty_scale * excess)
    val = torch.where(bandwidth_ok_t(cand, macro), val, INFEASIBLE)
    return val, lat, en, idx


def job_objective(job: JobParams, cand, penalty_scale: float = 1e3):
    """Objective [J, C] of ``cand`` [J, C, 6] -- the batched twin of
    :func:`make_objective_fn` (area penalty always on)."""
    return job_terms(job, cand, penalty_scale)[0]


def make_objective_fn(
    ops_arr,
    macro,
    tech=None,
    objective="ee",
    strategy_set: str = "st",
    area_budget_mm2: float | None = None,
    penalty_scale: float = 1e3,
):
    """objective(cfg_row [..., 6]) -> [...] for one fixed job.

    Area-budget violation enters as a smooth multiplicative penalty so SA can
    walk the boundary; bandwidth-infeasible configs get the hard INFEASIBLE.
    """
    code = objective_code(objective)
    mask = strategy_mask(strategy_set)

    def fn(cfg_row):
        dtype, device = _dtype_device(cfg_row)
        mp, tp = _as_params(macro, tech, dtype, device)
        lat, en, _ = workload_cost_core(
            ops_arr, cfg_row, STRAT_BITS, mask, mp, tp, code)
        val = _score(lat, en, code)
        if area_budget_mm2 is not None:
            area = area_mm2_t(cfg_row, mp, tp)
            excess = torch.clamp_min(area - area_budget_mm2, 0.0) \
                / area_budget_mm2
            val = val * (1.0 + penalty_scale * excess)
        return torch.where(bandwidth_ok_t(cfg_row, mp), val, INFEASIBLE)

    return fn


def metrics_from_totals(ops_arr, cfg_row, lat, en, idx, macro: MacroSpec,
                        tech=None) -> dict:
    """Human-facing PPA metrics (TOPS/W, GOPS, mm^2, ...) of one config
    from its workload totals; ``ops_arr`` [P, 5] and ``idx`` [P] cover the
    real operators only."""
    ops_arr = torch.as_tensor(ops_arr, dtype=lat.dtype, device=lat.device)
    true_ops = 2.0 * torch.sum(
        ops_arr[:, 0] * ops_arr[:, 1] * ops_arr[:, 2] * ops_arr[:, 3])
    lat_s = lat / (macro.freq_mhz * 1e6)
    energy_j = en * 1e-12
    return {
        "latency_cycles": float(lat),
        "latency_s": float(lat_s),
        "energy_pj": float(en),
        "tops_w": float(true_ops / energy_j / 1e12),
        "gops": float(true_ops / lat_s / 1e9),
        "area_mm2": float(area_mm2_t(
            torch.as_tensor(cfg_row, dtype=lat.dtype, device=lat.device),
            macro, tech)),
        "strategy_idx": [int(i) for i in idx],
    }


def workload_metrics(
    workload_ops_arr,
    cfg_row,
    macro,
    tech=None,
    objective="ee",
    strategy_set: str = "st",
) -> dict:
    """Human-facing PPA metrics for a config (TOPS/W, GOPS, mm^2, ...)."""
    lat, en, idx = workload_cost(
        workload_ops_arr, cfg_row, macro, tech, objective, strategy_set)
    return metrics_from_totals(workload_ops_arr, cfg_row, lat, en, idx,
                               macro, tech)
