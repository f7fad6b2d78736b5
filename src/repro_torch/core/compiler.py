"""CIM-Tuner compiler: mapping strategy -> instruction flow (paper Sec. III-A,
IV-A).

Two products, both built by explicitly walking the strategy's loop nest (the
ground truth the closed-form cost model must reproduce):

* ``compile_schedule`` -- a per-*resident-set* record stream (compute /
  update / bus work per set).  Field sums match ``cost_model.matmul_cost``
  exactly, integer for integer (property-tested); the cycle-accurate
  simulator consumes it.

* ``compile_trace`` -- an address-level instruction list (LOAD_V / LOAD_S /
  COMPUTE / STORE_Y) for small operators, replayed by ``replay_trace`` on
  real numpy matrices with IS/CIM/OS capacity invariants asserted.  This is
  the analogue of the paper's silicon-verification "validation script" that
  checks the compiled instruction flow's memory-access trace performs the
  intended matrix multiplication.

Both are integer bookkeeping on the host in numpy, as in the reference:
nothing here runs on the card.  ``simulator.simulate_schedule`` takes the
records to the card.  ``replay_trace`` computes in float64 and raises
``AssertionError`` on a broken invariant, also under ``python -O``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.macro import MacroSpec
from repro_torch.core.strategies import Strategy
from repro_torch.core.template import AcceleratorConfig

MAX_SETS = 2_000_000


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _invariant(ok: bool, msg: str) -> None:
    """A replay invariant (capacity, residency, completeness)."""
    if not ok:
        raise AssertionError(msg)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Oriented loop-nest geometry shared by schedule and trace builders."""

    M: int
    K: int
    N: int
    dws: int   # streamed-data width (bits)
    dwt: int   # stationary-data width (bits)
    kp: int
    np_: int
    tk: int
    tn: int
    cyc_c: int
    cyc_u: int
    scr: int
    is_bits: int
    os_bits: int
    dw_psum: int
    dw_out: int
    # residency
    rows_res: int        # WP resident rows (full-width)
    fits_all_v: bool
    fits_all_s: bool
    os_rows_af: int

    def os_rows_pf(self, q: int) -> int:
        return self.os_bits // (q * self.np_ * self.dw_psum)


def make_geometry(
    macro: MacroSpec,
    cfg: AcceleratorConfig,
    m: int,
    k: int,
    n: int,
    strategy: Strategy,
) -> Geometry:
    rev = strategy.spatial == "R"
    M, N = (n, m) if rev else (m, n)
    K = k
    dws = macro.dw_w if rev else macro.dw_in
    dwt = macro.dw_in if rev else macro.dw_w
    kp = cfg.mr * macro.al
    np_ = cfg.mc * macro.pc
    tk = _cdiv(K, kp)
    tn = _cdiv(N, np_)
    cyc_c = max(1, _cdiv(dws * macro.al, macro.icw))
    cyc_u = max(1, _cdiv(macro.al * dwt, macro.wuw))
    rows_res = min(max(cfg.is_bits // (tk * kp * dws), 1), M)
    return Geometry(
        M=M, K=K, N=N, dws=dws, dwt=dwt, kp=kp, np_=np_, tk=tk, tn=tn,
        cyc_c=cyc_c, cyc_u=cyc_u, scr=cfg.scr,
        is_bits=cfg.is_bits, os_bits=cfg.os_bits,
        dw_psum=macro.dw_psum, dw_out=macro.dw_out,
        fits_all_v=M * tk * kp * dws <= cfg.is_bits,
        fits_all_s=tk * tn <= cfg.scr,
        os_rows_af=cfg.os_bits // (np_ * macro.dw_psum),
        rows_res=rows_res,
    )


def strategy_feasible(
    macro: MacroSpec, cfg: AcceleratorConfig, m: int, k: int, n: int,
    strategy: Strategy,
) -> bool:
    g = make_geometry(macro, cfg, m, k, n, strategy)
    if cfg.is_bits < g.kp * g.dws:
        return False
    if cfg.os_bits < g.np_ * g.dw_psum:
        return False
    if strategy.temporal == "WP" and cfg.is_bits < g.tk * g.kp * g.dws:
        return False  # one full row must fit for weight-priority updates
    return True


def schedule_sets(
    macro: MacroSpec, cfg: AcceleratorConfig, m: int, k: int, n: int,
    strategy: Strategy,
) -> int:
    """Resident sets ``compile_schedule`` would emit: row batches (WP)
    times plane groups, counted without building them."""
    g = make_geometry(macro, cfg, m, k, n, strategy)
    batches = _cdiv(g.M, g.rows_res) if strategy.temporal == "WP" else 1
    if strategy.tiling == "AF":
        return batches * g.tn * _cdiv(g.tk, g.scr)
    return batches * _cdiv(g.tn, g.scr) * g.tk


SCHEDULE_FIELDS = (
    "planes", "compute_cycles", "update_cycles",
    "v_bits", "s_bits", "spill_bits", "y_bits",
    "is_rd_bits", "is_wr_bits", "os_rd_bits", "os_wr_bits",
)


def compile_schedule(
    macro: MacroSpec,
    cfg: AcceleratorConfig,
    m: int,
    k: int,
    n: int,
    strategy: Strategy,
) -> dict[str, np.ndarray]:
    """Per-resident-set work records for (m x k) @ (k x n) under ``strategy``.

    Returns a dict of int64 arrays (one entry per set, loop-nest order).
    Raises ``ValueError`` for an infeasible strategy, and for a schedule
    of more than ``MAX_SETS`` sets (checked before any is built).
    """
    if not strategy_feasible(macro, cfg, m, k, n, strategy):
        raise ValueError(f"strategy {strategy} infeasible for op {(m, k, n)} "
                         f"on cfg {cfg.as_tuple()}")
    n_sets = schedule_sets(macro, cfg, m, k, n, strategy)
    if n_sets > MAX_SETS:
        raise ValueError(f"schedule too large ({n_sets} sets); use the "
                         "closed-form cost model for this operator")
    g = make_geometry(macro, cfg, m, k, n, strategy)
    af = strategy.tiling == "AF"
    wp = strategy.temporal == "WP"

    # batches (WP streams row batches; IP is a single conceptual batch of M)
    if wp:
        nb = _cdiv(g.M, g.rows_res)
        batches = [g.rows_res] * (nb - 1) + [g.M - (nb - 1) * g.rows_res]
    else:
        batches = [g.M]

    if af:
        ng = _cdiv(g.tk, g.scr)
        groups = [(j, gi, min(g.scr, g.tk - gi * g.scr))
                  for j in range(g.tn) for gi in range(ng)]
        n_inner = ng
    else:
        nh = _cdiv(g.tn, g.scr)
        groups = [(h, ki, min(g.scr, g.tn - h * g.scr))
                  for h in range(nh) for ki in range(g.tk)]
        n_inner = g.tk

    assert n_sets == len(batches) * len(groups)
    rec = {f: np.zeros(n_sets, dtype=np.int64) for f in SCHEDULE_FIELDS}
    si = 0
    v_fetched_once = False
    for bi, rows in enumerate(batches):
        for (outer, inner, p) in groups:
            r = rec
            r["planes"][si] = p
            r["compute_cycles"][si] = rows * p * g.cyc_c

            # ---- stationary-matrix loads (CIM updates) ----
            # WP re-sweeps all planes per batch unless they all fit in CIM
            load_planes = 0 if (wp and bi > 0 and g.fits_all_s) else p
            r["update_cycles"][si] = load_planes * g.cyc_u
            r["s_bits"][si] = load_planes * g.kp * g.np_ * g.dwt

            # ---- streamed-matrix fetches ----
            v_bits = 0
            if wp:
                if outer == 0 and inner == 0:
                    v_bits = rows * g.tk * g.kp * g.dws
            elif g.fits_all_v:
                if not v_fetched_once:
                    v_bits = g.M * g.tk * g.kp * g.dws
                    v_fetched_once = True
            else:
                span = p * g.kp if af else g.kp
                v_bits = rows * span * g.dws
            r["v_bits"][si] = v_bits
            r["is_wr_bits"][si] = v_bits

            # ---- IS reads (compute-driven; PF reuses the chunk p times) ----
            span_rd = p * g.kp if af else g.kp
            r["is_rd_bits"][si] = rows * span_rd * g.dws

            # ---- psums: OS traffic + spills ----
            width = g.np_ if af else p * g.np_
            os_rows = g.os_rows_af if af else g.os_rows_pf(p)
            spill_rows = max(0, rows - os_rows)
            spill = 0
            if inner > 0:
                spill += spill_rows * width * g.dw_psum      # read back
            if inner < n_inner - 1:
                spill += spill_rows * width * g.dw_psum      # write out
            r["spill_bits"][si] = spill

            os_wr = rows * width * g.dw_psum
            os_rd = rows * width * g.dw_psum if inner > 0 else 0
            if inner == n_inner - 1:                         # final read-out
                os_rd += rows * width * g.dw_psum
                r["y_bits"][si] = rows * width * g.dw_out
            r["os_wr_bits"][si] = os_wr
            r["os_rd_bits"][si] = os_rd
            si += 1
    assert si == n_sets
    return rec


def schedule_totals(rec: dict[str, np.ndarray]) -> dict[str, int]:
    out = {f: int(rec[f].sum()) for f in SCHEDULE_FIELDS}
    out["ema_bits"] = (
        out["v_bits"] + out["s_bits"] + out["spill_bits"] + out["y_bits"]
    )
    out["update_bits"] = out["s_bits"]
    out["n_sets"] = len(rec["planes"])
    return out


# ====================================================================== #
# Address-level trace + functional replay (the "validation script")
# ====================================================================== #
@dataclasses.dataclass(frozen=True)
class Instr:
    op: str              # LOAD_V | LOAD_S | EVICT_S | COMPUTE | STORE_Y
    rows: tuple[int, int] = (0, 0)   # [start, stop) streamed rows
    k_tile: int = -1
    n_tile: int = -1


def compile_trace(
    macro: MacroSpec,
    cfg: AcceleratorConfig,
    m: int,
    k: int,
    n: int,
    strategy: Strategy,
    max_instrs: int = 200_000,
) -> list[Instr]:
    """Address-level instruction flow for a small operator."""
    if not strategy_feasible(macro, cfg, m, k, n, strategy):
        raise ValueError(f"strategy {strategy} infeasible for op {(m, k, n)}")
    g = make_geometry(macro, cfg, m, k, n, strategy)
    af = strategy.tiling == "AF"
    wp = strategy.temporal == "WP"

    instrs: list[Instr] = []

    if wp:
        nb = _cdiv(g.M, g.rows_res)
        batches = [
            (bi * g.rows_res, min((bi + 1) * g.rows_res, g.M))
            for bi in range(nb)
        ]
    else:
        batches = [(0, g.M)]

    if af:
        ng = _cdiv(g.tk, g.scr)
        groups = [
            (j, gi,
             [(gi * g.scr + kk, j) for kk in range(min(g.scr, g.tk - gi * g.scr))])
            for j in range(g.tn) for gi in range(ng)
        ]
        n_inner = ng
    else:
        nh = _cdiv(g.tn, g.scr)
        groups = [
            (h, ki,
             [(ki, h * g.scr + nn) for nn in range(min(g.scr, g.tn - h * g.scr))])
            for h in range(nh) for ki in range(g.tk)
        ]
        n_inner = g.tk

    resident: list[tuple[int, int]] = []   # CIM plane tags (k_tile, n_tile)
    v_loaded_once = False
    for bi, (r0, r1) in enumerate(batches):
        for (outer, inner, planes) in groups:
            # stationary loads (skip if already resident)
            for (kt, nt) in planes:
                if (kt, nt) in resident:
                    continue
                while len(resident) >= cfg.scr:
                    old = resident.pop(0)
                    instrs.append(Instr("EVICT_S", k_tile=old[0], n_tile=old[1]))
                resident.append((kt, nt))
                instrs.append(Instr("LOAD_S", k_tile=kt, n_tile=nt))
            # streamed fetch
            if wp:
                if outer == 0 and inner == 0:
                    # new input batch: previous batch's rows leave the IS
                    instrs.append(Instr("EVICT_V"))
                    instrs.append(Instr("LOAD_V", rows=(r0, r1), k_tile=-1))
            elif g.fits_all_v:
                if not v_loaded_once:
                    instrs.append(Instr("LOAD_V", rows=(0, g.M), k_tile=-1))
                    v_loaded_once = True
            else:
                # streaming set: chunks of the previous set leave the IS FIFO
                instrs.append(Instr("EVICT_V"))
                for (kt, _nt) in planes if af else planes[:1]:
                    instrs.append(Instr("LOAD_V", rows=(r0, r1), k_tile=kt))
            # compute
            for (kt, nt) in planes:
                instrs.append(Instr("COMPUTE", rows=(r0, r1),
                                    k_tile=kt, n_tile=nt))
            # writeback at the last accumulation step
            if inner == n_inner - 1:
                for nt in sorted({nt for (_kt, nt) in planes}):
                    instrs.append(Instr("STORE_Y", rows=(r0, r1), n_tile=nt))
            if len(instrs) > max_instrs:
                raise ValueError("trace too large; shrink the operator")
    return instrs


def replay_trace(
    instrs: list[Instr],
    x: np.ndarray,
    w: np.ndarray,
    macro: MacroSpec,
    cfg: AcceleratorConfig,
    strategy: Strategy,
) -> np.ndarray:
    """Execute the instruction flow on real matrices, asserting IS/CIM/OS
    capacity invariants; returns Y (= x @ w) if the flow is correct."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x is {x.shape} but w is {w.shape}")
    g = make_geometry(macro, cfg, m, k, n, strategy)
    rev = strategy.spatial == "R"
    V = (w.T if rev else x).astype(np.float64)       # [M', K]
    S = (x.T if rev else w).astype(np.float64)       # [K, N']

    Vp = np.zeros((g.M, g.tk * g.kp))
    Vp[:, :g.K] = V
    Sp = np.zeros((g.tk * g.kp, g.tn * g.np_))
    Sp[: g.K, : g.N] = S
    Y = np.full((g.M, g.tn * g.np_), np.nan)
    psum: dict[tuple[int, int], np.ndarray] = {}     # (row, n_tile) -> vec

    cim: dict[tuple[int, int], np.ndarray] = {}
    is_buf: dict[tuple[int, int], bool] = {}          # (row, k_tile or -1)

    def is_bits_used() -> int:
        bits = 0
        for (_r, kt) in is_buf:
            bits += (g.tk * g.kp if kt == -1 else g.kp) * g.dws
        return bits

    for ins in instrs:
        if ins.op == "LOAD_S":
            _invariant(len(cim) < cfg.scr, "CIM plane capacity exceeded")
            kt, nt = ins.k_tile, ins.n_tile
            cim[(kt, nt)] = Sp[kt * g.kp:(kt + 1) * g.kp,
                               nt * g.np_:(nt + 1) * g.np_]
        elif ins.op == "EVICT_S":
            cim.pop((ins.k_tile, ins.n_tile))
        elif ins.op == "EVICT_V":
            is_buf.clear()
        elif ins.op == "LOAD_V":
            r0, r1 = ins.rows
            for r in range(r0, r1):
                is_buf[(r, ins.k_tile)] = True
            if ins.k_tile == -1:
                # resident (non-streaming) data must actually fit the IS
                _invariant(is_bits_used() <= cfg.is_bits,
                           "Input SRAM capacity exceeded")
        elif ins.op == "COMPUTE":
            kt, nt = ins.k_tile, ins.n_tile
            _invariant((kt, nt) in cim, "compute on a non-resident plane")
            r0, r1 = ins.rows
            for r in range(r0, r1):
                _invariant((r, kt) in is_buf or (r, -1) in is_buf,
                           f"row {r} k_tile {kt} not in Input SRAM")
                acc = psum.setdefault((r, nt), np.zeros(g.np_))
                acc += Vp[r, kt * g.kp:(kt + 1) * g.kp] @ cim[(kt, nt)]
        elif ins.op == "STORE_Y":
            r0, r1 = ins.rows
            nt = ins.n_tile
            for r in range(r0, r1):
                Y[r, nt * g.np_:(nt + 1) * g.np_] = psum.pop((r, nt))
        else:  # pragma: no cover
            raise ValueError(f"unknown instr {ins.op}")

    _invariant(not psum, "partial sums left unaccumulated")
    out = Y[:, : g.N]
    _invariant(not np.isnan(out).any(), "output rows never written")
    return out.T if rev else out
