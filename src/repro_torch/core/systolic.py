"""Digital systolic-array baseline (paper Fig. 1, scale-sim [1] analogue).

A deliberately simple weight-stationary / input-stationary analytical model
of an R x C MAC array with ifmap/filter/ofmap SRAM buffers and a DRAM bus,
used only to reproduce the paper's motivation figure: under a fixed area
budget, latency is U-shaped in the compute/storage split -- stalls shrink as
the buffer grows until the shrinking array dominates.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.calibration import TechConstants, resolve_tech


@dataclasses.dataclass(frozen=True)
class SystolicConfig:
    rows: int                 # PE rows (K direction)
    cols: int                 # PE cols (N direction)
    buf_kb: int               # the swept buffer (weight or input)
    other_buf_kb: int = 64
    bw_bits: int = 256        # DRAM bus bits / cycle
    dw: int = 8


def systolic_area_mm2(
    cfg: SystolicConfig, tech: TechConstants | None = None
) -> float:
    tech = resolve_tech(tech)
    pe = cfg.rows * cfg.cols * tech.a_cu_um2 * 1e-6
    sram = (cfg.buf_kb + cfg.other_buf_kb) * 8 / 1024.0 * tech.a_sram_mm2_per_mb
    return pe + sram + tech.a_fixed_mm2


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def systolic_latency(
    cfg: SystolicConfig,
    m: int,
    k: int,
    n: int,
    dataflow: str = "ws",     # "ws" weight-stationary | "is" input-stationary
) -> dict:
    """Cycles for (m x k) @ (k x n), scale-sim style tile walk.

    WS: filter tiles (rows x cols) stay in PEs; ifmap rows stream; the weight
    buffer's size sets how many filter tiles are DRAM-resident vs reused.
    IS: symmetric with m <-> n.
    """
    if dataflow == "is":
        m, n = n, m
    tk = _cdiv(k, cfg.rows)
    tn = _cdiv(n, cfg.cols)
    buf_bits = cfg.buf_kb * 1024 * 8

    # compute: each tile processes m rows after a pipeline fill of rows+cols
    compute = tk * tn * (m + cfg.rows + cfg.cols - 1)

    # stationary-operand traffic: every filter tile fetched once
    w_bits = tk * tn * cfg.rows * cfg.cols * cfg.dw
    # streamed-operand refetch factor: if the buffer can't hold the streamed
    # matrix, it is re-fetched for every stationary tile column
    x_bits_once = m * tk * cfg.rows * cfg.dw
    refetch = 1 if x_bits_once <= buf_bits else tn
    x_bits = x_bits_once * refetch
    y_bits = m * tn * cfg.cols * cfg.dw
    dram_cycles = math.ceil((w_bits + x_bits + y_bits) / cfg.bw_bits)

    stall = max(0, dram_cycles - compute)
    return {
        "compute_cycles": compute,
        "dram_cycles": dram_cycles,
        "stall_cycles": stall,
        "total_cycles": compute + stall,
        "refetch": refetch,
    }


def buffer_sweep(
    *,
    area_budget_mm2: float,
    m: int,
    k: int,
    n: int,
    buf_choices_kb=(8, 16, 32, 64, 128, 256, 512, 1024),
    dataflow: str = "ws",
    tech: TechConstants | None = None,
) -> list[dict]:
    """Fig. 1: fixed area budget, sweep buffer size; the PE array takes the
    remaining area (square-ish aspect)."""
    tech = resolve_tech(tech)
    out = []
    for buf in buf_choices_kb:
        sram_mm2 = (buf + 64) * 8 / 1024.0 * tech.a_sram_mm2_per_mb
        pe_mm2 = area_budget_mm2 - sram_mm2 - tech.a_fixed_mm2
        if pe_mm2 <= 0:
            continue
        pes = int(pe_mm2 / (tech.a_cu_um2 * 1e-6))
        side = max(1, int(math.sqrt(pes)))
        cfg = SystolicConfig(rows=side, cols=max(1, pes // side), buf_kb=buf)
        r = systolic_latency(cfg, m, k, n, dataflow)
        r.update(buf_kb=buf, rows=cfg.rows, cols=cfg.cols,
                 area_mm2=systolic_area_mm2(cfg, tech))
        out.append(r)
    return out
