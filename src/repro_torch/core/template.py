"""Generalized three-stage-pipeline SRAM-CIM accelerator template (Sec. III-B).

Stage 1 buffers input data in the Input SRAM (``IS_SIZE``), stage 2 stores
weights and computes in an ``MR x MC`` grid of CIM macros (outputs accumulate
along the row direction, inputs broadcast along the column direction), and
stage 3 accumulates/buffers partial sums in the Output SRAM (``OS_SIZE``).
The accelerator talks to external memory over a bus of ``BW`` bits/cycle.

SCR is an *accelerator-level* parameter here: the number of resident
``AL x PC`` weight planes per macro chosen by the co-exploration.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.calibration import TechConstants, resolve_tech
from repro_torch.core.macro import MacroSpec


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """The explored hardware point: (MR, MC, SCR, IS_SIZE, OS_SIZE [, BW])."""

    mr: int           # macro rows   (accumulation / K direction)
    mc: int           # macro cols   (parallel / N direction)
    scr: int          # resident weight planes per macro
    is_kb: int        # input SRAM size  [KB]
    os_kb: int        # output SRAM size [KB]
    bw: int = 256     # external bus bandwidth [bits / cycle]

    def __post_init__(self) -> None:
        for f in ("mr", "mc", "scr", "is_kb", "os_kb", "bw"):
            if getattr(self, f) <= 0:
                raise ValueError(f"{f} must be positive, got {getattr(self, f)}")

    # physical tile the macro grid covers per plane
    def kp(self, macro: MacroSpec) -> int:
        return self.mr * macro.al

    def np_(self, macro: MacroSpec) -> int:
        return self.mc * macro.pc

    @property
    def is_bits(self) -> int:
        return self.is_kb * 1024 * 8

    @property
    def os_bits(self) -> int:
        return self.os_kb * 1024 * 8

    def as_tuple(self) -> tuple[int, int, int, int, int]:
        return (self.mr, self.mc, self.scr, self.is_kb, self.os_kb)


def sram_area_mm2(kb: int, tech: TechConstants | None = None) -> float:
    tech = resolve_tech(tech)
    mb = kb * 8 / 1024.0  # KB -> Mb
    return mb * tech.a_sram_mm2_per_mb + tech.a_sram_fixed_mm2


def accelerator_area_mm2(
    cfg: AcceleratorConfig,
    macro: MacroSpec,
    tech: TechConstants | None = None,
) -> float:
    """Area model: macros (cells scale with SCR) + IS + OS + fixed overhead."""
    tech = resolve_tech(tech)
    macros = cfg.mr * cfg.mc * macro.area_mm2(cfg.scr, tech)
    return (
        macros
        + sram_area_mm2(cfg.is_kb, tech)
        + sram_area_mm2(cfg.os_kb, tech)
        + tech.a_fixed_mm2
    )


def internal_input_bandwidth(cfg: AcceleratorConfig, macro: MacroSpec) -> int:
    """Aggregate input-feed bandwidth: MR macro rows consume distinct input
    vectors (columns share via broadcast)."""
    return macro.icw * cfg.mr


def internal_update_bandwidth(cfg: AcceleratorConfig, macro: MacroSpec) -> int:
    """Aggregate weight-update bandwidth across the grid."""
    return macro.wuw * cfg.mr * cfg.mc


def bandwidth_ok(cfg: AcceleratorConfig, macro: MacroSpec) -> bool:
    """Paper Sec. III-D: prune designs whose internal bandwidth (ICW or WUW
    aggregate) falls below the external bus bandwidth BW."""
    return (
        internal_input_bandwidth(cfg, macro) >= cfg.bw
        and internal_update_bandwidth(cfg, macro) >= cfg.bw
    )


def peak_tops(cfg: AcceleratorConfig, macro: MacroSpec,
              tech: TechConstants | None = None) -> float:
    """Peak INT8 throughput (TOPS, 1 MAC = 2 OPs) of the configured grid."""
    macs_per_s = macro.peak_macs_per_cycle(cfg.mr, cfg.mc) * macro.freq_mhz * 1e6
    return 2.0 * macs_per_s / 1e12
