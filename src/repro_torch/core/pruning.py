"""Hardware design-space enumeration and pruning (paper Sec. III-D).

Constraints applied:
  1. power-of-two SCR / IS_SIZE / OS_SIZE (address-decoding alignment);
  2. internal bandwidth (aggregate ICW, WUW) >= external bus BW;
  3. area(cfg) <= budget.

The pruned fraction is reported by benchmarks/fig9_runtime.py (paper: >35 %).
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.calibration import TechConstants, resolve_tech
from repro_torch.core.macro import MacroSpec

MR_CHOICES = (1, 2, 3, 4, 6, 8)
MC_CHOICES = (1, 2, 3, 4, 6, 8)
SCR_CHOICES = (1, 2, 4, 8, 16, 32, 64)
IS_KB_CHOICES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
OS_KB_CHOICES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    mr: tuple[int, ...] = MR_CHOICES
    mc: tuple[int, ...] = MC_CHOICES
    scr: tuple[int, ...] = SCR_CHOICES
    is_kb: tuple[int, ...] = IS_KB_CHOICES
    os_kb: tuple[int, ...] = OS_KB_CHOICES

    def axes(self) -> tuple[tuple[int, ...], ...]:
        return (self.mr, self.mc, self.scr, self.is_kb, self.os_kb)

    @property
    def size(self) -> int:
        return int(np.prod([len(a) for a in self.axes()]))

    def fix(self, **fixed: int) -> "DesignSpace":
        """Pin axes to single values (Table II: 'other parameters fixed')."""
        kw = {}
        for name in ("mr", "mc", "scr", "is_kb", "os_kb"):
            kw[name] = (fixed[name],) if name in fixed else getattr(self, name)
        return DesignSpace(**kw)


def enumerate_space(space: DesignSpace) -> np.ndarray:
    """All raw candidate tuples as an int array [C, 5]."""
    return np.array(
        list(itertools.product(*space.axes())), dtype=np.int64
    )


def prune_space(
    space: DesignSpace,
    macro: MacroSpec,
    area_budget_mm2: float,
    bw: int = 256,
    tech: TechConstants | None = None,
) -> tuple[np.ndarray, dict]:
    """Returns ([C_valid, 5] candidates, stats) after bandwidth+area pruning.

    Vectorized (the same closed-form area/bandwidth rules as template.py --
    pinned against the scalar path in tests/test_explorer.py)."""
    tech = resolve_tech(tech)
    raw = enumerate_space(space)
    mr, mc, scr, is_kb, os_kb = (raw[:, i].astype(np.float64)
                                 for i in range(5))
    bw_ok = (macro.icw * mr >= bw) & (macro.wuw * mr * mc >= bw)
    cells = macro.al * macro.pc * scr * macro.dw_w * tech.a_cell_um2_bit
    cus = macro.al * macro.pc * tech.a_cu_um2
    macro_area = (cells + cus) * 1e-6 + tech.a_macro_fixed_mm2
    sram = lambda kb: kb * 8.0 / 1024.0 * tech.a_sram_mm2_per_mb \
        + tech.a_sram_fixed_mm2
    area = mr * mc * macro_area + sram(is_kb) + sram(os_kb) + tech.a_fixed_mm2
    area_ok = area <= area_budget_mm2
    keep = bw_ok & area_ok
    stats = {
        "raw": len(raw),
        "kept": int(keep.sum()),
        "bandwidth_pruned": int((~bw_ok).sum()),
        "area_pruned": int((bw_ok & ~area_ok).sum()),
        "pruned_fraction": 1.0 - keep.sum() / max(1, len(raw)),
    }
    return raw[keep], stats


def candidates_with_bw(cands: np.ndarray, bw: int) -> np.ndarray:
    """Append the bus-bandwidth column -> cfg rows for the tensor cost model."""
    col = np.full((len(cands), 1), bw, dtype=np.int64)
    return np.concatenate([cands, col], axis=1).astype(np.float64)
