"""Silicon-calibrated technology constants for the CIM-Tuner PPA models.

The port's copy of the constants half of the reference's
``core/calibration.py``: :class:`TechConstants`, :data:`DEFAULT_TECH` and
:func:`resolve_tech`.  The constants are fitted so the two SOTA baselines of
Table II land at their published areas:

    TranCIM-Base  (MR,MC,SCR,IS,OS) = (3,1,1,64,128)  ->  3.52 mm^2
    TP-DCIM-Base  (MR,MC,SCR,IS,OS) = (2,4,1,16,16)   ->  2.23 mm^2

and, on Bert-large, at their published TOPS/W (2.54 / 1.89).  The measured
correction factors and their fit are not part of the port yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TechConstants:
    """28 nm-class energy/area/leakage constants (pJ, mm^2, mW)."""

    # --- per-instruction energies (pJ) -----------------------------------
    e_mac_pj: float = 0.08            # one INT8 MAC inside a DCIM macro
    e_sram_rd_pj_bit: float = 0.12    # IS/OS SRAM read, per bit
    e_sram_wr_pj_bit: float = 0.14    # IS/OS SRAM write, per bit
    e_cim_update_pj_bit: float = 0.20 # CIM weight-update write path, per bit
    e_ema_pj_bit: float = 1.2         # external memory interface, per bit
    # System-level overhead multiplier on dynamic energy (controller, clock
    # tree, NoC) -- folds the parts of PTPX power the template cannot see.
    sys_energy_overhead: float = 1.3

    # --- leakage ----------------------------------------------------------
    p_leak_mw_mm2: float = 15.0       # leakage power density

    # --- area (um^2 unless noted) ----------------------------------------
    a_cell_um2_bit: float = 0.36      # 6T bit-cell + CIM overhead, per bit
    a_cu_um2: float = 497.0           # one 8b MAC compute unit (fitted)
    a_sram_mm2_per_mb: float = 0.25   # compiled SRAM density
    a_sram_fixed_mm2: float = 0.02    # per-SRAM-instance periphery
    a_macro_fixed_mm2: float = 0.01   # per-macro periphery (drivers, ctrl)
    a_fixed_mm2: float = 0.0          # absorbed into per-macro/SRAM fixed (fit)

    # --- timing -----------------------------------------------------------
    freq_mhz: float = 500.0           # default operating frequency

    # --- data widths (bits) -----------------------------------------------
    dw_in: int = 8
    dw_w: int = 8
    dw_psum: int = 24
    dw_out: int = 8


DEFAULT_TECH = TechConstants()


def resolve_tech(tech: "TechConstants | None" = None) -> TechConstants:
    """The default-tech rule: an explicit ``tech`` wins, ``None`` means the
    analytic :data:`DEFAULT_TECH`."""
    return tech if tech is not None else DEFAULT_TECH
