"""Matrix abstraction of SRAM-CIM macros (paper Sec. III-B, eqns (1)-(5)).

Every SRAM-CIM variant performs the same atomic operation: a vector-matrix
projection between an input vector of accumulation length ``AL`` and a weight
matrix of ``AL x PC`` (parallel channels) stored in the CIM, producing a
partial-sum vector of length ``PC``.  The storage-compute ratio ``SCR``
selects one of SCR resident ``AL x PC`` weight planes per compute.

Two bandwidth parameters standardize latency across designs:

* ``ICW`` -- input-compute bandwidth, bits of input data processed per cycle.
  DCIM: ``ICW = AL * N_input_bitline`` (eq. 1).  ACIM: ``ICW = AL *
  DAC_precision`` (eq. 2).
* ``WUW`` -- weight-update bandwidth, bits of weight data written per cycle.

Latencies (eqns 3-5)::

    compute cycles / plane-op  = ceil(DW_in * AL / ICW)
    update  cycles / plane     = ceil(AL * DW_w / WUW)
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.calibration import TechConstants, resolve_tech


@dataclasses.dataclass(frozen=True)
class MacroSpec:
    """Abstracted SRAM-CIM macro: the (AL, PC, SCR, ICW, WUW) tuple.

    ``native_scr`` is the macro's as-published plane count; the *accelerator*
    level SCR (``AcceleratorConfig.scr``) overrides it during exploration
    (Table II explores SCR with the macro family fixed).
    """

    name: str
    al: int                    # accumulation length
    pc: int                    # parallel channels
    native_scr: int            # macro's native storage-compute ratio
    icw: int                   # input-compute bandwidth  [bits / cycle]
    wuw: int                   # weight-update bandwidth  [bits / cycle]
    kind: str = "dcim"         # "dcim" | "acim"
    freq_mhz: float = 500.0
    dw_in: int = 8             # input activation width   [bits]
    dw_w: int = 8              # weight width             [bits]
    dw_psum: int = 24          # partial-sum width        [bits]
    dw_out: int = 8            # quantized output width   [bits]
    # Ping-pong capability: with SCR >= 2 one plane can be updated while
    # another computes.  SCR == 1 designs always expose update latency.
    update_during_compute: bool = True
    # Optional per-macro energy overrides (pJ); ``None`` -> tech default.
    e_mac_pj: float | None = None

    def __post_init__(self) -> None:
        if self.al <= 0 or self.pc <= 0 or self.native_scr <= 0:
            raise ValueError(f"non-positive macro geometry in {self.name}")
        if self.icw <= 0 or self.wuw <= 0:
            raise ValueError(f"non-positive bandwidth in {self.name}")
        if self.kind not in ("dcim", "acim"):
            raise ValueError(f"unknown macro kind {self.kind!r}")

    # ------------------------------------------------------------------ #
    # eqns (3)/(4): one plane-op over an AL-long input vector
    # ------------------------------------------------------------------ #
    def compute_cycles(self) -> int:
        return max(1, math.ceil(self.dw_in * self.al / self.icw))

    # eq. (5): one AL x PC plane update
    def update_cycles(self) -> int:
        return max(1, math.ceil(self.al * self.dw_w / self.wuw))

    # ------------------------------------------------------------------ #
    # derived geometry / PPA
    # ------------------------------------------------------------------ #
    def cells_bits(self, scr: int) -> int:
        """Total storage bits with ``scr`` resident planes."""
        return self.al * self.pc * scr * self.dw_w

    def area_mm2(self, scr: int, tech: TechConstants | None = None) -> float:
        """Macro area: bit-cells (scale with SCR) + compute units (don't)."""
        tech = resolve_tech(tech)
        cells = self.cells_bits(scr) * tech.a_cell_um2_bit
        cus = self.al * self.pc * tech.a_cu_um2
        return (cells + cus) * 1e-6 + tech.a_macro_fixed_mm2

    def mac_energy_pj(self, tech: TechConstants | None = None) -> float:
        tech = resolve_tech(tech)
        return self.e_mac_pj if self.e_mac_pj is not None else tech.e_mac_pj

    def peak_macs_per_cycle(self, mr: int, mc: int) -> float:
        """Peak MAC throughput of an MR x MC grid of this macro."""
        return mr * mc * self.al * self.pc / self.compute_cycles()


# ---------------------------------------------------------------------- #
# Macro library.  Geometry for the silicon-verified vanilla macro is taken
# verbatim from the paper (Sec. IV-E); the others are plausible
# reconstructions of the cited designs (exact parameters are not published
# in the paper text) -- see DESIGN.md Sec. 7.
# ---------------------------------------------------------------------- #
VANILLA_DCIM = MacroSpec(
    # Paper Sec. IV-E: (AL, PC, SCR, ICW, WUW) = (64, 8, 8, 512, 128)
    name="vanilla-dcim", al=64, pc=8, native_scr=8, icw=512, wuw=128,
)

FPCIM = MacroSpec(
    # ref [9]: digital floating-point CIM, long accumulation length
    name="fpcim", al=128, pc=16, native_scr=8, icw=1024, wuw=256,
)

LCC_CIM = MacroSpec(
    # ref [5]: 6T macro with short accumulation length ("LCC-CIM" in Fig. 8
    # generates more partial sums for the same operator)
    name="lcc-cim", al=16, pc=16, native_scr=4, icw=128, wuw=128,
)

TRANCIM_MACRO = MacroSpec(
    # ref [10]: bitline-transpose digital CIM, 4b-serial input
    name="trancim-macro", al=128, pc=16, native_scr=1, icw=512, wuw=256,
)

TPDCIM_MACRO = MacroSpec(
    # ref [16]: transposable digital CIM
    name="tpdcim-macro", al=64, pc=8, native_scr=1, icw=512, wuw=512,
)

ACIM_EXAMPLE = MacroSpec(
    # generic analog CIM: ICW = AL * DAC precision (eq. 2), slow updates
    name="acim-2b-dac", al=256, pc=8, native_scr=4, icw=512, wuw=64,
    kind="acim",
)

MACRO_LIBRARY: dict[str, MacroSpec] = {
    m.name: m
    for m in (VANILLA_DCIM, FPCIM, LCC_CIM, TRANCIM_MACRO, TPDCIM_MACRO,
              ACIM_EXAMPLE)
}


def get_macro(name: str) -> MacroSpec:
    try:
        return MACRO_LIBRARY[name]
    except KeyError:
        raise KeyError(
            f"unknown macro {name!r}; available: {sorted(MACRO_LIBRARY)}"
        ) from None
