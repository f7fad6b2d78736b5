"""The fine-grained two-level mapping-strategy space (paper Sec. III-C).

Accelerator level (scheduling):
  * spatial  -- NR (non-reversed: activations stream from IS, weights live in
    CIM = weight-stationary) vs R (reversed: activations live in CIM,
    weights stream = input-stationary).
  * temporal -- IP (input-priority update: IS contents cycle while CIM
    planes stay resident as long as possible) vs WP (weight-priority update:
    CIM planes cycle while IS rows stay resident).

Macro level (tiling):
  * AF (accumulation-first): the SCR resident planes cover consecutive
    K-tiles of the same output channels -> partial sums accumulate in the
    psum register across consecutive cycles, but each plane needs a distinct
    input chunk.
  * PF (parallel-first): the SCR resident planes cover consecutive N-tiles of
    the same input channels -> the input vector is reused across consecutive
    cycles, but SCR distinct partial-sum groups must be buffered in the
    Output SRAM (and spill to external memory when it overflows).

The full space is the 2 x 2 x 2 = 8-point cross product (Fig. 6b).  The
spatial-only subset {NR, R} x {IP} x {AF} reproduces the prior-work mapping
space of [19] and is the Fig. 7 baseline ("SO").
"""
from __future__ import annotations

import dataclasses
import itertools


@dataclasses.dataclass(frozen=True)
class Strategy:
    spatial: str   # "NR" | "R"
    temporal: str  # "IP" | "WP"
    tiling: str    # "AF" | "PF"

    def __post_init__(self) -> None:
        if self.spatial not in ("NR", "R"):
            raise ValueError(f"bad spatial {self.spatial}")
        if self.temporal not in ("IP", "WP"):
            raise ValueError(f"bad temporal {self.temporal}")
        if self.tiling not in ("AF", "PF"):
            raise ValueError(f"bad tiling {self.tiling}")

    @property
    def index(self) -> int:
        return (
            ("NR", "R").index(self.spatial) * 4
            + ("IP", "WP").index(self.temporal) * 2
            + ("AF", "PF").index(self.tiling)
        )

    def __str__(self) -> str:
        return f"{self.spatial}-{self.temporal}-{self.tiling}"

    @staticmethod
    def from_index(i: int) -> "Strategy":
        if not 0 <= i < 8:
            raise ValueError(f"strategy index out of range: {i}")
        return Strategy(
            spatial=("NR", "R")[i // 4],
            temporal=("IP", "WP")[(i // 2) % 2],
            tiling=("AF", "PF")[i % 2],
        )

    @staticmethod
    def parse(s: str) -> "Strategy":
        sp, t, f = s.upper().split("-")
        return Strategy(sp, t, f)


ALL_STRATEGIES: tuple[Strategy, ...] = tuple(
    Strategy(sp, t, f)
    for sp, t, f in itertools.product(("NR", "R"), ("IP", "WP"), ("AF", "PF"))
)

# Spatial-only baseline space of [19]: weight/input stationary selection with
# conventional input-priority updates and no SCR-aware tiling.
SPATIAL_ONLY: tuple[Strategy, ...] = (
    Strategy("NR", "IP", "AF"),
    Strategy("R", "IP", "AF"),
)

STRATEGY_SETS: dict[str, tuple[Strategy, ...]] = {
    "st": ALL_STRATEGIES,   # scheduling + tiling (CIM-Tuner)
    "so": SPATIAL_ONLY,     # spatial scheduling only (prior work [19])
}
