"""The port's systolic-array baseline (paper Fig. 1) held against the
reference: ``systolic_latency`` and ``buffer_sweep`` rows equal, both
dataflows, and the sweep's U-shape."""
import dataclasses

import pytest

pytest.importorskip("jax")

import repro.core.systolic as ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import systolic  # noqa: E402
from repro_torch.core.calibration import DEFAULT_TECH  # noqa: E402

SHAPES = ((512, 2048, 2048), (100, 256, 300), (1, 4096, 1024),
          (4096, 64, 7))


@pytest.mark.parametrize("dataflow", ["ws", "is"])
def test_latency_rows_equal_reference(dataflow):
    for rows, cols, buf in ((32, 32, 8), (32, 32, 2048), (16, 16, 64),
                            (128, 96, 512), (1, 1, 1)):
        want_cfg = ref.SystolicConfig(rows, cols, buf_kb=buf)
        cfg = convert.systolic_config(want_cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg)
        assert systolic.systolic_area_mm2(cfg) == \
            ref.systolic_area_mm2(want_cfg)
        for m, k, n in SHAPES:
            assert systolic.systolic_latency(cfg, m, k, n, dataflow) == \
                ref.systolic_latency(want_cfg, m, k, n, dataflow)


@pytest.mark.parametrize("dataflow", ["ws", "is"])
@pytest.mark.parametrize("budget", [2.0, 5.0, 12.0])
def test_buffer_sweep_rows_equal_reference(dataflow, budget):
    for m, k, n in SHAPES[:2]:
        got = systolic.buffer_sweep(area_budget_mm2=budget, m=m, k=k, n=n,
                                    dataflow=dataflow, tech=DEFAULT_TECH)
        want = ref.buffer_sweep(area_budget_mm2=budget, m=m, k=k, n=n,
                                dataflow=dataflow)
        assert got == want
        assert all(r["area_mm2"] <= budget + 1e-6 for r in got)


def test_fig1_sweep_is_u_shaped():
    """Fig. 1 at 5 mm^2: the latency's optimum lies inside the sweep."""
    rows = systolic.buffer_sweep(area_budget_mm2=5.0, m=512, k=2048, n=2048)
    lats = [r["total_cycles"] for r in rows]
    best = lats.index(min(lats))
    assert 0 < best < len(lats) - 1
    assert lats[0] > lats[best] < lats[-1]
