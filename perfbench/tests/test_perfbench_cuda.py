"""On the card (``-m cuda``): a run of each cell at a test's size through
the hand-written kernels, traced, read by every per-layer reader."""
import time
import types

import pytest

from perfbench import harness
from perfbench.drivers import train
from perfbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_traced_run_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny.cell(workload)
    cell.per_layer = harness.find_cell(workload).per_layer
    args = types.SimpleNamespace(seed=2 ** 31 + 9, seconds=2.0, trace=1)
    out = train.run(cell, args, time.time())
    assert out.device["platform"] == "gpu" and out.device["busy_s"] > 0
    line = harness.result_line(cell, out, trace=True)
    names = {m["name"] for m in cell.per_layer}
    # every reader finds its kernels, spans and steps on the card
    assert set(line["metrics"]) == names
    for name, m in line["metrics"].items():
        assert m["value"] >= 0, name
        if name.endswith("_roofline.train"):
            assert m["value"] <= 105, name
    assert all(v["value"] == v["value"] for v in out.compared.values())
