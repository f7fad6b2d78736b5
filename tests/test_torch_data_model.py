"""Port data model held against the reference: merged workloads, design-
space pruning and the Table II areas are identical."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_arch as ref_get_arch  # noqa: E402
from repro.core import ir as ref_ir  # noqa: E402
from repro.core import macro as ref_macro  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402
from repro.core import template as ref_template  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.core import ir, macro, pruning, template  # noqa: E402


def test_arch_registry_matches():
    assert ARCH_IDS == REF_ARCH_IDS


@pytest.mark.parametrize("name", ("bert-large",) + REF_ARCH_IDS)
def test_merged_workload_arrays_identical(name):
    if name == "bert-large":
        ref_wl, wl = ref_ir.bert_large_workload(), ir.bert_large_workload()
    else:
        ref_wl, wl = ref_get_arch(name).workload(), get_arch(name).workload()
    np.testing.assert_array_equal(wl.merged().as_arrays(),
                                  ref_wl.merged().as_arrays())
    np.testing.assert_array_equal(wl.merged().as_arrays(pad_to=16),
                                  ref_wl.merged().as_arrays(pad_to=16))
    assert [op.name for op in wl.merged().ops] == \
        [op.name for op in ref_wl.merged().ops]
    # carrying the reference's object across gives the same workload
    assert convert.workload(ref_wl) == wl


@pytest.mark.parametrize("budget", (2.23, 3.52, 5.0))
@pytest.mark.parametrize("name", sorted(ref_macro.MACRO_LIBRARY))
def test_prune_space_identical(name, budget):
    ref_cands, ref_stats = ref_pruning.prune_space(
        ref_pruning.DesignSpace(), ref_macro.MACRO_LIBRARY[name], budget)
    cands, stats = pruning.prune_space(
        pruning.DesignSpace(), macro.MACRO_LIBRARY[name], budget)
    np.testing.assert_array_equal(cands, ref_cands)
    assert stats == ref_stats
    assert convert.macro_spec(ref_macro.MACRO_LIBRARY[name]) == \
        macro.MACRO_LIBRARY[name]


@pytest.mark.parametrize("mname,cfg,area", [
    ("trancim-macro", (3, 1, 1, 64, 128), 3.52),
    ("tpdcim-macro", (2, 4, 1, 16, 16), 2.23),
])
def test_table2_areas_identical(mname, cfg, area):
    ref_cfg = ref_template.AcceleratorConfig(*cfg)
    got = template.accelerator_area_mm2(
        convert.accelerator_config(ref_cfg), macro.get_macro(mname))
    want = ref_template.accelerator_area_mm2(
        ref_cfg, ref_macro.get_macro(mname))
    assert got == want
    assert got == pytest.approx(area, abs=0.01)
    assert template.bandwidth_ok(template.AcceleratorConfig(*cfg),
                                 macro.get_macro(mname)) == \
        ref_template.bandwidth_ok(ref_cfg, ref_macro.get_macro(mname))
