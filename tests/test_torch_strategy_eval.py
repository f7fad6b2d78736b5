"""The port's strategy_eval wrapper on the CPU (its plain version) held
against the reference's Pallas kernel in interpret mode and its jnp
oracle, at rtol 1e-5 (tests/test_kernels.py's bar)."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core import ir as ref_ir  # noqa: E402
from repro.core import macro as ref_macro  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_ref  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import ExplorationEngine, co_explore, evaluate_config  # noqa: E402
from repro_torch.core.template import AcceleratorConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the space of tests/test_kernels.py::test_strategy_eval_vs_ref_and_explorer
SPACE = dict(mr=(1, 2), mc=(1, 2), scr=(1, 4, 16), is_kb=(4, 64),
             os_kb=(4, 64))


@pytest.mark.parametrize("objective", ["ee", "th"])
@pytest.mark.parametrize("mname", ["vanilla-dcim", "tpdcim-macro"])
def test_strategy_eval_cpu_matches_pallas_interpret(mname, objective):
    cands = ref_pruning.candidates_with_bw(ref_pruning.enumerate_space(
        ref_pruning.DesignSpace(**SPACE)), 256)
    wl = ref_ir.bert_large_workload().merged().as_arrays()
    m = ref_macro.get_macro(mname)
    want = np.asarray(ref_ops.strategy_eval(cands, wl, m, objective=objective,
                                            interpret=True))
    oracle = np.asarray(ref_ref.strategy_eval_ref(cands, wl, m,
                                                  objective=objective))
    before = ops.strategy_eval.launches
    got = ops.strategy_eval(torch.as_tensor(cands, dtype=torch.float32),
                            torch.as_tensor(wl, dtype=torch.float32),
                            convert.macro_spec(m), objective=objective)
    assert got.dtype == torch.float32 and got.shape == (len(cands),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5)
    # the CPU path is the plain version: no kernel launch counted
    assert ops.strategy_eval.launches == before == 0


def test_cpu_paths_leave_launch_counters_at_zero():
    from repro_torch.core import ExploreJob, bert_large_workload, get_macro
    from repro_torch.core.pruning import DesignSpace
    ExplorationEngine(device="cpu").run(
        [ExploreJob(get_macro("vanilla-dcim"), bert_large_workload(), 5.0,
                    space=DesignSpace(**SPACE))], method="exhaustive")
    evaluate_config(get_macro("vanilla-dcim"),
                    AcceleratorConfig(2, 2, 4, 64, 64), bert_large_workload(),
                    device="cpu")
    assert ops.job_objective.launches == 0
    assert ops.strategy_eval.launches == 0


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the no-card path is moot")
    from repro_torch.core import bert_large_workload, get_macro
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ExplorationEngine(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ExplorationEngine()                       # cuda is the default
    with pytest.raises(RuntimeError, match="no CUDA card"):
        co_explore(get_macro("vanilla-dcim"), bert_large_workload(), 5.0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        evaluate_config(get_macro("vanilla-dcim"),
                        AcceleratorConfig(2, 2, 4, 64, 64),
                        bert_large_workload())
