"""The strategy_eval CUDA kernel against its plain version on the card, at
the full Fig. 7 shapes: the raw 30,492-point design space for bert-large
(8-operator bucket) and whisper-small (16), all objectives and strategy
sets.  fp32 at rtol 1e-5, fp64 at rtol 1e-12 with identical argmins.

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import bert_large_workload, cost_model, get_macro
from repro_torch.core.pruning import DesignSpace, candidates_with_bw, enumerate_space
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100 with -m cuda)")
    return torch.device("cuda")


def _jobs(workload, dtype, device):
    P = 16 if len(workload.ops) > 8 else 8
    rows = [cost_model.job_params_np(workload.as_arrays(pad_to=P),
                                     get_macro("vanilla-dcim"), None, obj,
                                     sset, 5.0, 256)
            for obj in ("ee", "th", "edp") for sset in ("st", "so")]
    return cost_model.stack_job_params(rows, dtype, device)


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-12)])
@pytest.mark.parametrize("network", ["bert-large", "whisper-small"])
def test_kernel_matches_plain_on_raw_space(card, network, dtype, rtol):
    wl = bert_large_workload() if network == "bert-large" else \
        get_arch(network).workload()
    job = _jobs(wl, dtype, card)
    raw = candidates_with_bw(enumerate_space(DesignSpace()), 256)
    cand = torch.as_tensor(np.repeat(raw[None], len(job.bw), 0),
                           dtype=dtype).to(card)
    before = ops.job_objective.launches
    got = ops.job_objective(job, cand, 1e3, totals=True)
    torch.cuda.synchronize()
    assert ops.job_objective.launches == before + 1
    want = ref.job_objective_ref(job, cand, 1e3, totals=True)
    for g, w in zip(got[:3], want[:3]):
        torch.testing.assert_close(g, w, rtol=rtol, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=0)


def test_single_job_wrapper_matches_plain(card):
    wl = torch.as_tensor(bert_large_workload().as_arrays(), device=card)
    raw = torch.as_tensor(candidates_with_bw(enumerate_space(DesignSpace()),
                                             256), device=card)
    for dtype in (torch.float32, torch.float64):
        got = ops.strategy_eval(raw.to(dtype), wl.to(dtype),
                                get_macro("vanilla-dcim"))
        want = ref.strategy_eval_ref(raw.to(dtype), wl.to(dtype),
                                     get_macro("vanilla-dcim"))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
