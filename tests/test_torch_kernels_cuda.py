"""The port's CUDA kernels against their plain versions on the card.

strategy_eval at the full Fig. 7 shapes: the raw 30,492-point design space
for bert-large (8-operator bucket) and whisper-small (16), all objectives
and strategy sets; fp32 at rtol 1e-5, fp64 at rtol 1e-12 with identical
argmins.  cim_matmul, flash_attention and selective_scan at the shapes and
dtypes of tests/test_kernels.py, at its tolerances (matmul 1e-4 / 0.2,
attention 2e-3 / 3e-2, scan 1e-3 / 0.15), and the calibration microbench
on the card launching all four kernels.

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


def _on(card, x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(card).to(dtype)


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 64, 64), (200, 300, 250),
                                   (128, 128, 128), (1, 700, 130),
                                   (257, 129, 255)])
@pytest.mark.parametrize("tiles", [(128, 128, 128), (64, 128, 64)])
def test_cim_matmul_kernel_matches_plain(card, tiling, dtype, shape, tiles):
    m, k, n = shape
    rng = np.random.default_rng(0)
    a = _on(card, rng.standard_normal((m, k)), dtype)
    b = _on(card, rng.standard_normal((k, n)), dtype)
    bm, bn, bk = tiles
    before = ops.cim_matmul.launches
    got = ops.cim_matmul(a, b, tiling=tiling, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert ops.cim_matmul.launches == before + 1
    want = ref.matmul_ref(a, b, tiling=tiling, bk=bk)
    tol = 1e-4 if dtype == torch.float32 else 0.2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_cim_matmul_af_pf_psum_width_on_card(card):
    rng = np.random.default_rng(1)
    a = _on(card, rng.standard_normal((128, 2048)), torch.bfloat16)
    b = _on(card, rng.standard_normal((2048, 128)), torch.bfloat16)
    exact = ref.matmul_ref(a, b, out_dtype=torch.float32)
    err = {t: float((ops.cim_matmul(a, b, tiling=t).float() - exact).abs()
                    .mean()) for t in ("AF", "PF")}
    assert err["AF"] <= err["PF"] + 1e-6


@pytest.mark.parametrize("tiles", [(128, 128), (64, 64), (128, 64)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (1, 200, 300, 64),
                                   (3, 129, 257, 128)])
def test_flash_attention_kernel_matches_plain(card, causal, shape, tiles):
    bh, t, s, d = shape
    rng = np.random.default_rng(2)
    q, k, v = (_on(card, rng.standard_normal((bh, n, d)))
               for n in (t, s, s))
    got = ops.flash_attention(q, k, v, causal=causal, bq=tiles[0],
                              bk=tiles[1])
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


def test_flash_attention_kernel_bf16(card):
    rng = np.random.default_rng(3)
    q, k, v = (_on(card, rng.standard_normal((2, 256, 64)), torch.bfloat16)
               for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=0)


def _scan_args(card, rng, shape, dtype=torch.float32):
    b, t, i, s = shape
    return (_on(card, rng.standard_normal((b, t, i)), dtype),
            _on(card, np.abs(rng.standard_normal((b, t, i))) * 0.1, dtype),
            _on(card, rng.standard_normal((b, t, s)), dtype),
            _on(card, rng.standard_normal((b, t, s)), dtype),
            _on(card, -np.abs(rng.standard_normal((i, s)))),
            _on(card, rng.standard_normal((b, i, s))))


@pytest.mark.parametrize("tiles", [(16, 16), (128, 256), (32, 64)])
@pytest.mark.parametrize("shape", [(1, 64, 32, 8), (2, 100, 48, 16),
                                   (1, 33, 17, 4)])
def test_selective_scan_kernel_matches_plain(card, shape, tiles):
    args = _scan_args(card, np.random.default_rng(4), shape)
    y, hl = ops.selective_scan(*args, ct=tiles[0], ci=tiles[1])
    y_ref, h_ref = ref.selective_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, atol=1e-3, rtol=0)
    torch.testing.assert_close(hl, h_ref, atol=1e-3, rtol=0)


def test_selective_scan_kernel_bf16(card):
    args = _scan_args(card, np.random.default_rng(5), (1, 64, 32, 8),
                      torch.bfloat16)
    y, hl = ops.selective_scan(*args, ct=16, ci=16)
    assert y.dtype == torch.bfloat16 and hl.dtype == torch.float32
    y_ref, _ = ref.selective_scan_ref(*args)
    torch.testing.assert_close(y.float(), y_ref.float(), atol=0.15, rtol=0)


def test_microbench_launches_every_kernel(card):
    from repro_torch.obs import profile
    before = {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()}
    records = profile.run_microbench(repeats=1)
    assert {r["kernel"] for r in records} == set(ops.KERNEL_WRAPPERS)
    assert all(w.launches > before[k]
               for k, w in ops.KERNEL_WRAPPERS.items())
