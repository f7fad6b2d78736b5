"""The port's kernel micro-profile pass (``repro_torch.obs.profile``) held
against the reference's: ``run_microbench(device="cpu")`` returns the
documented schema with the reference's kernel, bucket and tiling labels;
its inputs are the reference's arrays for the same seed; matmul work
counts equal the reference's XLA cost analysis (4,194,304 flops, 196,608
bytes at 128^3); the other kernels' counts follow their formulas."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.obs import profile as ref_profile  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import profile  # noqa: E402

SCHEMA = {"kernel", "bucket", "tiling", "us", "flops", "bytes", "seed"}


@pytest.fixture(scope="module")
def records():
    return profile.run_microbench(device="cpu", repeats=1, seed=0)


def _ref_labels(kernels=profile._ALL_KERNELS, seed=0):
    cases = ref_profile._microbench_cases(kernels,
                                          np.random.default_rng(seed))
    return [(kernel, fn.__bucket_fn__(*args, **kwargs), tiling)
            for kernel, tiling, fn, args, kwargs in cases]


def test_schema_and_labels_equal_reference(records):
    assert all(set(r) == SCHEMA for r in records)
    assert all(r["seed"] == 0 and r["us"] > 0 for r in records)
    assert [(r["kernel"], r["bucket"], r["tiling"]) for r in records] == \
        _ref_labels()
    rows = profile.summary(records)
    assert {r["kernel"] for r in rows} == set(profile._ALL_KERNELS)


@pytest.mark.parametrize("seed", [0, 3])
def test_inputs_equal_reference_draws(seed):
    port = profile._microbench_cases(profile._ALL_KERNELS,
                                     np.random.default_rng(seed), "cpu")
    ref = ref_profile._microbench_cases(profile._ALL_KERNELS,
                                        np.random.default_rng(seed))
    assert len(port) == len(ref)
    for (pk, pt, _pf, pargs, pkw), (rk, rt, _rf, rargs, rkw) in zip(port,
                                                                   ref):
        assert (pk, pt) == (rk, rt)
        assert pkw == rkw
        for p, r in zip(pargs, rargs):
            if isinstance(p, torch.Tensor):
                np.testing.assert_array_equal(p.numpy(),
                                              np.asarray(r, np.float32))
            else:
                assert p == convert.macro_spec(r)      # the macro


def test_matmul_work_equals_reference_cost_analysis(records):
    want = ref_profile.run_microbench(kernels=["cim_matmul"], repeats=1)
    for r in records:
        if r["kernel"] == "cim_matmul":
            assert (r["flops"], r["bytes"]) == (4194304.0, 196608.0)
            assert (r["flops"], r["bytes"]) == (want[0]["flops"],
                                                want[0]["bytes"])


def test_work_formulas():
    assert profile.attention_work(1, 128, 128, 64, False, 4) == (
        128 * 128 * (4 * 64 + 5), 4 * 4 * 128 * 64)
    # causal counts the kept (query <= key) pairs, top-left
    assert profile.attention_pairs(1, 128, 128, True) == 128 * 129 / 2
    assert profile.attention_pairs(2, 300, 200, True) == \
        2 * (200 * 201 / 2 + 100 * 200)
    assert profile.attention_pairs(1, 200, 300, True) == 200 * 201 / 2
    assert profile.scan_work(1, 64, 32, 8, 4) == (
        64 * 32 * 57, (3 * 64 * 32 + 2 * 64 * 8) * 4 + (32 * 8 + 2 * 32 * 8)
        * 4)
    flops, nbytes = profile.strategy_eval_work(10, 3, 4)
    assert flops == 10 * (3 * (sum(profile.FLOPS_PER_STRATEGY) + 4) + 38)
    assert nbytes == (70 + 15) * 4


def test_profiling_hook_records_series(records):
    rows = {(r["kernel"], r["bucket"]): r for r in profile.summary()}
    assert ("cim_matmul", "128x128x128") in rows
    assert rows[("cim_matmul", "128x128x128")]["flops"] == 4194304.0


def test_cpu_run_launches_no_kernel():
    before = {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()}
    profile.run_microbench(device="cpu", repeats=1)
    assert {k: w.launches for k, w in ops.KERNEL_WRAPPERS.items()} == before


def test_cuda_requested_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        profile.run_microbench(kernels=["cim_matmul"], repeats=1)


def test_unknown_kernel_rejected():
    with pytest.raises(ValueError, match="unknown kernels"):
        profile.run_microbench(kernels=["nope"], device="cpu")
