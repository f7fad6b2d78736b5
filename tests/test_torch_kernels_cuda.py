"""The port's CUDA kernels against their plain versions on the card.

strategy_eval at the full Fig. 7 shapes: the raw 30,492-point design space
for bert-large (8-operator bucket) and whisper-small (16), all objectives
and strategy sets; fp32 at rtol 1e-5, fp64 at rtol 1e-12 with identical
argmins.  cim_matmul, flash_attention and selective_scan at the shapes and
dtypes of tests/test_kernels.py, at its tolerances (matmul 1e-4 / 0.2,
attention 2e-3 / 3e-2, scan 1e-3 / 0.15), and the calibration microbench
on the card launching all four kernels.  The bf16 tensor-core routes of
cim_matmul and flash_attention at every tile set (a ragged matmul that
needs TMA padding, AF and PF; attention with T != S ragged, at every
compiled head width and at 120, 200 and 16, causal or not) at chip_smoke.py's bf16 tolerances, misaligned
operand bases, and HGMMA / UTMALDG in every bf16 instantiation's SASS
(and in flash_attention_bwd's, which spills no register).
strategy_eval (two lanes a candidate) at an SA step's [1, 64] and each
operator bucket, exact in fp32 and fp64 with identical indices, and no
spills.  selective_scan at every (ct, ci) tile, S in {1, 4, 8, 16},
ragged T and I, fp32 and bf16 (cp.async and plain staging), at
chip_smoke.py's tolerances; at least 16 warps a SM at falcon-mamba-7b's
width.  Each search backend (Sobol, GA, DE, the bandit and halving
portfolio) with the kernel as its objective equals the same backend with
the plain version on the card: winners, values, traces and pulls.  The
DSE service's queue on the card (its worker thread launching the kernel)
gives the 28 Fig. 7 exhaustive jobs exactly as one engine run does.  The
distributed DSE over the 28 Fig. 7 jobs on 1 and 4 slots of the card
with the kernel equals the same run with the plain version (configs,
bests, traces, final populations), and ``simulate_schedule`` on the card
equals the CPU in fp64.

Needs a CUDA card; run with ``pytest -m cuda tests/test_torch_kernels_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import bert_large_workload, cost_model, get_macro
from repro_torch.core.pruning import DesignSpace, candidates_with_bw, enumerate_space
from repro_torch.kernels import flash_attention as fa_k
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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 120, 200, 256])
def test_flash_attention_fp32_other_widths(card, d, causal):
    """The fp32 route at widths run on a wider compiled width and at 256
    (64 x 64 tiles), T != S ragged."""
    rng = np.random.default_rng(d)
    q, k, v = (_on(card, rng.standard_normal((2, n, d))) for n in (129, 257,
                                                                   257))
    got = ops.flash_attention(q, k, v, causal=causal)
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


# ---- the bf16 tensor-core routes (wgmma + TMA): every tile set ------------

BF16_TOL = {"AF": (1e-3, 2 ** -7), "PF": (1.0, 2 ** -6)}   # chip_smoke.py's


def _within(got, want, atol, rtol):
    g, w = got.float(), want.float()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(g).all())
    assert float(((g - w).abs() - (atol + rtol * w.abs())).max()) <= 0


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("tiles", [(bm, bn, bk) for bm in (64, 128)
                                   for bn in (64, 128) for bk in (64, 128)],
                         ids=lambda t: "x".join(map(str, t)))
def test_cim_matmul_bf16_every_tile_set(card, tiling, tiles):
    """A ragged shape whose K and N need TMA padding (300 and 250 are not
    multiples of 8)."""
    rng = np.random.default_rng(6)
    a = _on(card, rng.standard_normal((257, 300)), torch.bfloat16)
    b = _on(card, rng.standard_normal((300, 250)), torch.bfloat16)
    bm, bn, bk = tiles
    got = ops.cim_matmul(a, b, tiling=tiling, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    _within(got, ref.matmul_ref(a, b, tiling=tiling, bk=bk),
            *BF16_TOL[tiling])


@pytest.mark.parametrize("tiling", ["AF", "PF"])
def test_cim_matmul_bf16_misaligned_base(card, tiling):
    """A contiguous operand whose base is 2 bytes off a 16-byte boundary
    goes through an aligned copy, not around the kernel."""
    rng = np.random.default_rng(8)
    buf = _on(card, rng.standard_normal(1 + 128 * 192), torch.bfloat16)
    a = buf[1:].view(128, 192)
    b = _on(card, rng.standard_normal((192, 136)), torch.bfloat16)
    before = ops.cim_matmul.launches
    got = ops.cim_matmul(a, b, tiling=tiling)
    torch.cuda.synchronize()
    assert ops.cim_matmul.launches == before + 1
    _within(got, ref.matmul_ref(a, b, tiling=tiling), *BF16_TOL[tiling])


def test_flash_attention_bf16_misaligned_base(card):
    """A contiguous q whose base is 2 bytes off a 16-byte boundary goes
    through an aligned copy, not around the kernel."""
    rng = np.random.default_rng(10)
    buf = _on(card, rng.standard_normal(1 + 128 * 64), torch.bfloat16)
    q = buf[1:].view(1, 128, 64)
    k, v = (_on(card, rng.standard_normal((1, 96, 64)), torch.bfloat16)
            for _ in range(2))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    _within(got, ref.attention_ref(q, k, v, causal=True), 1e-3, 2 ** -7)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 200, 333), (2, 333, 200)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("d,tiles", [
    (d, t) for d in (64, 128, 256, 120, 200, 16)
    for t in fa_k.WIDTH_TILES[fa_k.compiled_width(d)]],
    ids=lambda x: f"bq{x[0]}xbk{x[1]}" if isinstance(x, tuple) else str(x))
def test_flash_attention_bf16_every_tile_set(card, d, shape, causal, tiles):
    """T != S, both ragged, at every tile set of every compiled width and
    at widths run on a wider one (120, 200, 16); chip_smoke.py's bf16
    tolerance."""
    bh, t, s = shape
    rng = np.random.default_rng(9)
    q, k, v = (_on(card, rng.standard_normal((bh, n, d)), torch.bfloat16)
               for n in (t, s, s))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, bq=tiles[0],
                              bk=tiles[1])
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    _within(got, ref.attention_ref(q, k, v, causal=causal), 1e-3, 2 ** -7)


def test_tensor_core_kernels_have_hgmma_in_sass(card):
    """Every bf16 instantiation of cim_matmul and flash_attention, and
    every instantiation of flash_attention_bwd's two passes, issues wgmma
    (HGMMA) and TMA loads (UTMALDG) in its SASS; every fp32 (3xTF32)
    instantiation of cim_matmul and flash_attention issues wgmma (its
    producer threads load with plain loads, not TMA)."""
    import re
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    from repro_torch.kernels import cim_matmul as cm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    tool = Path(build.nvcc()).with_name("cuobjdump")
    # (module, names of the instantiations' functions, how many, TMA)
    for mod, names, want, tma in (
            (cm, ("2tc9af_kernelILi", "2tc9pf_kernelILi"), 16, True),
            (cm, ("2tf9mm_kernelILi",), 2, False),
            (fa, ("2tc12flash_kernelILi",), 9, True),
            (fa, ("2tf12flash_kernelILi",), 3, False),
            (fab, ("dq_kernelILi", "dkdv_kernelILi"), 6, True)):
        sass = subprocess.run([str(tool), "-sass",
                               str(build.build(mod.SOURCE, mod.NVCC_FLAGS))],
                              capture_output=True, text=True,
                              check=True).stdout
        funcs = re.split(r"\n\s*Function : ", sass)[1:]
        tc = [f for f in funcs if any(n in f.split()[0] for n in names)]
        assert len(tc) == want, names
        for f in tc:
            assert "HGMMA" in f, f.split()[0]
            assert ("UTMALDG" in f) == tma, f.split()[0]


# ---- the fp32 routes (3xTF32 wgmma) -----------------------------------------

#: tf32 keeps 10 explicit mantissa bits: a value 3/4 of a tf32 step above 1
TF32_STEP = 2.0 ** -10


def _probe(card, rs, a, b):
    """One wgmma m64n64k8 .tf32 product of raw fp32 a [64, 8] and b^T
    [64, 8] (tests/tf32_probe.cu): A from shared memory (rs = 0) or from
    registers (rs = 1)."""
    import ctypes
    from pathlib import Path

    from repro_torch.kernels import build
    src = Path(__file__).resolve().parent / "tf32_probe.cu"
    lib = build.load(src, build.BASE_FLAGS + ("-I", str(build.CSRC)))
    lib.tf32_probe.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.tf32_probe.restype = ctypes.c_int
    a, b = (torch.as_tensor(x, dtype=torch.float32).to(card).contiguous()
            for x in (a, b))
    d = torch.empty((64, 64), dtype=torch.float32, device=card)
    err = lib.tf32_probe(rs, a.data_ptr(), b.data_ptr(), d.data_ptr(),
                         torch.cuda.current_stream(card).cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return d.cpu().numpy()


@pytest.mark.parametrize("rs", [0, 1], ids=["smem", "registers"])
def test_wgmma_tf32_reads_raw_fp32_as_tf32(card, rs):
    """How wgmma .tf32 treats a raw fp32 word, in one launch: with every
    A value 1 + 3/4 of a tf32 step and B ones, each output is 8 times what
    the tensor cores read.  Its low 13 bits never reach the product
    (1 + 0.75 step would give 8.0059): the value is truncated (8) or
    rounded (8.0078).  That is why the fp32 routes split every operand
    into hi + lo parts and run three products; they store hi themselves
    (cvt.rna), so they depend on neither reading.  The same launch with
    A = r * 8 + k and B^T the identity returns A, which checks the
    swizzled K-major layout (smem) and the A fragment's register layout
    (registers) that the fp32 routes use."""
    ones = np.zeros((64, 8), np.float32)
    ones[:8] = 1.0
    x = np.float32(1 + 0.75 * TF32_STEP)
    read = _probe(card, rs, np.full((64, 8), x, np.float32), ones)
    got = float(read[0, 0])
    print(f"wgmma .tf32 ({'registers' if rs else 'smem'}) reads "
          f"1 + 0.75 step as {got / 8!r}: "
          + ("truncated" if got == 8.0 else "rounded to nearest"
             if got == 8 * (1 + TF32_STEP) else "neither"))
    assert got in (8.0, 8 * (1 + TF32_STEP))
    np.testing.assert_array_equal(read[:, :8], got)
    a = (np.arange(64)[:, None] * 8 + np.arange(8)[None]).astype(np.float32)
    eye = np.zeros((64, 8), np.float32)
    eye[np.arange(8), np.arange(8)] = 1.0
    out = _probe(card, rs, a, eye)
    np.testing.assert_array_equal(out[:, :8], a)
    np.testing.assert_array_equal(out[:, 8:], 0.0)


@pytest.mark.parametrize("tiling", ["AF", "PF"])
@pytest.mark.parametrize("tiles", [(bm, bn, bk) for bm in (64, 128)
                                   for bn in (64, 128) for bk in (64, 128)],
                         ids=lambda t: "x".join(map(str, t)))
def test_cim_matmul_fp32_every_tile_set(card, tiling, tiles):
    """The 3xTF32 route at every tile set on a ragged shape (N = 250 is
    padded to 252 for the 16-byte loads), at the fp32 tolerance."""
    rng = np.random.default_rng(11)
    a = _on(card, rng.standard_normal((257, 300)))
    b = _on(card, rng.standard_normal((300, 250)))
    bm, bn, bk = tiles
    got = ops.cim_matmul(a, b, tiling=tiling, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul_ref(a, b, tiling=tiling,
                                                   bk=bk),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tiling", ["AF", "PF"])
def test_cim_matmul_fp32_long_k(card, tiling):
    """K = 4096 (512 x 4096 x 1024): 128 stages of three products each
    stay within 1e-4 of the plain version."""
    rng = np.random.default_rng(12)
    a = _on(card, rng.standard_normal((512, 4096)))
    b = _on(card, rng.standard_normal((4096, 1024)))
    got = ops.cim_matmul(a, b, tiling=tiling)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.matmul_ref(a, b, tiling=tiling),
                               atol=1e-4, rtol=1e-4)


def test_cim_matmul_fp32_misaligned_base(card):
    """A contiguous fp32 operand 4 bytes off a 16-byte boundary goes
    through an aligned copy, not around the kernel."""
    rng = np.random.default_rng(13)
    buf = _on(card, rng.standard_normal(1 + 128 * 192))
    a = buf[1:].view(128, 192)
    b = _on(card, rng.standard_normal((192, 136)))
    before = ops.cim_matmul.launches
    got = ops.cim_matmul(a, b)
    torch.cuda.synchronize()
    assert ops.cim_matmul.launches == before + 1
    torch.testing.assert_close(got, ref.matmul_ref(a, b), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 1000, 1533), (2, 1533, 1000)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_fp32_yi_width_ragged(card, shape, causal):
    """yi-6b's head width (128) with T != S, both ragged, on the 3xTF32
    route, at the fp32 tolerance."""
    bh, t, s = shape
    rng = np.random.default_rng(14)
    q, k, v = (_on(card, rng.standard_normal((bh, n, 128)))
               for n in (t, s, s))
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.attention_ref(q, k, v,
                                                      causal=causal),
                               atol=2e-3, rtol=0)


def test_flash_attention_fp32_misaligned_base(card):
    """A contiguous fp32 q 4 bytes off a 16-byte boundary goes through an
    aligned copy, not around the kernel."""
    rng = np.random.default_rng(15)
    buf = _on(card, rng.standard_normal(1 + 128 * 64))
    q = buf[1:].view(1, 128, 64)
    k, v = (_on(card, rng.standard_normal((1, 96, 64))) for _ in range(2))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=True),
                               atol=2e-3, rtol=0)


# ---- strategy_eval at the main path's shapes, exact ------------------------

def _bucket_jobs(card, dtype, n_ops):
    """6 jobs (every objective and strategy set) over bert-large's
    operators cut or padded to ``n_ops`` rows."""
    ops_arr = bert_large_workload().merged().as_arrays(pad_to=16)[:n_ops]
    rows = [cost_model.job_params_np(ops_arr, get_macro("vanilla-dcim"),
                                     None, obj, sset, 5.0, 256)
            for obj in ("ee", "th", "edp") for sset in ("st", "so")]
    return cost_model.stack_job_params(rows, dtype, card)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(1, 64, 8), (1, 63, 8), (6, 4096, 4),
                                   (6, 4096, 8), (6, 4096, 16),
                                   (6, 1000, 8), (6, 1, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_strategy_eval_exact_at_launch_shapes(card, shape, dtype):
    """An SA step's [1, 64] (and a ragged [1, 63]) and sweep blocks at each
    operator bucket: objective, totals and indices equal the plain
    version's bit for bit."""
    from repro_torch.kernels import strategy_eval as se
    J, C, P = shape
    job = _bucket_jobs(card, dtype, P)
    job = job._replace(**{f: getattr(job, f)[:J] for f in job._fields
                          if f not in ("macro", "tech")},
                       macro=type(job.macro)(*[v[:J] for v in job.macro]),
                       tech=type(job.tech)(*[v[:J] for v in job.tech]))
    raw = candidates_with_bw(enumerate_space(DesignSpace()), 256)
    rows = np.random.default_rng(C).choice(len(raw), (J, C))
    cand = torch.as_tensor(raw[rows], dtype=dtype).to(card)
    got = se.launch(cand, job.ops, se.pack_params(job), 1e3, totals=True)
    torch.cuda.synchronize()
    want = ref.job_objective_ref(job, cand, 1e3, totals=True)
    for name, g, w in zip(("obj", "lat", "en", "idx"), got, want):
        assert torch.equal(g, w), name


def test_strategy_eval_has_no_spills(card):
    import re

    from repro_torch.kernels import strategy_eval as se
    report = se.ptxas_report()
    assert len(re.findall(r"Used \d+ registers", report)) == 2
    assert all(int(x) == 0 for x in re.findall(r"(\d+) bytes spill", report))


def test_flash_attention_bwd_has_no_spills(card):
    """Both passes of the backward at the three compiled widths: six
    kernels, no spill stores or loads."""
    import re

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_bwd as fab
    report = build.ptxas_report(fab.SOURCE, fab.NVCC_FLAGS)
    assert len(re.findall(r"Used \d+ registers", report)) == 6
    assert all(int(x) == 0 for x in re.findall(r"(\d+) bytes spill", report))


# ---- selective_scan: every tile, state width and dtype ---------------------

SCAN_TOL = {torch.float32: (1e-3, 0.0), torch.bfloat16: (1e-3, 2 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("s", [1, 4, 8, 16])
@pytest.mark.parametrize("ci", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("ct", [16, 32, 64, 128])
def test_selective_scan_every_tile(card, ct, ci, s, dtype):
    """B = 2, T two chunks and a ragged one, I past the tile (odd for S <=
    4, so bf16 stages with plain loads; even above, so it takes cp.async)."""
    from repro_torch.kernels import selective_scan as ss
    shape = (2, 2 * ct + 7, ci + (5 if s <= 4 else 8), s)
    args = _scan_args(card, np.random.default_rng(ct + ci + s), shape, dtype)
    before = ops.selective_scan.launches
    got = ops.selective_scan(*args, ct=ct, ci=ci)
    torch.cuda.synchronize()
    assert ops.selective_scan.launches == before + 1
    assert ct in ss.CT_TILES and ci in ss.CI_TILES
    for g, w in zip(got, ref.selective_scan_ref(*args)):
        _within(g, w, *SCAN_TOL[dtype])


def test_selective_scan_bf16_misaligned_base(card):
    """bf16 inputs 2 bytes off a 4-byte boundary stage with plain loads."""
    rng = np.random.default_rng(12)
    args = list(_scan_args(card, rng, (1, 40, 32, 8), torch.bfloat16))
    buf = _on(card, rng.standard_normal(1 + 40 * 32), torch.bfloat16)
    args[0] = buf[1:].view(1, 40, 32)
    got = ops.selective_scan(*args, ct=16, ci=32)
    torch.cuda.synchronize()
    for g, w in zip(got, ref.selective_scan_ref(*args)):
        _within(g, w, *SCAN_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_falcon_width_warps_per_sm(card, dtype):
    from repro_torch.kernels import selective_scan as ss
    g = ss.geometry(dtype, 1, 8192, 16, 128, 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = min(g["blocks"], g["blocks_per_sm"] * sms)
    assert g["group"] == 16 and resident * g["threads"] / 32 / sms >= 16


# ---- the search backends: kernel against the plain version -----------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("method,allocator", [
    ("sobol", None), ("genetic", None), ("evolution", None),
    ("portfolio", "bandit"), ("portfolio", "halving")])
def test_search_backend_kernel_equals_plain(card, method, allocator, dtype):
    """Each backend on the full design space with the kernel as its
    objective gives what the same backend gives with the plain version on
    the card: the same draws, so the same winners, values and pulls."""
    from repro_torch import search
    from repro_torch.core import ExplorationEngine, ExploreJob
    macro = get_macro("vanilla-dcim")
    jobs = [ExploreJob(macro, wl, 5.0, objective=obj)
            for wl in (bert_large_workload(),
                       get_arch("whisper-small").workload(seq=512))
            for obj in ("ee", "th")]
    settings = {
        "sobol": search.SobolSettings(n_points=1600, seed=3),
        "genetic": search.GASettings(pop=64, generations=24, seed=3),
        "evolution": search.DESettings(pop=48, generations=32, seed=3),
        "portfolio": search.PortfolioSettings(
            total_evals=6400, seed=3, allocator=allocator or "bandit"),
    }[method]
    before = ops.job_objective.launches
    got = ExplorationEngine(device=card, dtype=dtype).run(
        jobs, method=method, settings=settings)
    torch.cuda.synchronize()
    assert ops.job_objective.launches > before
    want = ExplorationEngine(device=card, dtype=dtype,
                             evaluator=ref.job_objective_ref).run(
        jobs, method=method, settings=settings)
    for g, w in zip(got, want):
        assert g.config == w.config and g.metrics == w.metrics
        assert torch.equal(g.sa.best_per_chain, w.sa.best_per_chain)
        assert torch.equal(g.sa.trace_best, w.sa.trace_best)
        assert g.search.get("portfolio") == w.search.get("portfolio")


# ---- the DSE service's queue on the card -----------------------------------

FIG7 = ("bert-large", "yi-6b", "gemma-7b", "falcon-mamba-7b",
        "granite-moe-3b-a800m", "mixtral-8x7b", "whisper-small")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_service_queue_equals_engine_on_card(card, dtype, tmp_path):
    """The 28 Fig. 7 exhaustive jobs through an in-process JobQueue on the
    card (its worker thread launches the kernel) equal one engine run bit
    for bit, in one dispatch per operator bucket."""
    from repro_torch.core import ExplorationEngine, ExploreJob
    from repro_torch.service import JobQueue, QueueConfig, ResultStore
    macro = get_macro("vanilla-dcim")
    jobs = [ExploreJob(macro, bert_large_workload() if n == "bert-large"
                       else get_arch(n).workload(seq=512), 5.0,
                       objective=obj, strategy_set=sset)
            for n in FIG7 for sset in ("so", "st") for obj in ("ee", "th")]
    want = ExplorationEngine(device=card, dtype=dtype).run(
        jobs, method="exhaustive")
    before = ops.job_objective.launches
    with JobQueue(engine=ExplorationEngine(device=card, dtype=dtype),
                  store=ResultStore(str(tmp_path)),
                  config=QueueConfig(batch_window_s=0.2)) as q:
        futs = q.submit_many(jobs, method="exhaustive")
        got = [f.result(timeout=600) for f in futs]
        assert q.stats["dispatches"] == 2
    assert ops.job_objective.launches > before
    for g, w in zip(got, want):
        assert g.config == w.config
        assert g.per_op_strategy == w.per_op_strategy
        assert g.metrics == w.metrics
        assert g.search["device"] == torch.cuda.get_device_name(card)


# ---- slice 7: the distributed DSE and the simulator on the card ------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("slots", [1, 4])
def test_distributed_kernel_equals_plain(card, slots, dtype, tmp_path):
    """The distributed DSE over the 28 Fig. 7 jobs with the kernel as its
    evaluator equals the same run with the plain version on the card: the
    draws are the same, so configs, bests, traces and final populations."""
    from repro_torch.core import ExploreJob, SASettings
    from repro_torch.core.distributed import distributed_co_explore_jobs
    macro = get_macro("vanilla-dcim")
    jobs = [ExploreJob(macro, bert_large_workload() if n == "bert-large"
                       else get_arch(n).workload(seq=512), 5.0,
                       objective=obj, strategy_set=sset)
            for n in FIG7 for sset in ("so", "st") for obj in ("ee", "th")]
    kw = dict(settings=SASettings(seed=3), chains_per_device=4, rounds=3,
              sync_every=20, dtype=dtype)
    before = ops.job_objective.launches
    got = distributed_co_explore_jobs([card] * slots, jobs,
                                      checkpoint_dir=str(tmp_path / "k"),
                                      **kw)
    assert ops.job_objective.launches - before == slots * (1 + 3 * 20)
    want = distributed_co_explore_jobs(
        [card] * slots, jobs, checkpoint_dir=str(tmp_path / "p"),
        evaluator=ref.job_objective_ref, **kw)
    for g, w in zip(got, want):
        assert g.config == w.config
        assert g.best_value == w.best_value
        assert g.trace == w.trace
    with np.load(tmp_path / "k" / "dse_state.npz") as a, \
            np.load(tmp_path / "p" / "dse_state.npz") as b:
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("overlap", [True, False])
def test_simulate_schedule_card_equals_cpu_fp64(card, overlap):
    """simulate_schedule on the card equals the CPU in fp64 (exact), on
    schedules of 3 to 8,192 sets."""
    from repro_torch.core import (ALL_STRATEGIES, AcceleratorConfig,
                                  compile_schedule, simulate_schedule,
                                  strategy_feasible)
    macro = get_macro("vanilla-dcim")
    n = 0
    for cfg, (m, k, nn) in [((2, 2, 4, 16, 8), (40, 300, 200)),
                            ((1, 2, 4, 16, 8), (512, 1024, 1024)),
                            ((3, 2, 16, 128, 64), (512, 4096, 1024))]:
        cfg = AcceleratorConfig(*cfg)
        for s in ALL_STRATEGIES:
            if not strategy_feasible(macro, cfg, m, k, nn, s):
                continue
            rec = compile_schedule(macro, cfg, m, k, nn, s)
            got = simulate_schedule(rec, cfg.bw, overlap, device=card,
                                    dtype=torch.float64)
            want = simulate_schedule(rec, cfg.bw, overlap, device="cpu",
                                     dtype=torch.float64)
            assert got == want
            assert simulate_schedule(rec, cfg.bw, overlap)["n_sets"] == \
                want["n_sets"]
            n += 1
    assert n >= 12


@pytest.fixture
def cards(card):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return [torch.device("cuda", i) for i in range(n)]


def test_distributed_across_cards_equals_one_card(cards, tmp_path):
    """A mesh of one slot per card equals the same number of slots on card
    0: placement feeds neither the draws nor the kernel's values."""
    from repro_torch.core import ExploreJob, SASettings
    from repro_torch.core.distributed import distributed_co_explore_jobs
    macro = get_macro("vanilla-dcim")
    jobs = [ExploreJob(macro, get_arch(n).workload(seq=512), 5.0,
                       objective=obj)
            for n in ("yi-6b", "whisper-small") for obj in ("ee", "th")]
    kw = dict(settings=SASettings(seed=1), chains_per_device=4, rounds=3,
              sync_every=20)
    spread = distributed_co_explore_jobs(
        cards, jobs, checkpoint_dir=str(tmp_path / "a"), **kw)
    stacked = distributed_co_explore_jobs(
        [cards[0]] * len(cards), jobs, checkpoint_dir=str(tmp_path / "b"),
        **kw)
    for g, w in zip(spread, stacked):
        assert g.config == w.config and g.best_value == w.best_value
        assert g.trace == w.trace
    with np.load(tmp_path / "a" / "dse_state.npz") as a, \
            np.load(tmp_path / "b" / "dse_state.npz") as b:
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_portfolio_race_across_cards_equals_one_card(cards):
    """The engine's portfolio raced across the cards (race_devices) equals
    its one-card run bit for bit, and places runs on the other cards."""
    from repro_torch.core import ExplorationEngine, ExploreJob
    from repro_torch.search import PortfolioSettings
    macro = get_macro("vanilla-dcim")
    jobs = [ExploreJob(macro, bert_large_workload(), 5.0, objective=obj)
            for obj in ("ee", "th")]
    s = PortfolioSettings(total_evals=1600, seed=4)
    raced_engine = ExplorationEngine(device=cards[0])
    raced = raced_engine.run(jobs, method="portfolio", settings=s)
    single = ExplorationEngine(device=cards[0], device_race=False).run(
        jobs, method="portfolio", settings=s)
    assert raced_engine.stats_snapshot()["device_race_dispatches"] > 0
    for r, q in zip(raced, single):
        assert r.search["portfolio"]["devices"] == len(cards)
        assert q.search["portfolio"]["devices"] == 1
        assert r.config == q.config
        assert float(r.sa.best_value) == float(q.sa.best_value)
        assert r.search["portfolio"]["pulls"] == q.search["portfolio"]["pulls"]
