"""A CPU rehearsal of the chunk-parallel ``selective_scan_bwd`` kernel.

``chunk_scan_bwd`` (``tests/torch_kernel_models.py``) repeats the order
of ``csrc/selective_scan_bwd.cu``: per chunk of L steps the local forward
state (zero entry state), the local reverse state (zero incoming g) and
the sum of dt; a walk over the chunks from h0 forwards and from dh_last
backwards, each chunk mapping x to exp(a sum dt) x + its local state; then
every chunk recomputes its h_t from its entry state and runs the reverse
recurrence from its incoming g; da summed over b, then the chunks.  It is
held against autograd of the plain scan (``ref.selective_scan_bwd_ref``)
and against ``jax.value_and_grad`` of the reference's jnp scan
(``repro.kernels.ref.selective_scan_ref``), each output within
chip_smoke.py's bar for the kernel (``BWD_TOL``: 1e-4 of the output's
largest value), for S in {1, 4, 8, 16} (and 3, a group with idle lanes),
T not a multiple of L, and L of 1, 8, the kernel's 32 and 64.
"""
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import selective_scan_bwd as ssb

from torch_kernel_models import chunk_scan_bwd

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

#: the kernel's chunk length (``L`` in csrc/selective_scan_bwd.cu)
KERNEL_CHUNK = 32


def _inputs(b, t, i, s, seed):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return [np.asarray(x, np.float32) for x in (
        n((b, t, i)), np.abs(n((b, t, i))) * 0.1, n((b, t, s)), n((b, t, s)),
        -np.abs(n((i, s))), n((b, i, s)), n((b, t, i)), n((b, i, s)))]


def test_model_chunk_is_the_kernels():
    src = ssb.SOURCE.read_text()
    assert re.search(r"constexpr int L = (\d+);", src).group(1) == \
        str(KERNEL_CHUNK)


@pytest.mark.parametrize("chunk", [1, 8, KERNEL_CHUNK, 64])
@pytest.mark.parametrize("s", [1, 4, 8, 16, 3])
@pytest.mark.parametrize("b,t,i", [(2, 45, 6), (1, 100, 5)])
def test_model_against_autograd_of_the_plain_scan(b, t, i, s, chunk):
    args = [torch.as_tensor(x) for x in _inputs(b, t, i, s, b + t + i + s)]
    got = chunk_scan_bwd(*args, chunk=chunk)
    want = ref.selective_scan_bwd_ref(*args)
    chip_smoke.check_bwd(f"chunk model L={chunk}", "selective_scan_bwd", got,
                         want)


@pytest.mark.parametrize("chunk", [8, KERNEL_CHUNK])
@pytest.mark.parametrize("s", [1, 4, 8, 16])
def test_model_against_jax_value_and_grad(s, chunk):
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    xs = _inputs(2, 77, 6, s, 7 * s + chunk)
    dy, dh_last = jnp.asarray(xs[6]), jnp.asarray(xs[7])

    def loss(xi, dt, bm, cm, a, h0):
        y, h_last = jref.selective_scan_ref(xi, dt, bm, cm, a, h0)
        return jnp.sum(y * dy) + jnp.sum(h_last * dh_last)
    _, grads = jax.value_and_grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(x) for x in xs[:6]))
    want = tuple(torch.as_tensor(np.array(g, np.float32)) for g in grads)
    got = chunk_scan_bwd(*(torch.as_tensor(x) for x in xs), chunk=chunk)
    chip_smoke.check_bwd(f"chunk model L={chunk} against JAX",
                         "selective_scan_bwd", got, want)
