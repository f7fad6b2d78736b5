"""CPU rehearsal of the selective_scan kernel's order of operations.

On the card a group of G lanes takes one (batch row, channel), G = S
rounded up to a power of two: lane s holds state s and its product
h[s] * C[t, s] (0 on a lane past S), and y_t is lane 0's butterfly over
the group (it adds the partial of the lane G/2 away, then G/4, ..., 1).
Time runs in order, chunk after chunk, with no carry between chunks other
than h itself, so the chunk length changes nothing.  ``group_scan`` is that
order in torch (fp32, each product and sum rounded on its own; the card
may fuse a product into an add, which moves the last bit).  It is held to
the plain version and to the reference's Pallas kernel in interpret mode
at the card tolerance (atol 1e-3, rtol 0), and over one long sequence
(T = 2048, S = 16) against the plain version.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402

from repro_torch.kernels import ref  # noqa: E402

from torch_kernel_models import group_lanes, group_scan  # noqa: E402

ATOL = 1e-3          # chip_smoke.py's fp32 scan tolerance (rtol 0)


def _inputs(rng, shape, h0_zero=False):
    b, t, i, s = shape
    xs = [rng.standard_normal((b, t, i)),
          np.abs(rng.standard_normal((b, t, i))) * 0.1,
          rng.standard_normal((b, t, s)), rng.standard_normal((b, t, s)),
          -np.abs(rng.standard_normal((i, s))),
          np.zeros((b, i, s)) if h0_zero else rng.standard_normal((b, i, s))]
    return [np.asarray(x, np.float32) for x in xs]


def _max_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("shape", [(1, 64, 32, 8), (2, 100, 48, 16),
                                   (1, 33, 17, 4), (2, 40, 24, 1),
                                   (1, 50, 20, 3)])
def test_group_order_matches_plain_and_reference(shape):
    xs = _inputs(np.random.default_rng(sum(shape)), shape)
    y, hl = group_scan(*[torch.as_tensor(x) for x in xs])
    ry, rh = ref.selective_scan_ref(*[torch.as_tensor(x) for x in xs])
    py, ph = ref_ops.selective_scan(*[jnp.asarray(x) for x in xs], ct=16,
                                    ci=16, interpret=True)
    for want_y, want_h in ((ry.numpy(), rh.numpy()), (py, ph)):
        assert _max_err(y.numpy(), want_y) <= ATOL
        assert _max_err(hl.numpy(), want_h) <= ATOL


def test_long_sequence_stays_inside_card_tolerance():
    """falcon-mamba-7b's sequence length and state width over a few
    channels: the butterfly's rounding does not build up over T."""
    xs = [torch.as_tensor(x) for x in _inputs(np.random.default_rng(7),
                                              (1, 2048, 6, 16),
                                              h0_zero=True)]
    y, hl = group_scan(*xs)
    ry, rh = ref.selective_scan_ref(*xs)
    assert bool(torch.isfinite(y).all())
    err = max(_max_err(y.numpy(), ry.numpy()), _max_err(hl.numpy(),
                                                        rh.numpy()))
    assert err <= ATOL / 10, err


def test_group_lanes():
    assert [group_lanes(s) for s in (1, 2, 3, 4, 5, 8, 9, 16)] == \
        [1, 2, 4, 4, 8, 8, 16, 16]
