"""The port's cycle simulator (the reference's scan in closed form) held
against the reference: exact in float64 against its x64 scan, within rtol
1e-6 in float32, the sandwich bounds, overlap never slower, the
utilisation fields, and the closed form against a plain per-set loop of
the recurrence on random schedules that include zero-cycle sets."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
from repro.compat import enable_x64  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch import convert  # noqa: E402

CPU64 = dict(device="cpu", dtype=torch.float64)


def _cases(seed, n=12):
    """(reference macro, config, op) triples with schedules of 1 to a few
    thousand sets, on two macros (one can update while it computes)."""
    rng = np.random.default_rng(seed)
    macros = [ref.get_macro("vanilla-dcim"), ref.get_macro("lcc-cim")]
    for i in range(n):
        cfg = ref.AcceleratorConfig(
            int(rng.integers(1, 4)), int(rng.integers(1, 4)),
            int(2 ** rng.integers(0, 5)), int(2 ** rng.integers(1, 7)),
            int(2 ** rng.integers(0, 6)), bw=256)
        yield macros[i % 2], cfg, (int(rng.integers(4, 64)),
                                   int(rng.integers(16, 400)),
                                   int(rng.integers(16, 300)))


def _schedules(seed):
    for macro, cfg, (m, k, n) in _cases(seed):
        for s in ref.ALL_STRATEGIES:
            if ref.strategy_feasible(macro, cfg, m, k, n, s):
                yield cfg, ref.compile_schedule(macro, cfg, m, k, n, s)


def _loop(rec, bw, overlap):
    """The reference's recurrence, one set at a time, in Python floats."""
    e = np.ceil((rec["v_bits"] + rec["s_bits"] + rec["spill_bits"]
                 + rec["y_bits"]) / bw)
    bus = upd = cmp_ = 0.0
    for e_i, u_i, c_i in zip(e, rec["update_cycles"], rec["compute_cycles"]):
        bus += float(e_i)
        upd = max(upd if overlap else cmp_, bus) + float(u_i)
        cmp_ = max(cmp_, upd) + float(c_i)
    return cmp_


@pytest.mark.parametrize("overlap", [True, False])
def test_fp64_equals_reference_x64_exactly(overlap):
    n = 0
    for cfg, rec in _schedules(seed=3):
        with enable_x64(True):
            want = ref.simulate_schedule(rec, cfg.bw, overlap)
        got = port.simulate_schedule(rec, cfg.bw, overlap, **CPU64)
        assert got == want
        n += 1
    assert n >= 40


@pytest.mark.parametrize("overlap", [True, False])
def test_fp32_within_rtol_of_reference(overlap):
    """The reference adds set by set in float32; the port's prefix sums
    round alike while the sums stay below 2^24 cycles."""
    n = 0
    for cfg, rec in _schedules(seed=4):
        want = ref.simulate_schedule(rec, cfg.bw, overlap)
        assert want["latency_cycles"] < 2 ** 24
        got = port.simulate_schedule(rec, cfg.bw, overlap, device="cpu")
        assert got["n_sets"] == want["n_sets"]
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0,
                                       err_msg=k)
        n += 1
    assert n >= 40


def test_sandwich_bounds():
    """tests/test_simulator.py's sandwich on the port: the simulation lies
    inside the analytic bounds, and so does the fp64 closed form."""
    macro = port.get_macro("vanilla-dcim")
    rng = np.random.default_rng(3)
    n_checked = 0
    for _ in range(10):
        cfg = port.AcceleratorConfig(
            int(rng.integers(1, 4)), int(rng.integers(1, 4)),
            int(2 ** rng.integers(0, 5)), int(2 ** rng.integers(1, 7)),
            int(2 ** rng.integers(0, 6)), bw=256)
        m, k, n = (int(rng.integers(4, 64)), int(rng.integers(16, 400)),
                   int(rng.integers(16, 300)))
        for s in port.ALL_STRATEGIES[:4]:
            if not port.strategy_feasible(macro, cfg, m, k, n, s):
                continue
            rec = port.compile_schedule(macro, cfg, m, k, n, s)
            lb, ub = port.analytic_latency_bounds(rec, cfg.bw)
            for overlap in (True, False):
                lat = port.simulate_schedule(rec, cfg.bw, overlap,
                                             **CPU64)["latency_cycles"]
                assert lb <= lat <= ub, (s, cfg.as_tuple(), overlap)
            cb = port.matmul_cost(
                m, k, n, float(s.spatial == "R"), float(s.temporal == "WP"),
                float(s.tiling == "PF"), cfg.mr, cfg.mc, cfg.scr, cfg.is_kb,
                cfg.os_kb, cfg.bw, 1.0, macro, dtype=torch.float64,
                device="cpu")
            assert float(cb.latency_cycles) <= ub + len(rec["planes"])
            n_checked += 1
    assert n_checked >= 15


def test_overlap_never_slower_and_utilisation_fields():
    macro = port.get_macro("vanilla-dcim")
    cfg = port.AcceleratorConfig(2, 2, 4, 16, 8)
    rec = port.compile_schedule(macro, cfg, 40, 300, 200,
                                port.ALL_STRATEGIES[0])
    with_ov = port.simulate_schedule(rec, cfg.bw, True, **CPU64)
    without = port.simulate_schedule(rec, cfg.bw, False, **CPU64)
    assert with_ov["latency_cycles"] <= without["latency_cycles"]
    assert 0 < with_ov["compute_utilization"] <= 1.0
    assert 0 < with_ov["bus_utilization"] <= 1.0
    assert with_ov["n_sets"] == len(rec["planes"])


@pytest.mark.parametrize("seed", range(4))
def test_closed_form_equals_per_set_loop(seed):
    """Random schedules, a third of each resource's sets at zero cycles
    (and some sets with no work at all), 1 to 400 sets."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 400))
        rec = {f: np.zeros(n, np.int64) for f in (
            "v_bits", "s_bits", "spill_bits", "y_bits", "compute_cycles",
            "update_cycles")}
        for f in rec:
            vals = rng.integers(0, 5000, n)
            rec[f] = np.where(rng.random(n) < 1 / 3, 0, vals).astype(np.int64)
        idle = rng.random(n) < 0.1
        for f in rec:
            rec[f][idle] = 0
        for overlap in (True, False):
            got = port.simulate_schedule(rec, 256, overlap, **CPU64)
            assert got["latency_cycles"] == _loop(rec, 256, overlap)
            lb, ub = port.analytic_latency_bounds(rec, 256)
            assert lb <= got["latency_cycles"] <= ub


def test_empty_schedule_and_bounds_equal_reference():
    rec = {f: np.zeros(0, np.int64) for f in (
        "v_bits", "s_bits", "spill_bits", "y_bits", "compute_cycles",
        "update_cycles")}
    assert port.simulate_schedule(rec, 256, True,
                                  **CPU64)["latency_cycles"] == 0.0
    for cfg, r in _schedules(seed=6):
        assert port.analytic_latency_bounds(r, cfg.bw) == \
            ref.analytic_latency_bounds(r, cfg.bw)


def test_runs_on_the_card_unless_asked_for_the_cpu():
    """Without ``device`` the simulator runs on the card; on a host
    without one it raises rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; tests/test_torch_kernels_cuda.py "
                    "holds the card against the CPU")
    rec = port.compile_schedule(
        convert.macro_spec(ref.get_macro("vanilla-dcim")),
        port.AcceleratorConfig(2, 2, 4, 16, 8), 40, 300, 200,
        port.ALL_STRATEGIES[0])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port.simulate_schedule(rec, 256, True)
