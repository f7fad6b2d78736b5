"""The port's instruction-flow compiler held against the reference: the
per-set schedules equal the reference's array for array (its 40 random
cases, seed 123, and bert-large's merged operators at small configs, all 8
strategies), the port's fp64 closed-form ``matmul_cost`` equals every
schedule's sums integer for integer, the address-level traces equal the
reference's instruction for instruction, and each strategy's replay
computes ``x @ w`` -- the port's own trace and the reference's, converted."""
import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core as ref  # noqa: E402
from repro.core import compiler as ref_compiler  # noqa: E402

import repro_torch.core as port  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compiler  # noqa: E402

#: schedule sums against the closed form's fields (tests/test_cost_vs_compiler.py)
FIELDS = dict(
    v_bits="v_ema_bits", s_bits="s_ema_bits", spill_bits="spill_ema_bits",
    y_bits="y_ema_bits", is_rd_bits="is_rd_bits", is_wr_bits="is_wr_bits",
    os_rd_bits="os_rd_bits", os_wr_bits="os_wr_bits",
    compute_cycles="compute_cycles", update_cycles="update_cycles",
)
#: bert-large's merged operators are compiled at these small configs
BERT_CONFIGS = ((3, 2, 16, 128, 64), (2, 2, 8, 64, 32), (1, 2, 4, 32, 16))
STRATEGY_IDS = [str(s) for s in ref.ALL_STRATEGIES]


def _random_cases(n_cases, seed):
    """The reference's cases (tests/test_cost_vs_compiler.py)."""
    rng = np.random.default_rng(seed)
    macros = [ref.get_macro(x) for x in
              ("vanilla-dcim", "lcc-cim", "trancim-macro", "fpcim")]
    for i in range(n_cases):
        yield (
            macros[i % len(macros)],
            ref.AcceleratorConfig(
                mr=int(rng.integers(1, 4)), mc=int(rng.integers(1, 4)),
                scr=int(2 ** rng.integers(0, 6)),
                is_kb=int(2 ** rng.integers(0, 8)),
                os_kb=int(2 ** rng.integers(0, 7)), bw=256),
            int(rng.integers(1, 80)), int(rng.integers(1, 600)),
            int(rng.integers(1, 500)),
        )


def _bert_cases():
    macro = ref.get_macro("vanilla-dcim")
    for cfg in BERT_CONFIGS:
        for op in ref.bert_large_workload().merged().ops:
            yield macro, ref.AcceleratorConfig(*cfg), op.m, op.k, op.n


def _port(macro, cfg, s_idx):
    return (convert.macro_spec(macro), convert.accelerator_config(cfg),
            port.ALL_STRATEGIES[s_idx])


def _closed_form_f64(macro, cfg, m, k, n, s):
    return port.matmul_cost(
        m, k, n, float(s.spatial == "R"), float(s.temporal == "WP"),
        float(s.tiling == "PF"), cfg.mr, cfg.mc, cfg.scr, cfg.is_kb,
        cfg.os_kb, cfg.bw, 1.0, macro, dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("s_idx", range(8), ids=STRATEGY_IDS)
@pytest.mark.parametrize("cases", ["random", "bert-large"])
def test_schedule_equals_reference_and_closed_form(cases, s_idx):
    """Record arrays equal the reference's; the port's fp64 closed form
    equals the schedule's sums in the ten fields, integer for integer."""
    rs = ref.ALL_STRATEGIES[s_idx]
    gen = _random_cases(40, seed=123) if cases == "random" else \
        _bert_cases()
    checked = 0
    for macro, cfg, m, k, n in gen:
        pmacro, pcfg, ps = _port(macro, cfg, s_idx)
        feasible = ref.strategy_feasible(macro, cfg, m, k, n, rs)
        assert port.strategy_feasible(pmacro, pcfg, m, k, n, ps) == feasible
        if not feasible:
            with pytest.raises(ValueError, match="infeasible"):
                port.compile_schedule(pmacro, pcfg, m, k, n, ps)
            continue
        want = ref.compile_schedule(macro, cfg, m, k, n, rs)
        got = port.compile_schedule(pmacro, pcfg, m, k, n, ps)
        assert list(got) == list(want)
        assert compiler.schedule_sets(pmacro, pcfg, m, k, n, ps) == \
            len(want["planes"])
        for f in want:
            assert got[f].dtype == want[f].dtype == np.int64
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        tot = port.schedule_totals(got)
        assert tot == ref.schedule_totals(want)
        cb = _closed_form_f64(pmacro, pcfg, m, k, n, ps)
        for sf, cf in FIELDS.items():
            assert tot[sf] == float(getattr(cb, cf)), (
                f"{sf}: {ps} op={(m, k, n)} cfg={pcfg.as_tuple()} "
                f"macro={pmacro.name}")
        checked += 1
    assert checked >= (8 if cases == "random" else 10)


def test_closed_form_checks_over_150_schedules():
    """As tests/test_cost_vs_compiler.py: more than 150 (case, strategy)
    pairs are feasible and compared."""
    n = sum(port.strategy_feasible(*_port(macro, cfg, i)[:2], m, k, n_,
                                   port.ALL_STRATEGIES[i])
            for macro, cfg, m, k, n_ in _random_cases(40, seed=123)
            for i in range(8))
    assert n > 150


TRACE_CASES = [
    (ref.AcceleratorConfig(2, 2, 4, 8, 2), (37, 200, 150)),
    (ref.AcceleratorConfig(1, 1, 2, 4, 1), (9, 70, 40)),
    (ref.AcceleratorConfig(3, 2, 16, 64, 8), (21, 500, 120)),
]


@pytest.mark.parametrize("s_idx", range(8), ids=STRATEGY_IDS)
def test_trace_equals_reference_and_replays_matmul(s_idx):
    """The trace equals the reference's instruction for instruction; the
    port's replay of it, and of the reference's trace converted, computes
    ``x @ w`` at rtol 1e-12."""
    rng = np.random.default_rng(7)
    macro = ref.get_macro("vanilla-dcim")
    rs = ref.ALL_STRATEGIES[s_idx]
    replayed = 0
    for cfg, (m, k, n) in TRACE_CASES:
        pmacro, pcfg, ps = _port(macro, cfg, s_idx)
        if not ref.strategy_feasible(macro, cfg, m, k, n, rs):
            continue
        x = rng.integers(-4, 4, (m, k)).astype(np.float64)
        w = rng.integers(-4, 4, (k, n)).astype(np.float64)
        want = ref.compile_trace(macro, cfg, m, k, n, rs)
        got = port.compile_trace(pmacro, pcfg, m, k, n, ps)
        assert got == [convert.instr(i) for i in want]
        for trace in (got, [convert.instr(i) for i in want]):
            y = port.replay_trace(trace, x, w, pmacro, pcfg, ps)
            np.testing.assert_allclose(y, x @ w, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(
            port.replay_trace(got, x, w, pmacro, pcfg, ps),
            ref.replay_trace(want, x, w, macro, cfg, rs))
        replayed += 1
    assert replayed >= 1


def test_replay_catches_a_broken_flow():
    """Dropping the trace's stores or evicting too few planes breaks an
    invariant, as in the reference."""
    macro = port.get_macro("vanilla-dcim")
    cfg = port.AcceleratorConfig(2, 2, 4, 8, 2)
    s = port.ALL_STRATEGIES[0]
    x = np.ones((37, 200))
    w = np.ones((200, 150))
    tr = port.compile_trace(macro, cfg, 37, 200, 150, s)
    with pytest.raises(AssertionError, match="partial sums"):
        port.replay_trace([i for i in tr if i.op != "STORE_Y"], x, w, macro,
                          cfg, s)
    with pytest.raises(AssertionError, match="capacity"):
        port.replay_trace([i for i in tr if i.op != "EVICT_S"], x, w, macro,
                          cfg, s)
    with pytest.raises(ValueError):
        port.replay_trace(tr, x, w[:-1], macro, cfg, s)


def test_max_sets_raises_like_the_reference():
    """A schedule over ``MAX_SETS`` sets is refused, not truncated."""
    assert compiler.MAX_SETS == ref_compiler.MAX_SETS == 2_000_000
    rm = ref.get_macro("vanilla-dcim")
    rcfg = ref.AcceleratorConfig(1, 1, 16, 1, 1)
    # NR-WP-AF: one resident row a batch (16 k-tiles fill the 1 KB IS), so
    # 2000 row batches x 1001 n-tiles = 2,002,000 sets
    args = (2000, 1024, 8008)
    s_idx = 2
    assert str(ref.ALL_STRATEGIES[s_idx]) == "NR-WP-AF"
    with pytest.raises(ValueError, match="schedule too large"):
        ref.compile_schedule(rm, rcfg, *args, ref.ALL_STRATEGIES[s_idx])
    pmacro, pcfg, ps = _port(rm, rcfg, s_idx)
    assert compiler.schedule_sets(pmacro, pcfg, *args, ps) == 2_002_000
    with pytest.raises(ValueError, match="schedule too large"):
        port.compile_schedule(pmacro, pcfg, *args, ps)


def test_geometry_equals_reference():
    for macro, cfg, m, k, n in _random_cases(40, seed=5):
        for i, rs in enumerate(ref.ALL_STRATEGIES):
            pmacro, pcfg, ps = _port(macro, cfg, i)
            want = ref_compiler.make_geometry(macro, cfg, m, k, n, rs)
            got = compiler.make_geometry(pmacro, pcfg, m, k, n, ps)
            assert got.__dict__ == want.__dict__
            assert got.os_rows_pf(3) == want.os_rows_pf(3)
