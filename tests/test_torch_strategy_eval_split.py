"""CPU rehearsal of the strategy_eval kernel's dataflow.

The CUDA kernel no longer evaluates each of the 8 strategies from scratch:
it computes the per-job terms (cyc_c, cyc_u for REV = 0 and 1, the clock
in Hz) once, the terms a (candidate, operator, REV) shares once for the
four (WP, PF) strategies of that REV, takes each REV half's best strategy
(first index on ties), combines the halves so that REV = 0 wins a tie, and
sums the operators in order.  ``split_objective`` below computes the same
quantities in the same order in torch; it must equal the plain version
(``ref.job_objective_ref``) bit for bit in fp32 and fp64 -- objective,
totals and per-operator index -- on draws that cover strategy masks
(``st``, ``so`` and masks with a whole half disallowed), operators padded
with count 0, candidates where every strategy is infeasible (ties at
1e30) and ties between a REV = 0 and a REV = 1 strategy.  In fp64 it is
also held to the reference's ``cost_model.job_objective``.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.compat import enable_x64  # noqa: E402
from repro.core import cost_model as ref_cm  # noqa: E402
from repro.core import ir as ref_ir  # noqa: E402
from repro.core import macro as ref_macro  # noqa: E402
from repro.core import pruning as ref_pruning  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

INF = 1e30
SMALL = dict(mr=(1, 2, 8), mc=(1, 4), scr=(1, 4, 16), is_kb=(2, 16, 256),
             os_kb=(2, 64))


def _score(lat, en, code):
    return torch.where(code == 1, lat, torch.where(code == 2, lat * en, en))


def _rev_terms(rev, m, k, n, c, p):
    """The terms the four (WP, PF) strategies of one REV share."""
    r = {}
    r["M"] = n if rev else m
    N = m if rev else n
    dws = p["dw_w"] if rev else p["dw_in"]
    r["dwt"] = p["dw_in"] if rev else p["dw_w"]
    cyc_c, r["cyc_u"] = p["cyc_c"][rev], p["cyc_u"][rev]
    r["tK"] = torch.ceil(k / c["Kp"])
    r["tN"] = torch.ceil(N / c["Np"])
    Kpad = r["tK"] * c["Kp"]
    r["Npad"] = r["tN"] * c["Np"]
    r["planes"] = r["tK"] * r["tN"]
    r["G"] = torch.ceil(r["tK"] / c["scr"])
    r["H"] = torch.ceil(r["tN"] / c["scr"])
    r["remN"] = r["tN"] - (r["H"] - 1.0) * c["scr"]
    r["scr_n"] = torch.minimum(c["scr"], r["tN"])
    rows_res_raw = torch.floor(c["is_bits"] / (Kpad * dws))
    r["wp_feasible"] = rows_res_raw >= 1.0
    r["rows_res"] = torch.minimum(torch.clamp_min(rows_res_raw, 1.0), r["M"])
    r["B"] = torch.ceil(r["M"] / r["rows_res"])
    r["remB"] = r["M"] - (r["B"] - 1.0) * r["rows_res"]
    r["is_feasible"] = c["is_bits"] >= c["Kp"] * dws
    r["MKd"] = r["M"] * Kpad * dws
    r["fits_all_v"] = r["MKd"] <= c["is_bits"]
    r["fits_all_s"] = r["planes"] <= c["scr"]
    r["compute_cycles"] = r["M"] * r["planes"] * cyc_c
    r["macs"] = r["M"] * Kpad * r["Npad"]
    r["y_bits"] = r["M"] * r["Npad"] * p["dw_out"]
    r["os_full"] = torch.floor(c["os_bits"] / (r["scr_n"] * c["Np"]
                                               * p["dw_psum"]))
    r["os_rem"] = torch.floor(c["os_bits"] / (r["remN"] * c["Np"]
                                              * p["dw_psum"]))
    return r


def _strategy_cost(wp, pf, r, c, p):
    """What stays per (WP, PF) strategy: latency and energy."""
    Np, dw_psum = c["Np"], p["dw_psum"]
    M, tK, tN, G, H, B = r["M"], r["tK"], r["tN"], r["G"], r["H"], r["B"]
    spill = lambda work, os: torch.clamp_min(work - os, 0.0)
    one = torch.ones_like(M)
    v_refetch_ip = torch.where(r["fits_all_v"], one, H if pf else tN)
    v_bits = r["MKd"] * (one if wp else v_refetch_ip)
    s_loads = r["planes"] * (torch.where(r["fits_all_s"], one, B)
                             if wp else one)
    s_bits = s_loads * c["Kp"] * Np * r["dwt"]
    update_cycles = s_loads * r["cyc_u"]
    is_wr = v_bits
    is_rd = r["MKd"] * (H if pf else tN)
    if not pf:
        os_af = c["os_rows_af"]
        if wp:
            spill_bits = 2.0 * (G - 1.0) * Np * dw_psum * tN * (
                (B - 1.0) * spill(r["rows_res"], os_af)
                + spill(r["remB"], os_af))
        else:
            spill_bits = 2.0 * (G - 1.0) * spill(M, os_af) * Np * dw_psum * tN
    else:
        nfull = H - 1.0

        def pf_rows(work):
            return nfull * spill(work, r["os_full"]) * r["scr_n"] + \
                spill(work, r["os_rem"]) * r["remN"]
        if wp:
            spill_bits = 2.0 * (tK - 1.0) * Np * dw_psum * (
                (B - 1.0) * pf_rows(r["rows_res"]) + pf_rows(r["remB"]))
        else:
            spill_bits = 2.0 * (tK - 1.0) * Np * dw_psum * pf_rows(M)
    groups_per_col = tK if pf else G
    os_wr = M * tN * groups_per_col * Np * dw_psum
    os_rd = M * tN * (groups_per_col - 1.0) * Np * dw_psum + \
        M * r["Npad"] * dw_psum
    ema_bits = v_bits + s_bits + spill_bits + r["y_bits"]
    ema_cycles = torch.ceil(ema_bits / c["bw"])
    busy = torch.maximum(r["compute_cycles"], ema_cycles)
    latency = torch.where(c["overlap"], torch.maximum(busy, update_cycles),
                          busy + update_cycles)
    feasible = r["is_feasible"] & c["os_feasible"]
    if wp:
        feasible = feasible & r["wp_feasible"]
    e_dyn = (r["macs"] * p["mac_e_pj"]
             + s_bits * p["e_cim_update_pj_bit"]
             + (is_rd + os_rd) * p["e_sram_rd_pj_bit"]
             + (is_wr + os_wr) * p["e_sram_wr_pj_bit"]
             + ema_bits * p["e_ema_pj_bit"]) * p["sys_energy_overhead"]
    lat_s = latency / p["freq_hz"]
    e_leak = p["p_leak_mw_mm2"] * c["area"] * lat_s * 1e9
    energy = e_dyn + e_leak
    return (torch.where(feasible, latency, INF),
            torch.where(feasible, energy, INF))


def _best_of_half(rev, m, k, n, c, p, allowed, code):
    """(score, lat, en, index) of one REV half's best strategy, first
    index kept on ties; a half the mask disallows whole is skipped and
    reads as its first strategy at INFEASIBLE."""
    s0 = 4 * rev
    r = _rev_terms(rev, m, k, n, c, p)
    best = None
    for s in range(s0, s0 + 4):
        lat, en = _strategy_cost(bool(s & 2), bool(s & 1), r, c, p)
        ok = allowed[:, s, None, None] > 0
        lat = torch.where(ok, lat, INF)
        en = torch.where(ok, en, INF)
        cand = (_score(lat, en, code), lat, en, torch.full_like(lat, s))
        if best is None:
            best = cand
        else:
            take = cand[0] < best[0]
            best = tuple(torch.where(take, x, y) for x, y in zip(cand, best))
    skip = (allowed[:, s0:s0 + 4] <= 0).all(dim=1)[:, None, None]
    inf = torch.full_like(best[1], INF)
    skipped = (_score(inf, inf, code), inf, inf, torch.full_like(inf, s0))
    return tuple(torch.where(skip, y, x) for x, y in zip(best, skipped))


def _prepare(job, cand):
    """The per-job terms (once per block on the card) and the
    per-candidate terms, broadcast to [J, C, P]; the operator columns."""
    per_job = lambda v: v[:, None, None]                 # [J] -> [J, 1, 1]
    p = {f: per_job(v) for f, v in zip(job.macro._fields, job.macro)}
    p.update({f: per_job(v) for f, v in zip(job.tech._fields, job.tech)})
    # once per job (per block on the card)
    p["cyc_c"] = [torch.maximum(torch.ceil(dws * p["al"] / p["icw"]),
                                torch.ones_like(p["al"]))
                  for dws in (p["dw_in"], p["dw_w"])]
    p["cyc_u"] = [torch.maximum(torch.ceil(p["al"] * dwt / p["wuw"]),
                                torch.ones_like(p["al"]))
                  for dwt in (p["dw_w"], p["dw_in"])]
    p["freq_hz"] = p["freq_mhz"] * 1e6
    code = per_job(job.obj_code)
    # once per candidate: [J, C, 1], broadcast over the operators
    col = lambda i: cand[:, :, i, None]
    c = {"mr": col(0), "mc": col(1), "scr": col(2), "bw": col(5)}
    is_kb, os_kb = col(3), col(4)
    c["is_bits"] = is_kb * 1024.0 * 8.0
    c["os_bits"] = os_kb * 1024.0 * 8.0
    c["Kp"] = c["mr"] * p["al"]
    c["Np"] = c["mc"] * p["pc"]
    c["os_rows_af"] = torch.floor(c["os_bits"] / (c["Np"] * p["dw_psum"]))
    c["os_feasible"] = c["os_bits"] >= c["Np"] * p["dw_psum"]
    c["overlap"] = (p["update_during_compute"]
                    * (c["scr"] >= 2.0).to(cand.dtype)) != 0
    cells = p["al"] * p["pc"] * c["scr"] * p["dw_w"] * p["a_cell_um2_bit"]
    cus = p["al"] * p["pc"] * p["a_cu_um2"]
    macro_area = (cells + cus) * 1e-6 + p["a_macro_fixed_mm2"]
    sram = lambda kb: kb * 8.0 / 1024.0 * p["a_sram_mm2_per_mb"] + \
        p["a_sram_fixed_mm2"]
    c["area"] = c["mr"] * c["mc"] * macro_area + sram(is_kb) + sram(os_kb) \
        + p["a_fixed_mm2"]
    # per (candidate, operator): [J, 1, P] operators
    return p, c, code, [job.ops[:, None, :, i] for i in range(4)]


def split_objective(job, cand, penalty_scale=1e3):
    """The kernel's dataflow over ``cand`` [J, C, 6]: (objective [J, C],
    total latency, total energy, per-operator index [J, C, P] int32)."""
    p, c, code, (m, k, n, count) = _prepare(job, cand)
    half0 = _best_of_half(0, m, k, n, c, p, job.allowed, code)
    half1 = _best_of_half(1, m, k, n, c, p, job.allowed, code)
    take1 = half1[0] < half0[0]            # REV = 0 wins ties
    _, lat, en, idx = (torch.where(take1, y, x) for x, y in zip(half0, half1))
    tot_lat = torch.zeros_like(lat[..., 0])
    tot_en = torch.zeros_like(en[..., 0])
    for q in range(lat.shape[-1]):          # operators in order
        tot_lat = tot_lat + lat[..., q] * count[..., q]
        tot_en = tot_en + en[..., q] * count[..., q]
    val = _score(tot_lat, tot_en, code[..., 0])
    area = c["area"][..., 0]
    budget = job.area_budget[:, None]
    excess = torch.maximum(area - budget, torch.zeros_like(area)) / budget
    val = val * (1.0 + penalty_scale * excess)
    bw_ok = (job.macro.icw[:, None] * c["mr"][..., 0] >= c["bw"][..., 0]) & (
        job.macro.wuw[:, None] * c["mr"][..., 0] * c["mc"][..., 0]
        >= c["bw"][..., 0])
    return (torch.where(bw_ok, val, INF), tot_lat, tot_en,
            idx.to(torch.int32))


# masks: st, so, REV = 1 only, REV = 0 PF only, and a scattered one
MASKS = {
    "st": ref_cm.strategy_mask("st"),
    "so": ref_cm.strategy_mask("so"),
    "rev1": np.array([0, 0, 0, 0, 1, 1, 1, 1], np.float64),
    "rev0-pf": np.array([0, 1, 0, 1, 0, 0, 0, 0], np.float64),
    "scattered": np.array([0, 1, 1, 0, 1, 0, 0, 1], np.float64),
}


def _ref_jobs(seed: int, ops_pad: int = 16):
    """Stacked reference JobParams (numpy leaves): varied macros,
    objectives, masks and budgets, operators padded to ``ops_pad`` with
    count-0 rows, and one job built for REV ties (a macro whose input
    and weight widths agree, square operators)."""
    from repro.configs import get_arch
    rng = np.random.default_rng(seed)
    wls = [ref_ir.bert_large_workload(), get_arch("yi-6b").workload(),
           get_arch("whisper-small").workload()]
    mnames = ["vanilla-dcim", "tpdcim-macro", "lcc-cim", "trancim-macro"]
    rows = []
    for jx, mask in enumerate(MASKS.values()):
        m = ref_macro.MACRO_LIBRARY[mnames[jx % len(mnames)]]
        ops = wls[jx % len(wls)].merged().as_arrays(pad_to=ops_pad)
        rows.append((ops, ref_cm.macro_params(m), mask, jx % 3,
                     float(rng.uniform(1.0, 8.0))))
    # REV ties: dw_w := dw_in and m == n, so the two halves cost the same
    mp = ref_cm.macro_params(ref_macro.MACRO_LIBRARY["vanilla-dcim"])
    mp = mp._replace(dw_w=mp.dw_in)
    square = np.array([[256, 1024, 256, 3, 0], [64, 64, 64, 1, 0],
                       [1000, 300, 1000, 2, 0]], np.float64)
    pad = np.tile([1.0, 1.0, 1.0, 0.0, 0.0], (ops_pad - 3, 1))
    square = np.concatenate([square, pad])
    for code in (0, 1, 2):
        rows.append((square, mp, MASKS["st"], code, 5.0))
    out = [ref_cm.JobParams(
        ops=np.asarray(ops, np.float64),
        macro=ref_cm.MacroParams(*[np.float64(v) for v in mparams]),
        tech=ref_cm.TechParams(*[np.float64(v)
                                 for v in ref_cm.tech_params()]),
        allowed=np.asarray(mask, np.float64),
        obj_code=np.int32(code), area_budget=np.float64(budget),
        bw=np.float64(256)) for ops, mparams, mask, code, budget in rows]
    return jax.tree.map(lambda *xs: np.stack(xs), *out)


def _candidates(n_jobs: int, seed: int) -> np.ndarray:
    """[J, C, 6]: a small raw grid, random rows off it, and rows where no
    strategy fits (an output SRAM below one psum row, or an input SRAM
    below one macro tile)."""
    rng = np.random.default_rng(seed)
    grid = ref_pruning.candidates_with_bw(ref_pruning.enumerate_space(
        ref_pruning.DesignSpace(**SMALL)), 256)
    drawn = np.stack([rng.choice(ax, 64).astype(np.float64) for ax in (
        ref_pruning.MR_CHOICES, ref_pruning.MC_CHOICES,
        ref_pruning.SCR_CHOICES, ref_pruning.IS_KB_CHOICES,
        ref_pruning.OS_KB_CHOICES, (64, 256, 1024))], axis=1)
    dead = np.array([[1, 64, 4, 64, 0.25, 256], [16, 1, 4, 0.0625, 64, 64],
                     [16, 64, 1, 0.0625, 0.25, 256]], np.float64)
    rows = np.concatenate([grid, drawn, dead])
    return np.repeat(rows[None], n_jobs, axis=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_dataflow_equals_plain_bit_for_bit(dtype, seed):
    jobs = _ref_jobs(seed)
    tdt = getattr(torch, dtype)
    job = convert.job_params(jobs, tdt)
    cand = torch.as_tensor(_candidates(len(jobs.bw), seed), dtype=tdt)
    got = split_objective(job, cand)
    want = ref.job_objective_ref(job, cand, 1e3, totals=True)
    for name, g, w in zip(("obj", "lat", "en", "idx"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    # the draws cover what the kernel's branches decide
    idx, real = got[3], job.ops[..., 3] > 0
    assert (~real).any()                           # padded operators
    # the last rows fit no strategy: every index ties at 1e30, first kept
    assert (got[1][:, -3:] >= 1e30).all() and (idx[:, -3:] == 0).all()
    # a half disallowed whole: only REV = 1 where anything fits
    j = list(MASKS).index("rev1")
    fits = got[1][j] < 1e30
    assert fits.any() and (idx[j][fits][:, real[j]] >= 4).all()
    j = list(MASKS).index("so")
    assert set(idx[j].unique().tolist()) <= {0, 4}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rev_ties_go_to_rev0(dtype):
    """On the tie jobs the two halves' best scores are equal wherever a
    strategy fits, and the index is REV = 0's."""
    jobs = _ref_jobs(0)
    tdt = getattr(torch, dtype)
    job = convert.job_params(jobs, tdt)
    cand = torch.as_tensor(_candidates(len(jobs.bw), 0), dtype=tdt)
    ties = slice(len(MASKS), None)
    p, c, code, (m, k, n, _) = _prepare(job, cand)
    half0 = _best_of_half(0, m, k, n, c, p, job.allowed, code)
    half1 = _best_of_half(1, m, k, n, c, p, job.allowed, code)
    fits = half0[0][ties, :, :3] < 1e30
    assert fits.any()
    assert torch.equal(half0[0][ties, :, :3], half1[0][ties, :, :3])
    got = split_objective(job, cand)
    want = ref.job_objective_ref(job, cand, 1e3, totals=True)
    assert torch.equal(got[3], want[3])
    assert (got[3][ties, :, :3][fits] < 4).all()


def test_split_dataflow_matches_reference_job_objective_fp64():
    jobs = _ref_jobs(2)
    cands = _candidates(len(jobs.bw), 2)
    with enable_x64(True):
        fn = jax.vmap(lambda job, block: jax.vmap(
            lambda row: ref_cm.job_objective(job, row))(block))
        want = np.asarray(fn(jax.tree.map(jnp.asarray, jobs),
                             jnp.asarray(cands)))
    got = split_objective(convert.job_params(jobs, torch.float64),
                          torch.as_tensor(cands, dtype=torch.float64))[0]
    assert (want >= ref_cm.INFEASIBLE).any() and (want < 1e20).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
