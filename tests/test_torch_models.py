"""Whole models of the port against the reference's, per arch, on the
reduced configs with the reference's parameters carried across
(``convert.lm_params``): prefill logits, the decode logits of the next
token and every leaf of the caches after prefill and after decode
(``convert.lm_cache``), the JAX side under ``jax.jit`` on the CPU.  Also
the reference's own checks mirrored on the port (prefill-then-decode
against the uncached full forward, ``tests/test_archs_smoke.py:49-91``; the
ring cache past the window, ``:94-110``), the perf-variant switches
(``cast_params_bf16``, ``moe_row_dispatch``, ``ssm_fused_coeffs``) against
the reference under the same switch, and the forward loss.

Tolerance for logits and caches: atol 0.1, rtol 0.05 (half the
reference's own bar, atol 0.2, rtol 0.1).  The port rounds every bf16
residual and activation where the reference's code does; XLA on the CPU
keeps some of those sums in fp32 inside its fusions, which moves the
logits by up to about 1 %.  fp32 state (Mamba, RG-LRU) is held at the
same bar, the top-1 tokens of the prefill logits must agree on 95 %.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch
from repro.models import build_model as ref_build_model
from repro.models import transformer as ref_tf

from repro_torch import configs, convert
from repro_torch.models import build_model
from repro_torch.models import transformer as tf

TOL = dict(atol=0.1, rtol=0.05)
B, T = 2, 12


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **TOL)


def _assert_caches_equal(got: dict, want: dict):
    assert got["step"] == want["step"]
    assert len(got["stack"]) == len(want["stack"])

    def walk(g, w, path):
        if w is None:
            assert g is None, path
        elif isinstance(w, dict):
            assert g.keys() == w.keys(), path
            for k in w:
                walk(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, int):
            assert g == w, path
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, path
            if w.dtype in (torch.int32, torch.int64):
                assert torch.equal(g, w), path
            else:
                _close(g, w, path)
    for i, (g, w) in enumerate(zip(got["stack"], want["stack"])):
        walk(g, w, f"layer {i}")


def _cfgs(arch, **switches):
    return (dataclasses.replace(get_arch(arch).reduced(), **switches),
            dataclasses.replace(configs.get_arch(arch).reduced(), **switches))


@functools.cache
def _run(arch, switches=()):
    """Both packages on the same params and tokens: prefill of T tokens
    into a cache of T + 4, then one decode step."""
    rcfg, pcfg = _cfgs(arch, **dict(switches))
    rm, pm = ref_build_model(rcfg), build_model(pcfg)
    params = rm.init(jax.random.PRNGKey(1))
    pparams = convert.lm_params(jax.tree.map(np.asarray, params), pcfg)
    rng = np.random.default_rng(sum(map(ord, arch)))
    toks = rng.integers(0, rcfg.vocab, (B, T + 1))
    rb = {"tokens": jnp.asarray(toks[:, :T]), "caches": rm.init_cache(B, T + 4)}
    pb = {"tokens": torch.as_tensor(toks[:, :T]),
          "caches": pm.init_cache(B, T + 4, "cpu")}
    if rcfg.n_memory:
        mem = rng.standard_normal((B, rcfg.n_memory, rcfg.d_model))
        rb["memory"] = jnp.asarray(mem, jnp.float32)
        pb["memory"] = torch.as_tensor(mem, dtype=torch.float32)
    r_logits, r_caches = jax.jit(rm.prefill)(params, rb)
    p_logits, p_caches = pm.prefill(pparams, pb)
    nxt = toks[:, T:]
    r_dec, r_caches2 = jax.jit(rm.decode)(params, r_caches, jnp.asarray(nxt))
    p_dec, p_caches2 = pm.decode(pparams, p_caches, torch.as_tensor(nxt))
    host = lambda c: jax.tree.map(np.asarray, c)
    return dict(
        rcfg=rcfg, pcfg=pcfg, params=params, pparams=pparams, toks=toks,
        pb=pb, r=(r_logits, host(r_caches), r_dec, host(r_caches2)),
        p=(p_logits, p_caches, p_dec, p_caches2))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_logits_and_caches(arch):
    run = _run(arch)
    r_logits, r_caches, _, _ = run["r"]
    p_logits, p_caches, _, _ = run["p"]
    assert p_logits.dtype == torch.float32
    assert tuple(p_logits.shape) == (B, T, run["pcfg"].vocab)
    _close(p_logits, r_logits, "prefill logits")
    agree = (p_logits.argmax(-1).numpy() == np.asarray(r_logits).argmax(-1))
    assert agree.mean() >= 0.95
    _assert_caches_equal(p_caches, convert.lm_cache(r_caches, run["pcfg"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_logits_and_caches(arch):
    run = _run(arch)
    _, _, r_dec, r_caches2 = run["r"]
    _, _, p_dec, p_caches2 = run["p"]
    _close(p_dec, r_dec, "decode logits")
    _assert_caches_equal(p_caches2, convert.lm_cache(r_caches2, run["pcfg"]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_from_the_reference_cache(arch):
    """The reference's caches carried across drive the port's decode to
    the reference's logits: the layouts mean the same thing."""
    run = _run(arch)
    _, r_caches, r_dec, _ = run["r"]
    pm = build_model(run["pcfg"])
    got, _ = pm.decode(run["pparams"], convert.lm_cache(r_caches, run["pcfg"]),
                       torch.as_tensor(run["toks"][:, T:]))
    _close(got, r_dec, "decode logits")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_the_full_forward(arch):
    """The reference's cache check on the port: decode after prefill
    equals the uncached forward at that position, and prefill's last
    logits the forward's on the prefix (atol 0.2, rtol 0.1, top-1 on at
    least half, ``tests/test_archs_smoke.py:86-91``)."""
    run = _run(arch)
    pcfg = run["pcfg"]
    p_logits, _, p_dec, _ = run["p"]
    mem = None
    if pcfg.n_memory:
        mem = run["pb"]["memory"].bfloat16()
        if pcfg.encoder_layers:
            mem = tf.encode_memory(run["pparams"], pcfg, mem)
    with torch.inference_mode():
        full, _, _ = tf.lm_apply(run["pparams"], pcfg,
                                 torch.as_tensor(run["toks"]), memory=mem)
    got, want = p_dec[:, 0].numpy(), full[:, T].numpy()
    np.testing.assert_allclose(got, want, atol=0.2, rtol=0.1)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.5
    np.testing.assert_allclose(p_logits[:, -1].numpy(), full[:, T - 1].numpy(),
                               atol=0.2, rtol=0.1)


def test_ring_cache_past_the_window():
    """danube reduced (window 32): a 40-token prefill into a 32-slot ring
    and six decodes past it equal the reference's, slot positions and
    all."""
    rcfg, pcfg = _cfgs("h2o-danube-3-4b")
    assert rcfg.window == 32
    rm, pm = ref_build_model(rcfg), build_model(pcfg)
    params = rm.init(jax.random.PRNGKey(0))
    pparams = convert.lm_params(jax.tree.map(np.asarray, params), pcfg)
    toks = np.random.default_rng(3).integers(1, rcfg.vocab, (1, 46))
    r_logits, rc = jax.jit(rm.prefill)(params, {
        "tokens": jnp.asarray(toks[:, :40]), "caches": rm.init_cache(1, 64)})
    p_logits, pc = pm.prefill(pparams, {"tokens": torch.as_tensor(toks[:, :40]),
                                        "caches": pm.init_cache(1, 64, "cpu")})
    _close(p_logits, r_logits)
    dec = jax.jit(rm.decode)
    for i in range(40, 46):
        r_logits, rc = dec(params, rc, jnp.asarray(toks[:, i:i + 1]))
        p_logits, pc = pm.decode(pparams, pc, torch.as_tensor(toks[:, i:i + 1]))
        _close(p_logits, r_logits)
    assert pc["step"] == int(rc["step"]) == 46
    _assert_caches_equal(pc, convert.lm_cache(jax.tree.map(np.asarray, rc),
                                              pcfg))
    assert bool(torch.isfinite(p_logits).all())


@pytest.mark.parametrize("arch,switches", [
    ("yi-6b", (("cast_params_bf16", True),)),
    ("whisper-small", (("cast_params_bf16", True),)),
    ("recurrentgemma-9b", (("cast_params_bf16", True),)),
    ("granite-moe-3b-a800m", (("moe_row_dispatch", True),)),
    ("falcon-mamba-7b", (("ssm_fused_coeffs", True), ("ssm_chunk", 4))),
], ids=lambda v: v if isinstance(v, str) else "+".join(k for k, _ in v))
def test_perf_variant_switches(arch, switches):
    run = _run(arch, switches)
    r_logits, r_caches, r_dec, _ = run["r"]
    p_logits, p_caches, p_dec, _ = run["p"]
    _close(p_logits, r_logits, "prefill logits")
    _close(p_dec, r_dec, "decode logits")
    _assert_caches_equal(p_caches, convert.lm_cache(r_caches, run["pcfg"]))
    if dict(switches).get("cast_params_bf16"):
        assert run["pparams"]["embed"].dtype == torch.bfloat16


def test_storage_dtypes():
    """Weights the forward reads only in bf16 are kept in bf16; the rest,
    ``a_log`` and ``conv_w`` under the cast included, in fp32."""
    pcfg = configs.get_arch("falcon-mamba-7b").reduced()
    params = build_model(pcfg).init(0, "cpu")
    dtypes = {n.rsplit(".", 1)[-1]: p.dtype
              for n, p in params.named_parameters()}
    assert dtypes["in_proj"] == dtypes["out_proj"] == dtypes["x_proj"] == \
        dtypes["lm_head"] == torch.bfloat16
    assert dtypes["embed"] == dtypes["dt_proj"] == dtypes["a_log"] == \
        dtypes["conv_w"] == dtypes["d_skip"] == torch.float32
    cast = dataclasses.replace(pcfg, cast_params_bf16=True)
    dtypes = {n.rsplit(".", 1)[-1]: p.dtype
              for n, p in build_model(cast).init(0, "cpu").named_parameters()}
    assert dtypes["embed"] == dtypes["dt_proj"] == torch.bfloat16
    assert dtypes["a_log"] == dtypes["conv_w"] == torch.float32


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "whisper-small"])
def test_loss_forward(arch):
    run = _run(arch)
    rcfg, pcfg = run["rcfg"], run["pcfg"]
    toks = run["toks"]
    labels = np.where(np.arange(T + 1) % 5 == 4, -1, toks[:, ::-1])
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    pbatch = {"tokens": torch.as_tensor(toks),
              "labels": torch.as_tensor(labels.copy())}
    if rcfg.n_memory:
        batch["memory"] = jnp.asarray(run["pb"]["memory"].numpy())
        pbatch["memory"] = run["pb"]["memory"]
    want, wm = jax.jit(ref_build_model(rcfg).loss)(run["params"], batch)
    got, gm = build_model(pcfg).loss(run["pparams"], pbatch)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)
    assert float(gm["tokens"]) == float(wm["tokens"])
    if pcfg.n_experts:
        np.testing.assert_allclose(float(gm["moe_aux"]), float(wm["moe_aux"]),
                                   rtol=1e-2)


def test_port_full_forward_matches_the_reference_forward():
    """``lm_apply`` without caches, the reference's uncached forward."""
    run = _run("mistral-nemo-12b")
    toks = run["toks"]
    want, _, _ = jax.jit(lambda p, t: ref_tf.lm_apply(p, run["rcfg"], t))(
        run["params"], jnp.asarray(toks))
    with torch.inference_mode():
        got, _, _ = tf.lm_apply(run["pparams"], run["pcfg"],
                                torch.as_tensor(toks))
    _close(got, want)
