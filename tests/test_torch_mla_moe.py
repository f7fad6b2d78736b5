"""DeepSeek-V2-Lite's blocks in the port (``mla_dense`` / ``mla_moe``:
latent attention with YaRN rope, one chip's share of a routed MoE layer
with shared experts, dropless) against the benchmark's plain fp32
reference (``perfbench/reference/blocks/mla_*.py``, which imports nothing
of the port), at a small size on the CPU from the benchmark's seeded
weights: the loss and every gradient, the YaRN frequencies against their
formula, the shares of an expert-parallel layer summing to the whole
layer, every routed pair computed however unevenly the tokens fall; and
the configuration's parameter counts, operator mix and spans.

The port's compute type is set to fp32 (``COMPUTE_DTYPE`` in each model
module), so both sides compute the same function in fp32 and differ only
in the order of their sums.
"""
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import weights  # noqa: E402
from perfbench.drivers.train import arch_config  # noqa: E402
from perfbench.reference import common  # noqa: E402
from perfbench.reference.blocks import mla_dense, mla_moe  # noqa: E402
from perfbench.stream import ZipfStream  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.models import build_model, mla, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.obs.trace import tracer  # noqa: E402

SEED = 2 ** 31 + 29
#: the benchmark's configuration, every width small; router over 16
#: experts, 4 held from the fifth on; 3 layers (the dense one, two MoE)
SMALL = dict(n_layers=3, pattern=["mla_dense", "mla_moe", "mla_moe"],
             d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
             kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, d_ff=32, dense_d_ff=96, shared_d_ff=64,
             router_experts=16, n_experts=4, expert_offset=4, moe_top_k=3,
             vocab=512)
SEQ, ROWS = 32, 2


def small_config(**over) -> dict:
    cfg = json.loads((ROOT / "perfbench" / "configs" /
                      "deepseek-v2-lite.json").read_text())
    cfg.update(SMALL, **over)
    return cfg


@pytest.fixture
def fp32_port(monkeypatch):
    from repro_torch.models import layers, model, ssm
    for mod in (layers, model, moe, ssm, tf, mla):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def seeded(cfg: dict):
    """(leaves, the port's model and parameters, the reference's
    parameters) from the benchmark's weights for ``SEED``."""
    from repro_torch.models.transformer import ParamTree

    leaves = weights.layout(cfg)
    vals = weights.make(leaves, SEED, "cpu")
    params = ParamTree(weights.tree(leaves, [v.clone() for v in vals]),
                       trainable=True)
    ref = {leaf.name: v.clone().requires_grad_() for leaf, v in
           zip(leaves, vals)}
    return leaves, build_model(arch_config(cfg)), params, ref


def test_trainable_tree_is_the_benchmark_layout():
    cfg = small_config()
    model = build_model(arch_config(cfg))
    names = [(n, tuple(p.shape)) for n, p in
             model.abstract_params(trainable=True).named_parameters()]
    assert names == [(leaf.name, leaf.shape) for leaf in weights.layout(cfg)]
    # the decay rule the reference states is the port's
    ndims = model.reference_ndims(model.abstract_params(trainable=True))
    assert [common.decayed(leaf.name, len(leaf.shape))
            for leaf in weights.layout(cfg)] == [nd >= 2 for nd in ndims]


def test_loss_and_gradients(fp32_port):
    cfg = small_config()
    leaves, model, params, ref = seeded(cfg)
    batch = ZipfStream(SEED, SEQ, ROWS, cfg["vocab"]).global_batch_at(0)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = model.loss(params, batch)
    # no balance loss in this configuration: the loss is the LM loss and
    # the z-loss, as the reference's
    assert float(loss.detach()) == \
        float((metrics["ce"] + metrics["z_loss"]).detach())
    grads = torch.autograd.grad(loss, list(params.parameters()))
    ref_loss = common.loss_and_grads(ref, cfg, batch,
                                     common.Precision("fp32"))
    # fp32 on both sides; only the order of the sums differs
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    for leaf, g in zip(leaves, grads):
        want = ref[leaf.name].grad
        # each leaf's gradient to 1e-4 of its norm: sums over the batch,
        # the heads and the routed pairs taken in other orders
        assert float(torch.linalg.vector_norm(g - want)) <= \
            1e-4 * float(torch.linalg.vector_norm(want)) + 1e-10, leaf.name
        assert float(torch.linalg.vector_norm(want)) > 0, leaf.name


def _formula_inv_freq(dr, theta, s, length, beta_fast, beta_slow):
    """DeepSeek-V2's YaRN frequencies written out in numpy fp64."""
    i = np.arange(dr // 2, dtype=np.float64)
    f = theta ** (-2 * i / dr)
    low = math.floor(dr * math.log(length / (beta_fast * 2 * math.pi))
                     / (2 * math.log(theta)))
    high = math.ceil(dr * math.log(length / (beta_slow * 2 * math.pi))
                     / (2 * math.log(theta)))
    low, high = max(low, 0), min(high, dr - 1)
    r = np.clip((i - low) / (high - low), 0, 1)
    return f / s * r + f * (1 - r), (low, high)


@pytest.mark.parametrize("dr", [64, 8])
def test_yarn_frequencies(dr):
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"),
                              qk_rope_head_dim=dr)
    want, (low, high) = _formula_inv_freq(dr, 1e4, 40, 4096, 32, 1)
    if dr == 64:
        assert (low, high) == (10, 23)
    got = mla.yarn_inv_freq(cfg)
    assert got.dtype == torch.float32 and got.shape == (dr // 2,)
    # fp64 formula, rounded once to fp32
    np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                               rtol=0, atol=0)
    ref = mla_dense.inv_freq(small_config(qk_rope_head_dim=dr))
    assert torch.equal(ref, got)
    # the first pairs turn as trained, the last at 1/40 of their speed
    assert float(got[0]) == 1.0
    assert float(got[-1]) == pytest.approx(want[-1], rel=1e-6)
    assert want[-1] == pytest.approx(1e4 ** (-(dr - 2) / dr) / 40)


def test_attention_scale():
    cfg = get_arch("deepseek-v2-lite")
    m = 0.1 * 0.707 * math.log(40) + 1
    assert mla.softmax_mscale(cfg) == pytest.approx(m, rel=1e-15)
    assert mla_dense.softmax_scale2(small_config()) == \
        pytest.approx(m * m, rel=1e-15)


def _share_params(full: dict, share: int, n_held: int) -> dict:
    """The layer's parameters as the chip holding experts ``share *
    n_held`` to ``(share + 1) * n_held - 1`` holds them."""
    out = dict(full)
    for k in ("moe.w_up", "moe.w_down", "moe.w_gate"):
        out[k] = full[k][share * n_held:(share + 1) * n_held]
    return out


def _port_block(params: dict, x, cfg: dict):
    from repro_torch.models.transformer import ParamTree

    pcfg = arch_config(cfg)
    tree = ParamTree(weights.tree(
        [weights.Leaf(k, tuple(v.shape), None, False) for k, v in
         params.items()], list(params.values())))
    with torch.no_grad():
        return tf.block_apply(tree, x, pcfg, "mla_moe")[0]


def test_shares_sum_to_the_whole_layer(fp32_port):
    """Four chips of a 16-expert layer, 4 experts each: their outputs
    summed, with what every chip computes alike (the residual, attention,
    the shared experts) counted once, are the uncut reference layer."""
    whole = small_config(n_experts=16, expert_offset=0)
    leaves = [leaf for leaf in mla_moe.leaves(whole)]
    vals = weights.make(leaves, SEED, "cpu")
    full = {leaf.name: v for leaf, v in zip(leaves, vals)}
    # a layer with small weights would give small expert outputs: scale
    # the experts up so that their part is a large share of the output
    for k in ("moe.w_down",):
        full[k] = full[k] * 8
    x = torch.randn(ROWS, SEQ, whole["d_model"],
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = mla_moe.apply(full, x, whole, common.Precision("fp32"))
    n_held, shares = 4, 4
    total = torch.zeros_like(x)
    for s in range(shares):
        cfg = small_config(n_experts=n_held, expert_offset=s * n_held)
        total += _port_block(_share_params(full, s, n_held), x, cfg)
    no_experts = dict(_share_params(full, 0, n_held))
    no_experts["moe.w_down"] = torch.zeros_like(no_experts["moe.w_down"])
    common_part = _port_block(no_experts, x, small_config(n_experts=n_held))
    got = total - (shares - 1) * common_part
    routed = want - common_part
    assert float(torch.linalg.vector_norm(routed)) > \
        0.1 * float(torch.linalg.vector_norm(want - x))
    # fp32, sums in other orders; the routed part to 1e-5 of its size
    assert float(torch.linalg.vector_norm(got - want)) <= \
        1e-5 * float(torch.linalg.vector_norm(routed))
    # and one share alone is the reference's share
    cfg = small_config(n_experts=n_held, expert_offset=8)
    share = _share_params(full, 2, n_held)
    with torch.no_grad():
        ref_share = mla_moe.apply(share, x, cfg, common.Precision("fp32"))
    torch.testing.assert_close(_port_block(share, x, cfg), ref_share,
                               rtol=1e-5, atol=1e-5)


def _skewed(kind: str, d: int, n_tokens: int):
    """(x [1, N, D], router [D, 16]) with tokens falling unevenly."""
    gen = torch.Generator().manual_seed(11)
    router = torch.randn(d, 16, generator=gen) / math.sqrt(d)
    x = torch.randn(1, n_tokens, d, generator=gen)
    if kind == "identical":                 # every token the same choices,
        x = x[:, :1].expand(1, n_tokens, d).contiguous()   # expert 5 first
        router[:, 5] = 3.0 * x[0, 0] / torch.linalg.vector_norm(x[0, 0])
    elif kind == "one_expert":              # expert 4 first for every token
        x = x.abs() + 1.0
        router[:, 4] = 5.0 / math.sqrt(d)
    return x, router


@pytest.mark.parametrize("kind", ["identical", "one_expert", "random"])
def test_dropless_at_any_imbalance(kind, fp32_port):
    """Every (token, choice) pair on a held expert is computed: the layer
    equals the per-token sum over its chosen held experts, and the
    counter counts each pair once."""
    d, n_tok, top, n_held, first = 32, 96, 3, 4, 4
    gen = torch.Generator().manual_seed(3)
    x, router = _skewed(kind, d, n_tok)
    p = {"router": router,
         "w_up": torch.randn(n_held, d, 24, generator=gen) / math.sqrt(d),
         "w_down": torch.randn(n_held, 24, d, generator=gen) / math.sqrt(24),
         "w_gate": torch.randn(n_held, d, 24, generator=gen) / math.sqrt(d)}
    moe.flush_expert_pairs()
    before = {e: moe.EXPERT_PAIRS.value(expert=str(e))
              for e in range(first, first + n_held)}
    y, _ = moe.moe_apply_held(p, x, top_k=top, offset=first)
    moe.flush_expert_pairs()
    probs = torch.softmax(x[0] @ router, dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    want = torch.zeros(n_tok, d)
    count = {e: 0 for e in before}
    for t in range(n_tok):
        for e in idx[t, :top].tolist():
            if first <= e < first + n_held:
                w = {k: v[e - first] for k, v in p.items() if k != "router"}
                h = moe.silu(x[0, t] @ w["w_gate"]) * (x[0, t] @ w["w_up"])
                want[t] += probs[t, e] * (h @ w["w_down"])
                count[e] += 1
    if kind != "random":
        # the whole batch on one held expert (more than any capacity the
        # capacity-based layer would give it)
        assert max(count.values()) == n_tok
    assert sum(count.values()) > 0
    torch.testing.assert_close(y[0], want, rtol=1e-5, atol=1e-6)
    for e, n in count.items():
        assert moe.EXPERT_PAIRS.value(expert=str(e)) - before[e] == n


@pytest.mark.parametrize("held, vocab, count", [
    (8, 12800, 2_743_987_712), (64, 102400, 15_706_484_224)])
def test_parameter_counts(held, vocab, count):
    """The benchmark's cut (8 of 64 experts, 12,800 of 102,400 rows) and
    the published model: the model's parameters, and the estimate,
    which leaves out the norms for every block kind."""
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite"), n_experts=held,
                              router_experts=64, vocab=vocab)
    params = build_model(cfg).abstract_params()
    assert sum(p.numel() for p in params.parameters()) == count
    norms = sum(p.numel() for p in params.parameters() if p.dim() == 1)
    assert norms == 27 * (2 * 2048 + 512) + 2048
    assert cfg.params_estimate() == count - norms
    if held == 8:
        bench = json.loads((ROOT / "perfbench" / "configs" /
                            "deepseek-v2-lite.json").read_text())
        assert weights.param_count(bench) == count
        assert arch_config(bench).params_estimate() == count - norms
    # the active count: top-6 of 64 at the held share
    layer = 3 * 2048 * 1408
    assert cfg.params_estimate() - cfg.active_params_estimate() == \
        round((held - 6 * held / 64) * layer * 26)


def test_registry_and_operator_mix():
    cfg = get_arch("deepseek-v2-lite")
    assert "deepseek-v2-lite" not in ARCH_IDS
    assert cfg.kv_lora_rank == 512 and cfg.qk_head_dim == 192
    assert cfg.n_routed == 64 and cfg.moe_aux_coef == 0.0
    assert get_arch("mixtral-8x7b").moe_aux_coef == 0.01
    seq = 512
    ops = {o.name: o for o in cfg._mla_ops("mla_moe", seq)}
    assert (ops["q_proj"].k, ops["q_proj"].n) == (2048, 16 * 192)
    assert ops["kv_a_proj"].n == 576 and ops["kv_b_proj"].k == 512
    assert (ops["attn_score"].k, ops["attn_ctx"].n) == (192, 128)
    assert ops["router"].n == 64 and ops["moe_up"].count == 12
    assert ops["shared_up"].n == 2816
    dense = {o.name: o for o in cfg._mla_ops("mla_dense", seq)}
    assert dense["ffn_up"].n == 10944 and "router" not in dense
    # the merged forward pass: every weight product of the model once a
    # token, the routed experts at top-6 a token
    w = cfg.workload(seq)
    static = sum(o.macs for o in w.ops if o.weights_static)
    mla_w = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    per_tok = 27 * mla_w + 3 * 2048 * 10944 + 26 * (
        2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816) + 2048 * 102400
    assert static == seq * per_tok


def test_no_latent_cache_and_spans(fp32_port):
    cfg = arch_config(small_config())
    with pytest.raises(NotImplementedError, match="latent"):
        build_model(cfg).init_cache(1, 8, "cpu")
    model = build_model(cfg)
    params = model.init(0, "cpu", trainable=True)
    tok = torch.randint(0, cfg.vocab, (1, 16),
                        generator=torch.Generator().manual_seed(0))
    tracer().clear()
    loss, _ = model.loss(params, {"tokens": tok, "labels": tok})
    loss.backward()
    names = [e["name"] for e in tracer().events()]
    # the forward, then each layer again in the backward (remat)
    for name, n in (("mla.project", 3), ("mla.attention", 3),
                    ("moe.route", 2), ("moe.dispatch", 2),
                    ("moe.experts", 2), ("moe.shared", 2),
                    ("moe.combine", 2)):
        assert names.count(name) == 2 * n, name


def _tiny_cell():
    from perfbench import harness

    bench = ROOT / "perfbench"
    tr = json.loads((bench / "traffic" / "train-4x8192.json").read_text())
    tr.update(seq_len=SEQ, batch=ROWS)
    workload = "deepseek-v2-lite.train-4x8192"
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    return harness.Cell(
        workload=workload, entry={"chips": 1}, config=small_config(),
        traffic=tr, limits_path=bench / "limits" / f"{workload}.json",
        end_to_end=[], per_layer=[m for m in man["per_layer"]
                                  if workload in m.get("workloads", ())],
        root=ROOT)


def test_tiny_cell_through_the_harness(monkeypatch):
    """The benchmark's driver on the cell cut to a CPU test's size: a
    traced window, the reference's check, and the new readers."""
    import time
    import types

    from perfbench import harness
    from perfbench.drivers import train

    # the guard refuses a benchmark process that loaded JAX; this test's
    # process may hold it from other tests' files
    monkeypatch.setattr(harness, "guard_modules", lambda: None)

    cell = _tiny_cell()
    assert [m["name"] for m in cell.per_layer] == [
        "data_wait_ms.train", "step_mfu.train", "kernel_ms.train",
        "device_idle_share.train", "data_queue_wait_ms.train",
        "mla_attention_roofline.train", "moe_dispatch_ms.train"]
    args = types.SimpleNamespace(seed=SEED, seconds=0.01, trace=1)
    cpu = torch.device("cpu")
    window, prog, _, _, stream = train.measure(cell, args, time.time(), cpu)
    ok, compared = train.reference_check(cell, SEED, stream, prog, window, cpu)
    # bf16 against fp32 at a tiny size: far inside any limit a card run
    # sets, far above fp32's rounding
    assert ok and 0 < compared["loss_gap"]["value"] < 0.05
    rec = {"cell": cell, "trace": window["trace"], "window": window,
           "card": None}
    read = lambda name: harness.reader(name, ROOT)(rec)
    assert read("mla_attention_roofline.train") is None   # no kernels here
    assert read("kernel_ms.train") is None
    mfu, _ = read("step_mfu.train")
    per_token = weights.model_flops_per_token(cell.config, SEQ)
    part = window["untraced"]
    assert mfu == pytest.approx(100 * per_token * part["tokens"]
                                / part["seconds"] / 989e12)
    ms, note = read("moe_dispatch_ms.train")
    # 2 MoE layers, each dispatched in the forward and again in the remat
    assert ms > 0 and note.startswith("4 moe.dispatch spans a step;")
    assert "not read" not in note


def test_roofline_reader_counts_true_widths():
    from perfbench import harness, mla_work, trace, work

    anon = "void (anonymous namespace)::"
    ev = lambda name, ts, dur: {"ph": "X", "name": name, "cat": "kernel",
                                "ts": ts, "dur": dur, "tid": 1}
    events = [{"ph": "X", "name": trace.WINDOW_SPAN, "cat": "user_annotation",
               "ts": 0, "dur": 10_000, "tid": 1},
              ev(anon + "tc::flash_kernel<256, 64, 64>(CUtensorMap)", 0, 1000),
              ev(anon + "dq_kernel<256>(CUtensorMap)", 1000, 1500),
              ev(anon + "dkdv_kernel<256>(CUtensorMap)", 2500, 1500)]
    workload = "deepseek-v2-lite.train-4x8192"
    cell = harness.find_cell(workload, ROOT)
    rec = {"cell": cell, "trace": trace.summarize(events), "window": {}}
    value, note = harness.reader("mla_attention_roofline.train", ROOT)(rec)
    fwd, _ = mla_work.attention_fwd(64, 8192, 192, 128)
    bwd, _ = mla_work.attention_bwd(64, 8192, 192, 128)
    assert value == pytest.approx(100 * (fwd + bwd) / 4e-3)
    assert "compiled width 256" in note and "192 / 128" in note
    # the true widths count less work than the padded call the kernel runs
    assert fwd < work.attention_fwd(64, 8192, 192)[0]
    assert bwd < work.attention_bwd(64, 8192, 192)[0]


def test_layer_reads_nothing_on_the_host(fp32_port):
    """The reduced model's loss and gradients through its checkpointed
    MoE layers, the recompute included: no op reads a value on the host
    (``item``, ``tolist``) or takes a shape from the data (``nonzero``,
    a boolean mask), so on the card the host never waits for the layer;
    the counter's counts stay on the device until a reader flushes them,
    once for the forward and not again for the recompute."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    reads = {aten._local_scalar_dense.default, aten.nonzero.default,
             aten.masked_select.default, aten.unique_consecutive.default,
             aten._unique2.default, aten.bincount.default}
    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    cfg = arch_config(small_config())
    model = build_model(cfg)
    params = model.init(0, "cpu", trainable=True)
    tok = torch.randint(0, cfg.vocab, (2, 16),
                        generator=torch.Generator().manual_seed(1))
    moe.flush_expert_pairs()
    before = sum(c.value for _, c in moe.EXPERT_PAIRS.samples())
    with Watch():
        loss, _ = model.loss(params, {"tokens": tok, "labels": tok})
        loss.backward()
    assert aten._grouped_mm.default in seen
    assert not reads & set(seen)
    moe.flush_expert_pairs()
    # 2 MoE layers, 3 choices of 16 on each of 32 tokens, 4 held
    counted = sum(c.value for _, c in moe.EXPERT_PAIRS.samples()) - before
    assert 0 < counted <= 2 * 32 * 3
