"""Generic stacked-architecture assembly, the reference's
``models/transformer.py`` in PyTorch.

An architecture is a repeating ``pattern`` of block kinds (ArchConfig.pattern)
-- dense LMs repeat ("dense",), RecurrentGemma repeats
("rglru", "rglru", "local_attn"), Llama-3.2-Vision repeats
("cross", "self", "self", "self", "self"), Whisper stacks an encoder
("enc_self",) and a decoder ("dec_self_cross",).

The reference scans its full pattern groups (params stacked [G, ...]);
here every layer is its own module in one ``ModuleList``, in order: group
0's blocks, group 1's, ..., then the remainder layers (a prefix of the
pattern).  ``scan_layers`` changes nothing here.  ``remat`` does in a
forward that records gradients: each layer runs under
``torch.utils.checkpoint`` (non-reentrant), keeping only its input, and is
recomputed in the backward pass (``remat_policy="dots"`` is taken as
``"full"``); the recompute runs in an ``obs`` span, ``model.remat``, and
the final norm and head product in ``model.head``.

Parameters come in two kinds (:func:`lm_init`): a serving tree keeps each
weight in the dtype its forward reads (:func:`storage_dtype`, bf16 for
most matrices), a trainable tree keeps the reference's fp32 masters, which
require gradients and are cast on each use as the reference casts them.

Caches: every block kind has its own decode cache (KV ring buffer for
sliding-window attention, full KV for dense attention, conv+state for
Mamba/RG-LRU, cross-KV for cross-attention), one per layer in a list;
lengths and steps are Python ints.  Updates are out of place: a call
returns new caches and leaves its inputs as they were.

Prefill self-attention takes an ``attention`` function with
``layers.flash_prefill``'s signature and every Mamba layer a ``scan``
with ``ssm.plain_scan``'s; the defaults launch the hand-written kernels
on the card.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
from torch import nn
from torch.utils import checkpoint as _checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.sharding import (Identity, data_parallel,
                                         is_dtensor, local_block, local_dense,
                                         local_rows, unshard)
from repro_torch.models.layers import (
    COMPUTE_DTYPE,
    NEG_INF,
    _expand_kv,
    apply_norm,
    dense_attention,
    embed_init,
    flash_prefill,
    mlp_apply,
    mlp_params,
    norm_params,
    normal,
    rope,
)
from repro_torch.obs.trace import span

CACHE_DTYPE = torch.bfloat16
#: the weights the reference reads only through ``.astype(bf16)``: kept in
#: bf16 (the same values as its per-use cast)
BF16_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "in_proj",
    "x_proj", "out_proj", "w_a", "w_i", "lm_head", "wkv_a", "wkv_b"})


# ====================================================================== #
# parameters
# ====================================================================== #
class ParamTree(nn.Module):
    """A nested mapping of parameters as a module: ``p["attn"]["wq"]``
    reads as the reference's pytree does, and the state dict is named
    after it (``stack.layers.0.attn.wq``).  Lists become ``ModuleList``s.
    Its parameters require gradients when ``trainable``."""

    def __init__(self, tree: dict, trainable: bool = False):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, trainable))
            elif isinstance(v, (list, tuple)):
                self.add_module(k, nn.ModuleList(ParamTree(x, trainable)
                                                 for x in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=trainable))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def storage_dtype(name: str, t: torch.Tensor, cfg: ArchConfig) -> torch.dtype:
    """The dtype a parameter is kept in: the one the forward reads it in.
    A weight the reference only reads cast to bf16 is kept in bf16; with
    ``cast_params_bf16`` every fp32 leaf of two or more dims but
    ``a_log`` and ``conv_w`` is (the reference's one-time cast); every
    other leaf stays fp32."""
    if t.dtype != torch.float32 or t.dim() < 2:
        return t.dtype
    if name in BF16_WEIGHTS or (cfg.cast_params_bf16
                                and name not in ("a_log", "conv_w")):
        return torch.bfloat16
    return t.dtype


def to_storage(tree, cfg: ArchConfig):
    """``tree`` (nested dicts and lists, or a :class:`ParamTree`) as
    nested dicts and lists with each leaf in its :func:`storage_dtype`."""
    if isinstance(tree, (dict, nn.Module)) and not isinstance(
            tree, nn.ModuleList):
        items = tree.items() if isinstance(tree, dict) else \
            [*tree._parameters.items(), *tree._modules.items()]
        return {k: (v.to(storage_dtype(k, v, cfg))
                    if isinstance(v, torch.Tensor) else to_storage(v, cfg))
                for k, v in items}
    return [to_storage(v, cfg) for v in tree]


# ====================================================================== #
# caches
# ====================================================================== #
def _attn_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                device) -> dict:
    return {
        "k": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=CACHE_DTYPE,
                         device=device),
        "v": torch.zeros((batch, cache_len, n_kv, head_dim), dtype=CACHE_DTYPE,
                         device=device),
        "pos": torch.full((batch, cache_len), -1, dtype=torch.int32,
                          device=device),
        "len": 0,
    }


def _cross_cache(cfg: ArchConfig, batch: int, device) -> dict:
    shape = (batch, cfg.n_memory, cfg.n_kv_heads, cfg.head_dim)
    return {"xk": torch.zeros(shape, dtype=CACHE_DTYPE, device=device),
            "xv": torch.zeros(shape, dtype=CACHE_DTYPE, device=device)}


def block_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                device) -> Any:
    """Decode cache of one block (zeros)."""
    w = cfg.window
    if kind in ("dense", "self", "moe"):
        clen = min(max_len, w) if w else max_len
        return _attn_cache(batch, clen, cfg.n_kv_heads, cfg.head_dim, device)
    if kind == "local_attn":
        clen = min(max_len, cfg.window or 2048)
        return _attn_cache(batch, clen, cfg.n_kv_heads, cfg.head_dim, device)
    if kind in ("mamba", "rglru"):
        state = {"ssm": (batch, cfg.d_inner, cfg.ssm_state)} if \
            kind == "mamba" else {"h": (batch, cfg.d_inner)}
        return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                    dtype=torch.float32, device=device),
                **{k: torch.zeros(s, dtype=torch.float32, device=device)
                   for k, s in state.items()}}
    if kind == "cross":
        return _cross_cache(cfg, batch, device)
    if kind == "dec_self_cross":
        return {"self": _attn_cache(batch, max_len, cfg.n_kv_heads,
                                    cfg.head_dim, device),
                "cross": _cross_cache(cfg, batch, device)}
    if kind == "enc_self":
        return None
    if kind in ("mla_dense", "mla_moe"):
        raise NotImplementedError(
            f"{kind}: latent attention trains here; serving it (a cache of "
            "its latent) is not implemented")
    raise ValueError(f"unknown block kind {kind}")


# ====================================================================== #
# cached attention primitives (slot-based: ring buffer for SWA)
# ====================================================================== #
def _project_qkv(p, x, memory=None):
    src = memory if memory is not None else x
    proj = _project
    if is_dtensor(x):
        # on a mesh: each rank's local heads (sharding.local_dense)
        proj = lambda x, w: local_dense(_project, x, (w,), w_dims=(1,),
                                        out_dim=2)
    return proj(x, p["wq"]), proj(src, p["wk"]), proj(src, p["wv"])


def _project(x, w):
    return torch.einsum("btd,dhk->bthk", x.to(COMPUTE_DTYPE),
                        w.to(COMPUTE_DTYPE))


def _attn_out(p, out):
    if is_dtensor(out):
        # each rank's local heads, their sum pending (sharding.local_dense)
        return local_dense(lambda o, w: _attn_out({"wo": w}, o), out,
                           (p["wo"],), w_dims=(0,), x_dim=2)
    return torch.einsum("bthk,hkd->btd", out.to(COMPUTE_DTYPE),
                        p["wo"].to(COMPUTE_DTYPE))


def attn3_params(gen, cfg: ArchConfig) -> dict:
    """Attention params in head-major 3D layout [D, H, dh]."""
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = 1.0 / math.sqrt(d)
    return {
        "wq": normal(gen, (d, h, dh), s),
        "wk": normal(gen, (d, kh, dh), s),
        "wv": normal(gen, (d, kh, dh), s),
        "wo": normal(gen, (h, dh, d), 1.0 / math.sqrt(h * dh)),
    }


def _set_slots(buf: torch.Tensor, slots: torch.Tensor, val: torch.Tensor):
    """``buf.at[:, slots].set(val)``, out of place.  A DTensor cache is
    written on each rank's local rows (``index_put_`` has no DTensor
    rule)."""
    if is_dtensor(buf) or is_dtensor(val):
        return local_rows(lambda b, v: _set_slots(b, slots, v), buf, val)
    out = buf.clone()
    out[:, slots] = val.to(buf.dtype)
    return out


def self_attention(
    p, x: torch.Tensor, cfg: ArchConfig, *,
    causal: bool = True,
    window: int | None = None,
    cache: dict | None = None,
    attention=flash_prefill,
    shard_act=Identity,
) -> tuple[torch.Tensor, dict | None]:
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x)
    dev = x.device
    if cfg.seq_shard_attn and not cfg.shard_attn:
        # context parallelism: replicated-head archs shard the q-sequence
        q = shard_act(q, "attn_q_seq")

    if cache is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
        if cfg.rope_theta is not None:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = attention(q, k, v, causal=causal, window=window)
        return _attn_out(p, out), None

    # ---- cached path ----
    cur = cache["len"]
    positions = cur + torch.arange(t, device=dev)[None].expand(b, t)
    if cfg.rope_theta is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    clen = cache["k"].shape[1]

    if t > 1:
        # prefill into a (possibly ring) cache: attention over the fresh
        # sequence itself, then store the last `clen` keys/values.
        # Assumes prefill starts from an empty cache.
        out = attention(q, k, v, causal=causal, window=window)
        if t >= clen:
            k_w, v_w = k[:, -clen:], v[:, -clen:]
            pos_w = positions[:, -clen:]
            slots = (cur + t - clen + torch.arange(clen, device=dev)) % clen
        else:
            k_w, v_w, pos_w = k, v, positions
            slots = (cur + torch.arange(t, device=dev)) % clen
        new_cache = {"k": _set_slots(cache["k"], slots, k_w),
                     "v": _set_slots(cache["v"], slots, v_w),
                     "pos": _set_slots(cache["pos"], slots, pos_w),
                     "len": cur + t}
        return _attn_out(p, out), new_cache

    # single-token decode: scatter into the slot, slot-position masking
    slots = (cur + torch.arange(t, device=dev)) % clen
    k_all = _set_slots(cache["k"], slots, k)
    v_all = _set_slots(cache["v"], slots, v)
    pos_all = _set_slots(cache["pos"], slots, positions)
    new_cache = {"k": k_all, "v": v_all, "pos": pos_all, "len": cur + t}

    h = q.shape[2]
    kk = _expand_kv(k_all, h)
    vv = _expand_kv(v_all, h)
    sc = torch.einsum("bthd,bshd->bhts", q.to(COMPUTE_DTYPE),
                      kk.to(COMPUTE_DTYPE)).float()
    sc = sc / math.sqrt(cfg.head_dim)
    qpos = positions                                          # [b, t]
    kpos = pos_all                                            # [b, clen]
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        valid &= kpos[:, None, :] > qpos[:, :, None] - window
    sc = torch.where(valid[:, None], sc, NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(COMPUTE_DTYPE)
    out = torch.einsum("bhts,bshd->bthd", pr, vv.to(COMPUTE_DTYPE))
    return _attn_out(p, out), new_cache


def cross_attention(
    p, x: torch.Tensor, cfg: ArchConfig, *,
    memory: torch.Tensor | None,
    cache: dict | None = None,
) -> tuple[torch.Tensor, dict | None]:
    if cache is not None and memory is None:
        # decode: cross-KV precomputed at prefill
        q = torch.einsum("btd,dhk->bthk", x.to(COMPUTE_DTYPE),
                         p["wq"].to(COMPUTE_DTYPE))
        out = dense_attention(q, cache["xk"], cache["xv"], causal=False)
        return _attn_out(p, out), cache
    q, k, v = _project_qkv(p, x, memory=memory)
    out = dense_attention(q, k, v, causal=False)
    new_cache = None
    if cache is not None:
        new_cache = {"xk": k.to(CACHE_DTYPE), "xv": v.to(CACHE_DTYPE)}
    return _attn_out(p, out), new_cache


# ====================================================================== #
# blocks
# ====================================================================== #
def block_init(gen, cfg: ArchConfig, kind: str) -> dict:
    d = cfg.d_model
    dev = gen.device
    gated = cfg.mlp_act in ("swiglu", "geglu")
    norm = lambda: norm_params(cfg.norm, d, dev)
    p: dict = {}
    if kind in ("dense", "self", "local_attn", "enc_self", "moe"):
        p["ln_attn"] = norm()
        p["attn"] = attn3_params(gen, cfg)
        if kind == "moe":
            p["ln_moe"] = norm()
            p["moe"] = moe_lib.moe_params(gen, d, cfg.d_ff, cfg.n_experts,
                                          gated)
        else:
            p["ln_mlp"] = norm()
            p["mlp"] = mlp_params(gen, d, cfg.d_ff, gated)
    elif kind in ("mla_dense", "mla_moe"):
        p["ln_attn"] = norm()
        p["attn"] = mla_lib.mla_params(gen, cfg)
        if kind == "mla_moe":
            p["ln_moe"] = norm()
            p["moe"] = moe_lib.moe_params(gen, d, cfg.d_ff, cfg.n_experts,
                                          gated, n_routed=cfg.n_routed)
            if cfg.shared_d_ff:
                p["moe"]["shared"] = mlp_params(gen, d, cfg.shared_d_ff,
                                                gated)
        else:
            p["ln_mlp"] = norm()
            p["mlp"] = mlp_params(gen, d, cfg.dense_d_ff or cfg.d_ff, gated)
    elif kind == "mamba":
        p["ln"] = norm()
        p["mamba"] = ssm_lib.mamba_params(
            gen, d, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv)
    elif kind == "rglru":
        p["ln_rec"] = norm()
        p["rglru"] = ssm_lib.rglru_params(gen, d, cfg.d_inner, cfg.ssm_conv)
        p["ln_mlp"] = norm()
        p["mlp"] = mlp_params(gen, d, cfg.d_ff, gated)
    elif kind == "cross":
        p["ln_x"] = norm()
        p["xattn"] = attn3_params(gen, cfg)
        p["xgate"] = torch.zeros((), dtype=torch.float32, device=dev)
        p["ln_mlp"] = norm()
        p["mlp"] = mlp_params(gen, d, cfg.d_ff, gated)
    elif kind == "dec_self_cross":
        p["ln_attn"] = norm()
        p["attn"] = attn3_params(gen, cfg)
        p["ln_x"] = norm()
        p["xattn"] = attn3_params(gen, cfg)
        p["ln_mlp"] = norm()
        p["mlp"] = mlp_params(gen, d, cfg.d_ff, gated)
    else:
        raise ValueError(f"unknown block kind {kind}")
    return p


def block_apply(
    p, x: torch.Tensor, cfg: ArchConfig, kind: str, *,
    cache: Any = None,
    memory: torch.Tensor | None = None,
    attention=flash_prefill,
    scan=ssm_lib.kernel_scan,
    shard_act=Identity,
) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x, new_cache, aux_loss); ``shard_act(x, name)`` places the
    residual stream (``"resid"``) after each sub-block.  A block of a
    data-parallel model on a mesh (``sharding.data_parallel``: no cache,
    no memory, no MoE routing) runs whole on each rank's local rows."""
    aux = x.new_zeros((), dtype=torch.float32)
    if cache is None and memory is None and kind not in ("moe", "mla_moe") \
            and data_parallel(x, p):
        x = local_block(lambda h, q: block_apply(
            q, h, cfg, kind, attention=attention, scan=scan)[0], x, p)
        return x, None, aux
    norm = lambda name, h: apply_norm(cfg.norm, p[name], h)
    if kind in ("dense", "self", "local_attn", "moe", "enc_self"):
        window = cfg.window if kind != "enc_self" else None
        h, new_cache = self_attention(
            p["attn"], norm("ln_attn", x), cfg, causal=kind != "enc_self",
            window=window, cache=cache, attention=attention,
            shard_act=shard_act)
        x = shard_act(x + h, "resid")
        if kind == "moe":
            if cfg.moe_row_dispatch:
                h, aux = moe_lib.moe_apply_row(
                    p["moe"], norm("ln_moe", x), top_k=cfg.moe_top_k,
                    act=cfg.mlp_act, shard_act=shard_act)
            else:
                h, aux = moe_lib.moe_apply(p["moe"], norm("ln_moe", x),
                                           top_k=cfg.moe_top_k,
                                           act=cfg.mlp_act)
        else:
            h = mlp_apply(p["mlp"], norm("ln_mlp", x), cfg.mlp_act)
        return shard_act(x + h, "resid"), new_cache, aux
    if kind in ("mla_dense", "mla_moe"):
        x = shard_act(x + mla_lib.mla_attention(
            p["attn"], norm("ln_attn", x), cfg, attention=attention), "resid")
        if kind == "mla_moe":
            h, aux = moe_lib.moe_apply_held(
                p["moe"], norm("ln_moe", x), top_k=cfg.moe_top_k,
                offset=cfg.expert_offset)
        else:
            h = mlp_apply(p["mlp"], norm("ln_mlp", x), cfg.mlp_act)
        return shard_act(x + h, "resid"), None, aux
    if kind == "mamba":
        h, new_cache = ssm_lib.mamba_apply(
            p["mamba"], norm("ln", x), d_state=cfg.ssm_state,
            dt_rank=cfg.dt_rank, cache=cache, chunk=cfg.ssm_chunk,
            fused=cfg.ssm_fused_coeffs, scan=scan)
        return shard_act(x + h, "resid"), new_cache, aux
    if kind == "rglru":
        h, new_cache = ssm_lib.rglru_apply(p["rglru"], norm("ln_rec", x),
                                           cache=cache)
        x = shard_act(x + h, "resid")
        h = mlp_apply(p["mlp"], norm("ln_mlp", x), cfg.mlp_act)
        return shard_act(x + h, "resid"), new_cache, aux
    if kind == "cross":
        h, new_cache = cross_attention(p["xattn"], norm("ln_x", x), cfg,
                                       memory=memory, cache=cache)
        x = shard_act(x + torch.tanh(p["xgate"]).to(h.dtype) * h, "resid")
        h = mlp_apply(p["mlp"], norm("ln_mlp", x), cfg.mlp_act)
        return shard_act(x + h, "resid"), new_cache, aux
    if kind == "dec_self_cross":
        self_cache = cache["self"] if cache is not None else None
        cross_cache = cache["cross"] if cache is not None else None
        h, new_self = self_attention(
            p["attn"], norm("ln_attn", x), cfg, causal=True, window=None,
            cache=self_cache, attention=attention, shard_act=shard_act)
        x = shard_act(x + h, "resid")
        h, new_cross = cross_attention(p["xattn"], norm("ln_x", x), cfg,
                                       memory=memory, cache=cross_cache)
        x = shard_act(x + h, "resid")
        h = mlp_apply(p["mlp"], norm("ln_mlp", x), cfg.mlp_act)
        new_cache = None
        if cache is not None:
            new_cache = {"self": new_self, "cross": new_cross}
        return shard_act(x + h, "resid"), new_cache, aux
    raise ValueError(f"unknown block kind {kind}")


# ====================================================================== #
# stacks (the pattern's groups, then the remainder layers)
# ====================================================================== #
def layer_kinds(pattern: tuple[str, ...], n_layers: int) -> list[str]:
    """The block kind of each layer: ``n_layers // len(pattern)`` full
    groups, then a prefix of the pattern."""
    full, rem = divmod(n_layers, len(pattern))
    return list(pattern) * full + list(pattern[:rem])


def stack_init(gen, cfg: ArchConfig, pattern: tuple[str, ...],
               n_layers: int) -> dict:
    return {"layers": [block_init(gen, cfg, kind)
                       for kind in layer_kinds(pattern, n_layers)]}


def stack_cache(cfg: ArchConfig, pattern, n_layers, batch, max_len,
                device) -> list:
    return [block_cache(cfg, kind, batch, max_len, device)
            for kind in layer_kinds(pattern, n_layers)]


def _remat_span():
    """The ``model.remat`` span while a checkpointed layer runs as the
    recompute inside the backward (a graph task is running; there is none
    in the forward), else no span."""
    if torch._C._current_graph_task_id() == -1:
        return contextlib.nullcontext()
    return span("model.remat")


def stack_apply(
    params, x: torch.Tensor, cfg: ArchConfig, pattern, n_layers, *,
    caches: list | None = None,
    memory: torch.Tensor | None = None,
    attention=flash_prefill,
    scan=ssm_lib.kernel_scan,
    shard_act=Identity,
):
    aux_tot = x.new_zeros((), dtype=torch.float32)
    new_caches = [] if caches is not None else None
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for i, kind in enumerate(layer_kinds(pattern, n_layers)):
        if remat:
            def layer(h, p=params["layers"][i], kind=kind):
                with _remat_span():
                    h, _, a = block_apply(p, h, cfg, kind, memory=memory,
                                          attention=attention, scan=scan,
                                          shard_act=shard_act)
                return h, a
            x, aux = _checkpoint.checkpoint(layer, x, use_reentrant=False)
            aux_tot = aux_tot + aux
            continue
        c = caches[i] if caches is not None else None
        x, nc, aux = block_apply(params["layers"][i], x, cfg, kind, cache=c,
                                 memory=memory, attention=attention,
                                 scan=scan, shard_act=shard_act)
        aux_tot = aux_tot + aux
        if caches is not None:
            new_caches.append(nc)
    return x, new_caches, aux_tot


# ====================================================================== #
# full models
# ====================================================================== #
def lm_init(gen: torch.Generator, cfg: ArchConfig,
            trainable: bool = False) -> ParamTree:
    """The model's parameters, drawn from ``gen`` on its device: each in
    its :func:`storage_dtype` for serving, or, ``trainable``, in the
    reference's dtypes (fp32 masters) and requiring gradients."""
    p: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model),
        "stack": stack_init(gen, cfg, cfg.pattern, cfg.n_layers),
        "ln_final": norm_params(cfg.norm, cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = normal(gen, (cfg.d_model, cfg.vocab),
                              1.0 / math.sqrt(cfg.d_model))
    if cfg.encoder_layers:
        p["encoder"] = {
            "pos": normal(gen, (cfg.n_memory, cfg.d_model), 0.02),
            "stack": stack_init(gen, cfg, ("enc_self",), cfg.encoder_layers),
            "ln_final": norm_params(cfg.norm, cfg.d_model, gen.device),
        }
        p["dec_pos"] = normal(gen, (cfg.max_decode_len, cfg.d_model), 0.02)
    return ParamTree(p if trainable else to_storage(p, cfg), trainable)


def encode_memory(params, cfg: ArchConfig, frames: torch.Tensor,
                  attention=flash_prefill,
                  shard_act=Identity) -> torch.Tensor:
    """Audio encoder (stub frontend supplies ``frames`` [B, n_mem, D])."""
    enc = params["encoder"]
    x = (frames + enc["pos"][None]).to(COMPUTE_DTYPE)
    x, _, _ = stack_apply(enc["stack"], x, cfg, ("enc_self",),
                          cfg.encoder_layers, attention=attention,
                          shard_act=shard_act)
    return apply_norm(cfg.norm, enc["ln_final"], x)


def lm_apply(
    params,
    cfg: ArchConfig,
    tokens: torch.Tensor,              # [B, T] int
    *,
    caches: list | None = None,
    memory: torch.Tensor | None = None,   # [B, n_mem, D] stub embeddings
    pos_offset: int = 0,               # decode: absolute position of t=0
    attention=flash_prefill,
    scan=ssm_lib.kernel_scan,
    shard_act=Identity,
) -> tuple[torch.Tensor, list | None, torch.Tensor]:
    """Returns (logits [B, T, V] fp32, new_caches, aux_loss)."""
    t = tokens.shape[1]
    if cfg.cast_params_bf16 and params["embed"].dtype == torch.float32:
        # a trainable tree under the one-time cast: bf16 copies of the big
        # weights for this forward, as the reference takes them
        params = to_storage(params, cfg)
    x = params["embed"][tokens]
    if cfg.emb_scale:
        x = x * math.sqrt(cfg.d_model)
    if cfg.encoder_layers:
        x = x + params["dec_pos"][pos_offset:pos_offset + t][None]
    x = shard_act(x.to(COMPUTE_DTYPE), "resid")

    x, new_caches, aux = stack_apply(
        params["stack"], x, cfg, cfg.pattern, cfg.n_layers, caches=caches,
        memory=memory, attention=attention, scan=scan, shard_act=shard_act)

    with span("model.head"):
        x = apply_norm(cfg.norm, params["ln_final"], x)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.einsum("btd,dv->btv", x.to(COMPUTE_DTYPE),
                              head.to(COMPUTE_DTYPE))
        logits = shard_act(logits.float(), "logits")
    return logits, new_caches, aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            z_loss: float = 1e-4) -> tuple[torch.Tensor, dict]:
    """Next-token CE (labels already shifted; -1 = masked) + z-loss.  On
    a mesh the vocab is gathered first: the gather of the label logits has
    no DTensor rule over a sharded vocab."""
    logits = unshard(logits, -1)
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None].long())[..., 0] - logz
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = -(ll * mask).sum() / denom
    zl = z_loss * ((logz ** 2) * mask).sum() / denom
    return ce + zl, {"ce": ce, "z_loss": zl, "tokens": mask.sum()}
