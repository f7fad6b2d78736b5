"""Sharding rules for params, activations, batches and caches, the
reference's ``models/sharding.py`` on a ``torch.distributed`` DeviceMesh.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
  * batch            -> ("pod","data")   (data parallel)
  * TP over "model"  -> attention heads (3D weights [D, H, dh] so head
    sharding never crosses a reshape), FFN hidden, vocab, expert-internal
    hidden, SSM inner channels
  * FSDP over "data" -> param dim 0 of big archs (cfg.fsdp); optimizer state
    inherits
  * big KV caches    -> sequence axis over "model"

Every rule passes through a divisibility guard: a dim that an axis does not
divide is replicated instead (e.g. whisper's 12 heads, batch=1 long-decode).

A rule returns the reference's ``PartitionSpec`` entries as a tuple, one
per dim: None, an axis name, or a tuple of names (``("pod", "data")``).
:func:`placements` turns such a spec into DTensor placements, one per mesh
dim.  The rules read a mesh's axis names and sizes only, so they take a
``DeviceMesh`` or a ``launch.mesh.AbstractMesh``; placing tensors
(:func:`distribute`, :func:`make_shard_act`) needs a ``DeviceMesh``.

The port's layers are unstacked, so a leaf's spec is the reference's with
the leading entry of its stacked [G, ...] layout dropped.  Leaves are named
by the last component of their state-dict name (``stack.layers.0.attn.wq``
-> ``wq``) or by their dict key (caches, batches).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig

BIG_CACHE = 16384          # seq >= this -> shard cache seq over "model"


def _axes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def dp_axes(mesh) -> tuple[str, ...]:
    names = _axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _fit(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Left-pad with None to ndim and drop axes that don't divide; a
    tuple of one axis is that axis, of none is None (as ``PartitionSpec``
    reads them)."""
    sizes = _axes(mesh)
    spec = (None,) * (len(shape) - len(spec)) + tuple(spec)
    out = []
    for dim, ax in zip(shape, spec):
        if isinstance(ax, tuple) and len(ax) <= 1:
            ax = ax[0] if ax else None
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        size = math.prod(sizes[a] for a in axes)
        out.append(ax if dim % size == 0 else None)
    return tuple(out)


def param_rule(cfg: ArchConfig, name: str, shape: tuple[int, ...],
               mesh) -> tuple:
    names = _axes(mesh)
    fsdp = "data" if (cfg.fsdp and "data" in names) else None
    tp = "model" if "model" in names else None
    attn_tp = tp if cfg.shard_attn else None
    rules: dict[str, tuple] = {
        "wq": (fsdp, attn_tp, None),
        "wk": (fsdp, attn_tp, None),
        "wv": (fsdp, attn_tp, None),
        "wo": (attn_tp, None, fsdp),
        "w_up": (fsdp, tp),
        "w_gate": (fsdp, tp),
        "w_down": (tp, fsdp),
        "in_proj": (fsdp, tp),
        "out_proj": (tp, fsdp),
        "x_proj": (tp, fsdp),
        "dt_proj": (fsdp, tp),
        "w_a": (None, tp),
        "w_i": (None, tp),
        "router": (fsdp, None),
        "embed": (tp, fsdp),
        "lm_head": (fsdp, tp),
        "conv_w": (None, tp),
        "conv_b": (tp,),
        "dt_bias": (tp,),
        "d_skip": (tp,),
        "lambda_p": (tp,),
        "a_log": (tp, None),
    }
    return _fit(rules.get(name, ()), shape, mesh)


def cache_rule(cfg: ArchConfig, name: str, shape: tuple[int, ...],
               mesh) -> tuple:
    dp = dp_axes(mesh)
    tp = "model" if "model" in _axes(mesh) else None
    if name in ("k", "v"):           # [B, C, KH, dh]
        seq_ax = tp if shape[-3] >= BIG_CACHE else None
        return _fit((dp, seq_ax, None, None), shape, mesh)
    if name == "pos":                # [B, C]
        seq_ax = tp if shape[-1] >= BIG_CACHE else None
        return _fit((dp, seq_ax), shape, mesh)
    if name in ("len", "step"):
        return ()
    if name == "conv":               # [B, K-1, I]
        return _fit((dp, None, tp), shape, mesh)
    if name == "ssm":                # [B, I, S]
        return _fit((dp, tp, None), shape, mesh)
    if name == "h":                  # [B, I]
        return _fit((dp, tp), shape, mesh)
    if name in ("xk", "xv"):         # [B, n_mem, KH, dh]
        return _fit((dp, None, None, None), shape, mesh)
    return _fit((dp,), shape, mesh)


def batch_rule(name: str, shape: tuple[int, ...], mesh) -> tuple:
    dp = dp_axes(mesh)
    if name in ("tokens", "labels"):
        return _fit((dp, None), shape, mesh)
    if name == "memory":             # stub frontend embeddings [B, n, D]
        return _fit((dp, None, None), shape, mesh)
    return _fit((dp,), shape, mesh)


# ---------------------------------------------------------------------- #
# specs of trees
# ---------------------------------------------------------------------- #
def tree_shardings(tree: Any, mesh, rule, name: str = "") -> Any:
    """The spec of every tensor of ``tree`` (a module, dicts, lists,
    tensors; other leaves map to None), by ``rule(name, shape)``: a module
    maps to {state-dict name: spec}."""
    if isinstance(tree, nn.Module):
        return {k: rule(k.rsplit(".", 1)[-1], tuple(v.shape))
                for k, v in tree.state_dict(keep_vars=True).items()}
    if isinstance(tree, dict):
        return {k: tree_shardings(v, mesh, rule, str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_shardings(v, mesh, rule, name) for v in tree)
    if isinstance(tree, torch.Tensor):
        return rule(name, tuple(tree.shape))
    return None


def param_shardings(cfg: ArchConfig, params: nn.Module, mesh) -> dict:
    return tree_shardings(
        params, mesh, lambda n, s: param_rule(cfg, n, s, mesh))


def opt_shardings(cfg: ArchConfig, params: nn.Module, mesh) -> dict:
    """The AdamW state's specs: each moment as its parameter (the
    reference names a moment leaf after its parameter), the step count
    replicated."""
    specs = [param_rule(cfg, n.rsplit(".", 1)[-1], tuple(p.shape), mesh)
             for n, p in params.named_parameters()]
    return {"m": list(specs), "v": list(specs), "step": None}


def cache_shardings(cfg: ArchConfig, caches: Any, mesh) -> Any:
    return tree_shardings(
        caches, mesh, lambda n, s: cache_rule(cfg, n, s, mesh))


def batch_shardings(batch: Any, mesh) -> Any:
    return tree_shardings(batch, mesh, lambda n, s: batch_rule(n, s, mesh))


# ---------------------------------------------------------------------- #
# placing tensors on a DeviceMesh
# ---------------------------------------------------------------------- #
def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec``, one per mesh dim: ``Shard(d)`` where
    tensor dim ``d`` names the mesh dim, else ``Replicate()``.  A dim
    named by a tuple of axes is sharded by each of them, major to minor,
    as the mesh orders its dims."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} against the mesh's "
                             f"order {names}")
        for i in idx:
            # one rank holds the whole dim: its shard is the replica
            # (DTensor's view rules refuse a sharded dim of size 1)
            out[i] = Shard(d) if sizes[i] > 1 else Replicate()
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def place(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``x`` as a DTensor on ``mesh`` with ``spec``'s placements: a plain
    tensor (the same full value on every rank) is cut locally, with no
    communication; a DTensor is redistributed."""
    pl = placements(spec, mesh)
    if is_dtensor(x):
        return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)
    return distribute_tensor_local(x, mesh, pl)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` with every tensor placed by its spec (:func:`place`); a
    module becomes a new one of the same kind (a ``ParamTree``) whose
    parameters are DTensors, requiring gradients as the old ones did."""
    if isinstance(tree, nn.Module):
        from repro_torch.models.transformer import ParamTree

        flat = dict(tree.named_parameters())
        if all(is_dtensor(p) and p.device_mesh == mesh and
               tuple(p.placements) == placements(specs[k], mesh)
               for k, p in flat.items()):
            return tree                       # placed already
        trainable = any(p.requires_grad for p in flat.values())
        nested: dict = {}
        for k, p in flat.items():
            *path, leaf = k.split(".")
            node = nested
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = place(p.detach(), specs[k], mesh)
        return ParamTree(_lists(nested), trainable)
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh) for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return place(tree, specs, mesh)
    return tree


def _lists(node):
    """Nested dicts whose keys are all digits (a ModuleList's) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def gather(tree: Any) -> Any:
    """``tree`` with every DTensor as its full value (a plain tensor on
    every rank)."""
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v) for v in tree)
    return tree.full_tensor() if is_dtensor(tree) else tree


# ---------------------------------------------------------------------- #
# activations
# ---------------------------------------------------------------------- #
def make_shard_act(mesh, sp_seq: bool = False):
    """Activation sharding-constraint hook (the twin of
    ``with_sharding_constraint``): a DTensor is redistributed to its
    rule's placements; a plain tensor, or no ``DeviceMesh``, passes
    through.  ``sp_seq`` enables sequence parallelism for residuals."""
    from repro_torch.launch.mesh import is_mesh

    if not is_mesh(mesh):
        return Identity
    dp = dp_axes(mesh)
    tp = "model" if "model" in _axes(mesh) else None

    def shard_act(x, name):
        if x.ndim < 2 or not is_dtensor(x):
            return x
        if name == "resid":
            seq_ax = tp if sp_seq else None
            spec = _fit((dp, seq_ax, None), x.shape, mesh)
        elif name == "moe_buf":          # [B, E, C, D]: batch-local experts
            spec = _fit((dp, None, None, None), x.shape, mesh)
        elif name == "attn_q_seq":       # [B, T, H, dh]: context parallel
            spec = _fit((dp, tp, None, None), x.shape, mesh)
        elif name == "logits":
            spec = _fit((dp, None, tp), x.shape, mesh)
        else:
            spec = _fit((dp,), x.shape, mesh)
        return place(x, spec, mesh)

    return shard_act


def Identity(x, name):  # noqa: N802 -- the reference's name
    return x


# ---------------------------------------------------------------------- #
# the kernels under local_map (the twin of shard_map)
# ---------------------------------------------------------------------- #
def _local_placements(x, keep: dict[int, int], mesh) -> tuple:
    """``x``'s placements with every mesh dim that shards a tensor dim in
    ``keep`` ({tensor dim: its size}) by a divisor of that size kept, and
    every other mesh dim replicated."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, p in enumerate(x.placements):
        ok = isinstance(p, Shard) and p.dim in keep and \
            keep[p.dim] % mesh.size(i) == 0
        out.append(p if ok else Replicate())
    return tuple(out)


def _local(fn, args: tuple, in_pl: tuple, out_pl, mesh):
    """``fn`` under ``local_map`` with its arguments placed ``in_pl`` and
    its outputs ``out_pl``.  An argument replicated over a mesh dim that
    splits the work (some output sharded or pending there) gets back a
    gradient that each rank summed over its own part only: it is marked
    ``Partial`` there, so that the ranks' parts are added."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    args = tuple(distribute_tensor_local(a, mesh, pl) if not is_dtensor(a)
                 else a if tuple(a.placements) == pl
                 else a.redistribute(mesh, pl)
                 for a, pl in zip(args, in_pl))
    outs = out_pl if isinstance(out_pl[0], tuple) else (out_pl,)
    split = [any(not o[i].is_replicate() for o in outs)
             for i in range(mesh.ndim)]
    grad_pl = tuple([Partial() if split[i] and p.is_replicate() else p
                     for i, p in enumerate(pl)] for pl in in_pl)
    # local_map reads a list as one output's placements, a tuple as one
    # entry per output
    out_pl = tuple(map(list, out_pl)) if isinstance(out_pl[0], tuple) \
        else list(out_pl)
    return local_map(fn, out_placements=out_pl,
                     in_placements=tuple(map(list, in_pl)),
                     in_grad_placements=grad_pl, device_mesh=mesh)(*args)


def unshard(x, dim: int):
    """A DTensor with tensor dim ``dim`` gathered on every rank (each mesh
    dim that sharded it replicated); a plain tensor as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x):
        return x
    dim %= x.ndim
    pl = tuple(Replicate() if p == Shard(dim) else p for p in x.placements)
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def local_rows(fn, buf, val, *rest):
    """``fn(buf, val, *rest)`` on each rank's local rows of ``buf`` and
    ``val`` (dim 0, where the data axes shard ``buf``'s; every other dim
    replicated): for the cache slot writes, which have no DTensor rule.
    One of them may be a plain tensor (the same full value on every
    rank); ``rest`` passes as it is."""
    like = buf if is_dtensor(buf) else val
    mesh = like.device_mesh
    pl = _local_placements(like, {0: buf.shape[0]}, mesh)
    return _local(lambda b, v: fn(b, v, *rest), (buf, val), (pl, pl), pl,
                  mesh)


def local_replicated(fn, n_out: int, *args):
    """``fn(*args)`` with every DTensor of ``args`` replicated and taken
    locally, its ``n_out`` outputs replicated: for the MoE dispatch
    (``index_put_``, ``one_hot``), which has no DTensor rule."""
    from torch.distributed.tensor import Replicate

    mesh = next(a for a in args if is_dtensor(a)).device_mesh
    rep = (Replicate(),) * mesh.ndim
    out_pl = (rep,) * n_out if n_out > 1 else rep
    return _local(fn, args, (rep,) * len(args), out_pl, mesh)


def _mesh_of(*args):
    return next(a for a in args if is_dtensor(a)).device_mesh


def local_dense(fn, x, ws: tuple, *, w_dims: tuple, x_dim=None,
                out_dim=None):
    """``fn(x, *ws)`` -- products of an activation ``x`` [B, T, ...] with
    weights -- on each rank's local tensors, as tensor parallelism splits
    them.  On a mesh dim that shards ``ws[0]``'s dim ``w_dims[0]`` (heads,
    hidden units), each weight is sharded on its ``w_dims`` entry, ``x``
    on ``x_dim`` (None: replicated) and the output on ``out_dim`` (None:
    pending sums, ``Partial``, for a product that contracts the sharded
    dim).  On a mesh dim that shards ``x``'s batch or sequence, ``x`` and
    the output keep it and the weights are gathered (FSDP's all-gather;
    its gradient is scattered back).  Any other mesh dim is replicated.
    The products then run as plain ops, with no DTensor dispatch inside."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = _mesh_of(x, *ws)
    rep = Replicate()
    head = ws[0].placements if is_dtensor(ws[0]) else (rep,) * mesh.ndim
    mine = x.placements if is_dtensor(x) else (rep,) * mesh.ndim
    px, pws, pout = [], [[] for _ in ws], []
    for i in range(mesh.ndim):
        if head[i] == Shard(w_dims[0]):
            px.append(rep if x_dim is None else Shard(x_dim))
            for pw, d in zip(pws, w_dims):
                pw.append(Shard(d))
            pout.append(Partial() if out_dim is None else Shard(out_dim))
        elif mine[i] in (Shard(0), Shard(1)):
            px.append(mine[i])
            for pw in pws:
                pw.append(rep)
            pout.append(mine[i])
        else:
            px.append(rep)
            for pw in pws:
                pw.append(rep)
            pout.append(rep)
    return _local(fn, (x, *ws), (tuple(px), *map(tuple, pws)), tuple(pout),
                  mesh)


def local_rowwise(fn, x, *params, positional: bool = False):
    """``fn(x, *params)`` for a function of each row of ``x``'s last dim
    (a norm over features, rotary embedding by position) on each rank's
    local rows: ``x`` keeps every placement but one that shards its last
    dim.  ``params`` (per-feature scales) are replicated; with
    ``positional`` they are [B, T] positions, sharded as ``x``'s batch
    and sequence."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh_of(x, *params)
    rep = Replicate()
    px = tuple(rep if p == Shard(x.ndim - 1) else p for p in x.placements)
    pp = tuple(p if positional and p in (Shard(0), Shard(1)) else rep
               for p in px)
    return _local(fn, (x, *params), (px,) + (pp,) * len(params), px, mesh)


def _named_leaves(tree, prefix: str = "") -> list:
    """(dotted name, tensor) of every leaf of a module or nested dicts."""
    if isinstance(tree, nn.Module):
        return list(tree.named_parameters(prefix=prefix.rstrip(".")))
    return [leaf for k, v in tree.items()
            for leaf in (_named_leaves(v, f"{prefix}{k}.")
                         if isinstance(v, (dict, nn.Module))
                         else [(f"{prefix}{k}", v)])]


def _nested(names, leaves) -> dict:
    out: dict = {}
    for name, leaf in zip(names, leaves):
        *path, last = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def data_parallel(x, tree) -> bool:
    """True when ``x`` is a DTensor sharded at most over its batch (dim 0)
    and every leaf of ``tree`` is a replicated DTensor: what a layer then
    computes needs nothing from another rank."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(x) or any(not p.is_replicate() and p != Shard(0)
                                for p in x.placements):
        return False
    return all(is_dtensor(t) and all(p.is_replicate() for p in t.placements)
               for _, t in _named_leaves(tree))


def local_block(fn, x, tree):
    """``fn(x, tree)`` -> x, one layer of a data-parallel model
    (:func:`data_parallel`), under one ``local_map`` region: each rank's
    local rows of ``x`` and the full weights, as plain tensors (a nested
    dict in place of ``tree``).  One region a layer costs the host far
    less than one an op; the weights' gradients come back ``Partial`` over
    the mesh dims that shard the batch."""
    from torch.distributed.tensor import Replicate

    names, leaves = zip(*_named_leaves(tree))
    rep = (Replicate(),) * x.device_mesh.ndim
    return _local(lambda x, *ws: fn(x, _nested(names, ws)), (x, *leaves),
                  (tuple(x.placements),) + (rep,) * len(leaves),
                  tuple(x.placements), x.device_mesh)


def distribute_tensor_local(x, mesh, pl):
    """A plain tensor (the same full value on every rank) as a DTensor,
    cut locally."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def local_attention(fn, q, k, v):
    """``fn(q, k, v)`` ([B, T, H, dh] -> [B, T, H, dh]) on each rank's
    local tensors: batch where the data axes shard it, heads where
    ``q``'s heads are sharded and both head counts divide (each rank's
    query heads then read its own kv heads); everything else replicated."""
    mesh = q.device_mesh
    b, h, kh = q.shape[0], q.shape[2], k.shape[2]
    pl = _local_placements(q, {0: b, 2: math.gcd(h, kh)}, mesh)
    return _local(fn, (q, k, v), (pl, pl, pl), pl, mesh)


def local_scan(fn, xi, dt, bmat, cmat, a, h0):
    """The Mamba scan ``fn`` on each rank's local tensors: batch where the
    data axes shard ``xi``, channels where ``xi``'s channels are sharded;
    B and C replicated over the channels' mesh dims.  Returns (y [B, T, I],
    h_last [B, I, S])."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = xi.device_mesh
    b, _, i = xi.shape
    px = _local_placements(xi, {0: b, 2: i}, mesh)
    chan = lambda d: tuple(Shard(d) if p == Shard(2) else
                           (p if p == Shard(0) else Replicate())
                           for p in px)
    pb = tuple(p if p == Shard(0) else Replicate() for p in px)
    pa = tuple(Shard(0) if p == Shard(2) else Replicate() for p in px)
    ph = chan(1)
    return _local(fn, (xi, dt, bmat, cmat, a, h0),
                  (px, px, pb, pb, pa, ph), (px, ph), mesh)
