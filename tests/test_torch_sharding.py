"""The port's sharding rules against the reference's.

For every leaf of all ten archs' full-size abstract parameters and caches
(at every prefill and decode shape the arch runs), ``param_rule`` and
``cache_rule`` must give the reference's ``PartitionSpec`` on
``jax.sharding.AbstractMesh((16, 16), ("data", "model"))`` and on its
``(2, 16, 16)`` ("pod", "data", "model") twin, where the port's
``launch.mesh.abstract_mesh`` of the same shape stands in; the reference
stacks each full pattern group's layers [G, ...], so its spec carries a
leading entry the port's unstacked leaf drops.  ``batch_rule`` is held on
every input spec, with ``fsdp`` and ``shard_attn=False`` as cases of
their own, and ``placements`` maps the specs onto mesh dims.
"""
import dataclasses

import jax
import pytest
from jax.sharding import AbstractMesh

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro.models import build_model as ref_build_model
from repro.models import sharding as ref_sh
from repro.launch import steps as ref_steps

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.models import build_model
from repro_torch.models import sharding as sh

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"baseline": {}, "fsdp": {"fsdp": True},
            "no-shard-attn": {"shard_attn": False}}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), abstract_mesh(shape, axes)


def _key(entry):
    return str(getattr(entry, "key", getattr(entry, "idx", entry)))


def _unstacked(path, shape, spec, cfg):
    """The port's (name parts, shape, spec) of a reference leaf: a leaf of
    ``stack/groups`` (or ``encoder/stack/groups``) is G leaves, one a
    layer, without the leading dim and spec entry."""
    keys = [_key(e) for e in path]
    for prefix, pattern, n_layers in (
            (["stack"], cfg.pattern, cfg.n_layers),
            (["encoder", "stack"], ("enc_self",), cfg.encoder_layers)):
        k = len(prefix)
        if keys[:k] != prefix or len(keys) <= k + 1 or \
                keys[k] not in ("groups", "rem"):
            continue
        slot = int(keys[k + 1].split("_", 1)[0][1:])
        rest = keys[k + 2:]
        full = n_layers // len(pattern)
        if keys[k] == "rem":
            return [(prefix + ["layers", str(full * len(pattern) + slot)]
                     + rest, shape, spec)]
        return [(prefix + ["layers", str(g * len(pattern) + slot)] + rest,
                 shape[1:], spec[1:]) for g in range(shape[0])]
    return [(keys, shape, spec)]


def _ref_specs(tree, rule, cfg):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        spec = tuple(rule(ref_sh._leaf_name(path), tuple(leaf.shape)))
        spec += (None,) * (len(leaf.shape) - len(spec))
        for parts, shape, sp in _unstacked(path, tuple(leaf.shape), spec,
                                           cfg):
            out[tuple(parts)] = (shape, sp)
    return out


def _cfgs(arch, variant):
    ov = VARIANTS[variant]
    return (dataclasses.replace(ref_arch(arch), **ov),
            dataclasses.replace(get_arch(arch), **ov))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rule_every_leaf(arch, mesh):
    _check_params(arch, mesh, "baseline")


@pytest.mark.parametrize("variant", ["fsdp", "no-shard-attn"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rule_variants(arch, variant):
    _check_params(arch, "16x16", variant)


def _check_params(arch, mesh, variant):
    ref_cfg, cfg = _cfgs(arch, variant)
    ref_mesh, port_mesh = _meshes(mesh)
    want = _ref_specs(ref_build_model(ref_cfg).abstract_params(),
                      lambda n, s: ref_sh.param_rule(ref_cfg, n, s, ref_mesh),
                      ref_cfg)
    params = build_model(cfg).abstract_params()
    got = sh.param_shardings(cfg, params, port_mesh)
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    assert set(got) == {".".join(k) for k in want}
    for parts, (shape, spec) in want.items():
        name = ".".join(parts)
        assert shapes[name] == shape, name
        assert got[name] == spec, (name, got[name], spec)


def _port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, prefix + ("layers", str(i)))
    elif tree is not None:
        yield prefix, tree


def _serve_shapes(arch):
    return [s for s in SHAPES if SHAPES[s].kind != "train"
            and s not in get_arch(arch).skip_shapes]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_rule_every_leaf(arch, mesh):
    ref_cfg, cfg = _cfgs(arch, "baseline")
    ref_mesh, port_mesh = _meshes(mesh)
    for shape_id in _serve_shapes(arch):
        shape = SHAPES[shape_id]
        ref_cache = ref_build_model(ref_cfg).abstract_cache(
            shape.global_batch, shape.seq_len)
        want = _ref_specs(
            ref_cache, lambda n, s: ref_sh.cache_rule(ref_cfg, n, s,
                                                      ref_mesh), ref_cfg)
        cache = build_model(cfg).abstract_cache(shape.global_batch,
                                                shape.seq_len)
        specs = dict(_port_leaves(sh.cache_shardings(cfg, cache, port_mesh)))
        leaves = dict(_port_leaves(cache))
        # the port keeps lengths and steps as ints: no tensor, no spec
        ints = {k for k, v in leaves.items() if isinstance(v, int)}
        assert {k for k in want if k[-1] in ("len", "step")} == ints
        assert set(want) - ints == set(specs)
        for parts, (shp, spec) in want.items():
            if parts in ints:
                assert spec == ()
                continue
            assert tuple(leaves[parts].shape) == shp, (shape_id, parts)
            assert specs[parts] == spec, (shape_id, parts, specs[parts], spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_rule_every_input(arch, mesh):
    ref_cfg, cfg = _cfgs(arch, "baseline")
    ref_mesh, port_mesh = _meshes(mesh)
    for shape_id, shape in SHAPES.items():
        ref_shape = REF_SHAPES[shape_id]
        if shape.kind == "decode":
            ref_in = {"tokens": ref_steps.decode_specs(
                ref_build_model(ref_cfg), ref_shape)[1]}
            port_in = {"tokens": steps.input_specs(cfg, shape)["tokens"]}
        else:
            ref_in = ref_steps.input_specs(ref_cfg, ref_shape)["batch"]
            port_in = steps.input_specs(cfg, shape)["batch"]
        got = sh.batch_shardings(port_in, port_mesh)
        for name, leaf in ref_in.items():
            spec = tuple(ref_sh.batch_rule(name, tuple(leaf.shape),
                                           ref_mesh))
            assert got[name] == spec, (shape_id, name, got[name], spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match(mesh):
    """``make_shard_act``'s rules (resid, moe_buf, attn_q_seq, logits)
    give the reference's specs: the port's ``_fit`` on the same entries."""
    ref_mesh, port_mesh = _meshes(mesh)
    dp = ref_sh.dp_axes(ref_mesh)
    assert sh.dp_axes(port_mesh) == dp
    for spec, shape in (((dp, None, None), (256, 4096, 4096)),
                        ((dp, "model", None), (256, 4096, 4096)),
                        ((dp, None, None, None), (256, 40, 64, 1536)),
                        ((dp, "model", None, None), (32, 4096, 24, 128)),
                        ((dp, None, "model"), (128, 1, 51865)),
                        ((dp,), (3, 5))):
        assert sh._fit(spec, shape, port_mesh) == \
            tuple(ref_sh._fit(spec, shape, ref_mesh)), (spec, shape)


def test_placements_on_the_abstract_mesh():
    from torch.distributed.tensor import Replicate, Shard

    m2 = abstract_mesh((16, 16), ("data", "model"))
    m3 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements((None, "model", None), m2) == (Replicate(), Shard(1))
    assert sh.placements(("data", None, "model"), m2) == (Shard(0), Shard(2))
    assert sh.placements((), m2) == (Replicate(), Replicate())
    # one tensor dim over ("pod", "data"): both mesh dims shard it, major
    # to minor
    assert sh.placements((("pod", "data"), None, "model"), m3) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements(("data", "model"), m3) == (
        Replicate(), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="order"):
        sh.placements((("data", "pod"),), m3)
    # a mesh dim of one rank holds the whole dim: its shard is the replica
    m1 = abstract_mesh((1, 1), ("data", "model"))
    assert sh.placements(("data", "model"), m1) == (Replicate(), Replicate())


def test_fit_drops_axes_that_do_not_divide():
    m = abstract_mesh((16, 16), ("data", "model"))
    ref_m = AbstractMesh((16, 16), ("data", "model"))
    cfg = get_arch("whisper-small")                 # 12 heads
    spec = sh.param_rule(cfg, "wq", (768, 12, 64), m)
    assert spec == (None, None, None)
    assert spec == tuple(ref_sh.param_rule(ref_arch("whisper-small"), "wq",
                                           (768, 12, 64), ref_m))
    assert sh.batch_rule("tokens", (1, 524288), m) == (None, None)
