"""The port's abstract cell inputs against the reference's.

For all ten archs x the four ``SHAPES``, ``launch.steps.input_specs``
(meta tensors) must have the shapes and dtypes of the reference's
``ShapeDtypeStruct``s; ``Model.abstract_params`` and ``abstract_cache``
those of the reference's ``eval_shape`` trees (one leaf a layer, where the
reference stacks each full pattern group [G, ...]), with nothing
allocated; ``param_count`` the leaves' count (the reference's, modulo the
int32 wrap of its per-leaf product).  ``build_cell`` on an abstract
mesh gives the abstract arguments of each kind of cell.
"""
import math

import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_arch as ref_arch
from repro.launch import steps as ref_steps
from repro.models import build_model as ref_build_model

from repro_torch.configs import ARCH_IDS, SHAPES, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import AXES, abstract_mesh
from repro_torch.models import build_model

from test_torch_sharding import _port_leaves, _ref_specs, _unstacked


def _spec(x):
    """(shape, dtype name) of a ShapeDtypeStruct or a tensor."""
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


def _flat(tree):
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    return _spec(tree)


@pytest.mark.parametrize("shape_id", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs(arch, shape_id):
    want = ref_steps.input_specs(ref_arch(arch), REF_SHAPES[shape_id])
    got = steps.input_specs(get_arch(arch), SHAPES[shape_id])
    assert set(got) == set(want)
    if "batch" in want:
        assert _flat(got["batch"]) == _flat(want["batch"])
        assert all(v.device.type == "meta" for v in got["batch"].values())
        return
    assert _spec(got["tokens"]) == _spec(want["tokens"])
    ref_cache = _ref_specs(want["caches"], lambda n, s: (), ref_arch(arch))
    port_cache = dict(_port_leaves(got["caches"]))
    for parts, (shape, _) in ref_cache.items():
        leaf = port_cache[parts]
        if isinstance(leaf, int):                 # lengths and steps
            assert shape == (), parts
        else:
            assert tuple(leaf.shape) == shape, parts
            assert leaf.device.type == "meta"


def _ref_leaves(tree, cfg):
    """{port name parts: (shape, dtype)} of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        for parts, shape, _ in _unstacked(
                path, tuple(leaf.shape), (None,) * leaf.ndim, cfg):
            out[tuple(parts)] = (shape, str(leaf.dtype))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params(arch):
    ref_model = ref_build_model(ref_arch(arch))
    model = build_model(get_arch(arch))
    want = _ref_leaves(ref_model.abstract_params(), ref_arch(arch))
    params = model.abstract_params()
    got = {tuple(n.split(".")): _spec(p) for n, p in params.named_parameters()}
    assert got == want
    assert all(p.device.type == "meta" for p in params.parameters())
    exact = sum(math.prod(shape) for shape, _ in want.values())
    assert model.param_count() == exact
    # the reference takes each stacked leaf's size as an int32 product,
    # which wraps above 2**31 elements (falcon-mamba-7b, mistral-nemo-12b,
    # mixtral-8x7b, llama-3.2-vision-90b): equal modulo 2**32
    assert (ref_model.param_count() - exact) % 2 ** 32 == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_cache(arch):
    shape = SHAPES["decode_32k"]
    ref_cfg = ref_arch(arch)
    want = _ref_leaves(ref_build_model(ref_cfg).abstract_cache(
        shape.global_batch, shape.seq_len), ref_cfg)
    cache = build_model(get_arch(arch)).abstract_cache(shape.global_batch,
                                                       shape.seq_len)
    got = dict(_port_leaves(cache))
    assert set(got) == set(want)
    for parts, (shp, dtype) in want.items():
        leaf = got[parts]
        if isinstance(leaf, int):
            assert shp == () and leaf == 0, parts
        else:
            assert _spec(leaf) == (shp, dtype), parts


@pytest.mark.parametrize("shape_id", list(SHAPES))
def test_build_cell_abstract_args(shape_id):
    """Train: fp32 masters, AdamW moments, the batch; prefill: the served
    tree and the batch; decode: the served tree, the caches, the tokens --
    all meta; the step of an abstract mesh refuses to run."""
    cfg, shape = get_arch("yi-6b"), SHAPES[shape_id]
    step, args = steps.build_cell(cfg, shape, abstract_mesh((1, 1), AXES))
    params = args[0]
    assert all(p.device.type == "meta" for p in params.parameters())
    if shape.kind == "train":
        assert {p.dtype for p in params.parameters()} == {torch.float32}
        assert len(args[1]["m"]) == len(list(params.parameters()))
        assert args[1]["m"][0].device.type == "meta"
        assert _flat(args[2]) == _flat(steps.train_batch_specs(cfg, shape))
    else:
        assert torch.bfloat16 in {p.dtype for p in params.parameters()}
    with pytest.raises(TypeError, match="DeviceMesh"):
        step(*args)
