"""The port's arch configs against the reference's: every ``ArchConfig``
field, every ``reduced()`` field, the shape set, the block-kind helpers
and the parameter estimates, for all ten archs; and the port's parameter
trees hold exactly the reference's parameter count."""
import dataclasses

import jax
import pytest

from repro import configs as ref_configs
from repro.models import build_model as ref_build_model

from repro_torch import configs
from repro_torch.models import build_model

ARCHS = configs.ARCH_IDS


def test_registry_and_shapes_equal_the_reference():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    assert sorted(configs.__all__) == sorted(ref_configs.__all__)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_and_estimates_equal(arch):
    ours, theirs = configs.get_arch(arch), ref_configs.get_arch(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    for cfg_o, cfg_t in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        assert cfg_o.is_attention_free == cfg_t.is_attention_free
        assert cfg_o.group_pattern == cfg_t.group_pattern
        assert cfg_o.n_groups() == cfg_t.n_groups()
        assert cfg_o.params_estimate() == cfg_t.params_estimate()
        assert cfg_o.active_params_estimate() == \
            cfg_t.active_params_estimate()
        for kind in set(cfg_o.pattern):
            assert cfg_o._layer_params(kind) == cfg_t._layer_params(kind)


def test_serving_models_sizes():
    """The two full-width serving models of the card's run."""
    assert configs.get_arch("yi-6b").params_estimate() == 6_060_769_280
    assert configs.get_arch("falcon-mamba-7b").params_estimate() == \
        7_268_728_832


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_count_equals_the_reference(arch):
    cfg = configs.get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(0, "cpu")
    ref_model = ref_build_model(ref_configs.get_arch(arch).reduced())
    assert model.param_count(params) == ref_model.param_count()
    # each layer holds the reference block's leaves, under its names
    ref_params = ref_model.abstract_params()
    ref_names = {".".join(str(getattr(k, "key", k)) for k in path[2:])
                 for path, _ in jax.tree_util.tree_leaves_with_path(
                     ref_params["stack"])}
    ours = {name.split(".", 3)[3] for name, _ in params.named_parameters()
            if name.startswith("stack.layers.")}
    assert ours == ref_names
