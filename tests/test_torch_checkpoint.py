"""The port's ``CheckpointManager``: a round trip of a model's parameters
(a bf16 leaf included, stored as its bit pattern) and its optimizer state
bit for bit; ``keep`` newest retained; a half-written ``.tmp`` directory
ignored; shape, dtype and missing-leaf mismatches refused before any
tensor is touched; and a checkpoint the reference wrote refused with a
message that names it."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as RefCheckpointManager

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamW
from repro_torch.train.checkpoint import CheckpointManager


def _state(seed):
    model = build_model(get_arch("yi-6b").reduced())
    params = model.init(seed, "cpu", trainable=True)
    opt = AdamW().init(params)
    g = torch.Generator().manual_seed(seed)
    for m in opt["m"] + opt["v"]:
        m.copy_(torch.rand(m.shape, generator=g))
    opt["step"] = 7 + seed
    extra = {"half": torch.randn(3, 5, generator=g).bfloat16()}
    return params, opt, extra


def _same(a, b):
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n


def test_round_trip_bit_for_bit(tmp_path):
    params, opt, extra = _state(0)
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(5, (params, opt, extra))
    assert os.path.basename(path) == "step_000000005"
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert manifest["format"] == "repro_torch" and manifest["step"] == 5
    assert manifest["leaves"]["0/stack.layers.0.attn.wq"]["dtype"] == "float32"
    assert manifest["leaves"]["2/half"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["1/step"] == {
        "file": manifest["leaves"]["1/step"]["file"], "shape": [],
        "dtype": "int"}
    like = _state(1)
    (p2, o2, e2), step = mgr.restore(like)
    assert step == 5 and p2 is like[0]
    _same(p2, params)
    assert o2["step"] == 7
    for key in ("m", "v"):
        assert all(torch.equal(a, b) for a, b in zip(o2[key], opt[key]))
    assert e2["half"].dtype == torch.bfloat16
    assert torch.equal(e2["half"], extra["half"])


def test_retention_latest_and_tmp_ignored(tmp_path):
    params, opt, _ = _state(0)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (2, 4, 6):
        mgr.save(s, (params, opt))
    assert sorted(os.listdir(tmp_path)) == ["step_000000004",
                                            "step_000000006"]
    os.makedirs(tmp_path / "step_000000008.tmp")       # a crash mid-write
    assert mgr.latest_step() == 6
    _, step = mgr.restore(_state(1)[:2], step=4)
    assert step == 4
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(1)[:2])


def test_mismatches_refused_before_loading(tmp_path):
    params, opt, _ = _state(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": opt})
    like_p, like_o, _ = _state(1)
    snapshot = {n: p.detach().clone() for n, p in like_p.named_parameters()}
    bad_shape = dict(like_o, m=like_o["m"][:-1] + [torch.zeros(3)])
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"params": like_p, "opt": bad_shape})
    bad_dtype = dict(like_o, v=[v.double() for v in like_o["v"]])
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore({"params": like_p, "opt": bad_dtype})
    with pytest.raises(ValueError, match="missing leaves"):
        mgr.restore({"params": like_p, "opt": like_o, "more": torch.zeros(1)})
    for n, p in like_p.named_parameters():      # nothing was loaded
        assert torch.equal(p, snapshot[n]), n
    served = build_model(get_arch("yi-6b").reduced()).init(0, "cpu")
    with pytest.raises(ValueError, match="dtype mismatch"):
        mgr.restore({"params": served, "opt": like_o})


def test_reference_checkpoint_refused(tmp_path):
    RefCheckpointManager(str(tmp_path)).save(
        3, {"embed": jnp.ones((4, 2)), "step": jnp.zeros((), jnp.int32)})
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    like = tf.ParamTree({"embed": torch.zeros(4, 2)})
    with pytest.raises(ValueError, match="reference package"):
        mgr.restore(like)
    assert torch.equal(like["embed"], torch.zeros(4, 2))
    np.testing.assert_array_equal(
        np.load(tmp_path / "step_000000003" / "embed.npy"), np.ones((4, 2)))
