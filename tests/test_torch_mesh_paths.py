"""The port's entry points on a ``DeviceMesh`` of one rank (gloo on the
CPU): ``Trainer``, ``ServeEngine``, the batch iterator, checkpoints moved
between a mesh and one device, the CLIs' ``--mesh``, and the mesh
constructors' errors.  On one rank the sharded path computes the same ops
on the same data, so each is held equal to the device path, bit for bit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import (DataConfig, SyntheticLMStream,
                                       make_batch_iterator, shard_batch)
from repro_torch.launch.mesh import (abstract_mesh, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models import sharding as sh
from repro_torch.optim import AdamWConfig
from repro_torch.serve import GenerationConfig, ServeEngine
from repro_torch.train import Trainer, TrainerConfig

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo mesh; its process group is torn down after the
    module, so no other test file of this worker sees it."""
    started = not dist.is_initialized()
    yield make_debug_mesh(1, 1, device_type="cpu")
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _tcfg(tmp, steps):
    return TrainerConfig(steps=steps, seq_len=16, global_batch=2,
                         ckpt_every=2, ckpt_dir=str(tmp), log_every=1,
                         optimizer=AdamWConfig(warmup_steps=1,
                                               total_steps=4))


def _full(p):
    return p.full_tensor() if sh.is_dtensor(p) else p


def test_trainer_on_a_mesh_equals_the_device(mesh, tmp_path):
    """(falcon-mamba-7b's train cell is held on a 2x2 mesh in
    ``tests/test_torch_sharded_step.py``.)"""
    cfg = get_arch("yi-6b").reduced()
    plain = Trainer(cfg, _tcfg(tmp_path / "plain", 4), "cpu")
    p0, _ = plain.train(log=lambda s: None)
    meshed = Trainer(cfg, _tcfg(tmp_path / "mesh", 4), mesh)
    assert meshed.mesh is mesh and meshed.device.type == "cpu"
    p1, _ = meshed.train(log=lambda s: None)
    assert all(sh.is_dtensor(p) for p in p1.parameters())
    assert [r["loss"] for r in meshed.history] == \
        [r["loss"] for r in plain.history]
    for (n, a), b in zip(p1.named_parameters(), p0.parameters()):
        assert torch.equal(_full(a).detach(), b.detach()), n


def test_checkpoint_moves_between_a_mesh_and_a_device(mesh, tmp_path):
    """A run interrupted on the mesh at step 2 resumes on one device (and
    one interrupted on a device resumes on the mesh), equal to the
    uninterrupted run."""
    cfg = get_arch("yi-6b").reduced()
    whole = Trainer(cfg, _tcfg(tmp_path / "whole", 4), "cpu")
    want, _ = whole.train(log=lambda s: None)
    for first, then, sub in ((mesh, "cpu", "a"), ("cpu", mesh, "b")):
        Trainer(cfg, _tcfg(tmp_path / sub, 2), first).train(
            log=lambda s: None)
        resumed = Trainer(cfg, _tcfg(tmp_path / sub, 4), then)
        got, _ = resumed.train(log=lambda s: None)
        assert [r["step"] for r in resumed.history] == [3, 4]
        assert [r["loss"] for r in resumed.history] == \
            [r["loss"] for r in whole.history[2:]]
        for a, b in zip(got.parameters(), want.parameters()):
            assert torch.equal(_full(a).detach(), b.detach())


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b",
                                  "granite-moe-3b-a800m", "whisper-small"])
def test_serve_engine_on_a_mesh_equals_the_device(mesh, arch):
    cfg = get_arch(arch).reduced()
    plain = ServeEngine(cfg, "cpu", seed=3)
    meshed = ServeEngine(cfg, mesh, params=plain.params)
    assert all(sh.is_dtensor(p) for p in meshed.params.parameters())
    assert not any(sh.is_dtensor(p) for p in plain.params.parameters())
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(1, cfg.vocab, n)) for n in (5, 9)]
    for gen in (GenerationConfig(max_new_tokens=4),
                GenerationConfig(max_new_tokens=4, temperature=0.8, seed=2)):
        np.testing.assert_array_equal(meshed.generate(prompts, gen)["tokens"],
                                      plain.generate(prompts, gen)["tokens"])


def test_batches_on_a_mesh(mesh):
    stream = SyntheticLMStream(DataConfig(seq_len=8, global_batch=4,
                                          vocab=64))
    batch = shard_batch(stream.global_batch_at(0), mesh)
    assert all(sh.is_dtensor(v) for v in batch.values())
    np.testing.assert_array_equal(batch["tokens"].full_tensor().numpy(),
                                  stream.global_batch_at(0)["tokens"])
    it = make_batch_iterator(stream, mesh, start_step=3)
    try:
        got = next(it)
    finally:
        it.close()
    np.testing.assert_array_equal(got["labels"].full_tensor().numpy(),
                                  stream.global_batch_at(3)["labels"])


def test_mesh_constructors(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="256 ranks in a world of 1"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="512 ranks in a world of 1"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(ValueError, match="device_type"):
        make_debug_mesh(1, 1, device_type="tpu")
    am = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert (am.shape, am.mesh_dim_names) == ((2, 16, 16),
                                             ("pod", "data", "model"))
    with pytest.raises(ValueError, match="differ in length"):
        abstract_mesh((16, 16), ("data",))


def test_data_parallel_layers_run_as_one_region(mesh, monkeypatch):
    """On a mesh where a layer's weights are replicated and its input is
    sharded at most over the batch, each layer runs under one
    ``local_map`` region (``sharding.local_block``): a train step of
    reduced yi-6b takes one region a layer in the forward and one in the
    remat's recompute, and no per-op region; an input sharded over its
    sequence does not qualify."""
    import dataclasses

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import SHAPES
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer
    from repro_torch.optim import AdamW

    calls = {"block": 0, "dense": 0}

    def spy(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(transformer, "local_block",
                        spy("block", sh.local_block))
    monkeypatch.setattr(sh, "local_dense", spy("dense", sh.local_dense))
    cfg = get_arch("yi-6b").reduced()
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    cell, _ = build_cell(cfg, shape, mesh, optimizer=AdamW())
    params = cell.model.init(0, "cpu", trainable=True)
    tokens = torch.zeros((2, 16), dtype=torch.int32)
    cell(params, AdamW().init(params), {"tokens": tokens, "labels": tokens})
    assert calls == {"block": 2 * cfg.n_layers, "dense": 0}

    x = distribute_tensor(torch.ones(2, 4, 8), mesh, [Shard(1), Replicate()])
    w = {"w": distribute_tensor(torch.ones(8, 8), mesh,
                                [Replicate(), Replicate()])}
    assert not sh.data_parallel(x, w)
    assert sh.data_parallel(x.redistribute(mesh, [Shard(0), Replicate()]), w)


def test_shard_act_places_activations(mesh):
    """The hook redistributes a DTensor to its rule's placements and
    passes a plain tensor, or any tensor without a mesh, as it is."""
    act = sh.make_shard_act(mesh)
    x = torch.ones(2, 3, 4)
    assert act(x, "resid") is x
    assert sh.make_shard_act(None)(x, "resid") is x
    assert sh.make_shard_act(abstract_mesh((1, 1), ("data", "model"))) \
        is sh.Identity
    d = sh.place(x, (None, None, None), mesh)
    assert sh.is_dtensor(act(d, "logits"))


def test_cli_mesh_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "yi-6b",
         "--smoke", "--device", "cpu", "--mesh", "1x1", "--batch", "2",
         "--new-tokens", "3"], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill ") and lines[1] == "sampled tokens:"
