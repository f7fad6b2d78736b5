"""Sharded cells across processes: four gloo processes on a 2x2 ("data",
"model") mesh (``tests/torch_sharded_worker.py``) run ``build_cell``'s
train cells of reduced yi-6b and falcon-mamba-7b for two steps, a prefill
and a decode cell of reduced yi-6b, and ``compressed_allreduce`` over the
group; each is held against the same cell run in one process without a
mesh, and the all-reduce against the reference's under ``shard_map`` over
4 XLA host devices (in a subprocess, so the forced device count stays
there).

Bars are twice the gap measured on this host (gloo on the CPU): the
sharded matmuls reduce their bf16 partial products across the "model"
ranks in bf16, where one process accumulates in fp32 and rounds once, so
the gradients, and through AdamW's normalisation the leaves that start at
0 (norm scales, biases), move most.  Losses: measured 4.7e-5 (yi-6b) and
1.19e-4 (falcon-mamba-7b, step 2; the one-process bf16 run is itself
1.06e-4 from the same run in fp32, the sharded one 1.3e-5) relative.
Leaves after two steps (|a - b| / |b| by Frobenius norm): worst 0.178
(yi-6b ``ln_mlp.scale``) and 0.133 (falcon-mamba-7b ``ln_final.scale``),
all leaves together 1.21e-3 and 3.2e-4.  Logits over max |logit|: prefill
0.0154, decode 0.0237.  The variant cells (one step of yi-6b with
``fsdp``, and with ``seq_shard_attn`` without head sharding) are held
under yi-6b's bars: measured loss 4.7e-5 and 6.3e-5, worst leaf 0.249
(``ln_mlp.scale``).

bf16 rounding is loose enough to hide a lost sum (a gradient of the Mamba
scan's B and C summed over one rank's channels only moved falcon-mamba-7b's
leaves by 0.215 at worst, inside bf16 bars), so both train cells run again
with every product in fp32 (``torch_sharded_worker.fp32_compute``), on
the 2x2 mesh and on a data-parallel 4x1 one, where the sharded cell
equals one process up to the order of fp32 sums: measured loss 1.4e-7,
worst leaf 3.8e-6 (yi-6b ``ln_attn.scale``), all leaves 1.3e-7; the lost
sum above gives 7.3e-4 over all leaves.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_sharded_worker as w
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.optim.compression import compressed_allreduce

WORLD = 4
LOSS_TOL = {"yi-6b": 1e-4, "falcon-mamba-7b": 2.4e-4}
LEAF_TOL = {"yi-6b": 0.36, "falcon-mamba-7b": 0.27}
ALL_TOL = {"yi-6b": 2.4e-3, "falcon-mamba-7b": 6.4e-4}
#: the fp32 cells: loss, worst leaf, all leaves
FP32_TOL = (3e-7, 8e-6, 3e-7)
PREFILL_TOL, DECODE_TOL = 0.031, 0.048
TIMEOUT = 300

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
sys.path.insert(0, sys.argv[1])
import torch_sharded_worker as w
from repro.compat import make_mesh, shard_map
from repro.optim.compression import compressed_allreduce, quantize_int8

mesh = make_mesh((4,), ("pod",))
n = len(w.GRAD_SHAPES)
grads = [np.stack([w.rank_grads(r)[i] for r in range(4)]) for i in range(n)]
errors = [np.stack([w.rank_errors(r)[i] for r in range(4)]) for i in range(n)]

def body(gs, es):
    gs = [g[0] for g in gs]
    es = [e[0] for e in es]
    mean, err = compressed_allreduce(gs, "pod", errors=es)
    sums = [jax.lax.psum(quantize_int8(g + e)[0].astype(jnp.int32), "pod")
            for g, e in zip(gs, es)]
    return ([m[None] for m in mean], [e[None] for e in err],
            [s[None] for s in sums])

spec = [P("pod")] * n
out = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                out_specs=(spec, spec, spec))(grads, errors)
arrays = {f"{k}{i}": np.asarray(a)
          for k, group in zip(("mean", "err", "sum"), out)
          for i, a in enumerate(group)}
np.savez(sys.argv[2], **arrays)
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The four ranks' results (rank 0's file)."""
    tmp = tmp_path_factory.mktemp("sharded")
    store, out = str(tmp / "store"), str(tmp / "out.pt")
    worker = os.path.join(os.path.dirname(__file__), "torch_sharded_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), str(WORLD), store, out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def reference_allreduce(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = _env()
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                           os.path.dirname(__file__), out], env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out))


def _one_process(arch):
    cfg = w.config(arch)
    model = build_model(cfg)
    return w.train_run(make_train_step(model, AdamW(w.OPT)), model, cfg)


@pytest.mark.parametrize("arch", w.TRAIN_ARCHS)
def test_train_cell_matches_one_process(sharded, arch):
    got, want = sharded[arch], _one_process(arch)
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) / abs(b) <= LOSS_TOL[arch], (got["losses"],
                                                       want["losses"])
    num = den = 0.0
    for name, b in want["params"].items():
        a = got["params"][name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        gap = float((a - b).norm() / b.norm())
        assert gap <= LEAF_TOL[arch], (name, gap)
        num += float((a - b).norm()) ** 2
        den += float(b.norm()) ** 2
    assert (num / den) ** 0.5 <= ALL_TOL[arch], (num / den) ** 0.5


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
@pytest.mark.parametrize("arch", w.TRAIN_ARCHS)
def test_fp32_train_cell_equals_one_process(sharded, arch, mesh):
    """With every product in fp32 the sharded cell equals one process up
    to the order of fp32 sums: each loss, each leaf and all leaves after
    two steps within ``FP32_TOL``, on the 2x2 mesh (per-op regions) and
    on the data-parallel 4x1 one (a region a layer)."""
    cfg = w.config(arch)
    model = build_model(cfg)
    with w.fp32_compute():
        want = w.train_run(make_train_step(model, AdamW(w.OPT)), model, cfg)
    got = sharded[f"{arch}/fp32/{mesh}"]
    loss_tol, leaf_tol, all_tol = FP32_TOL
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= loss_tol * abs(b), (got["losses"],
                                                 want["losses"])
    num = den = 0.0
    for name, b in want["params"].items():
        a = got["params"][name]
        gap = float((a - b).norm() / b.norm())
        assert gap <= leaf_tol, (name, gap)
        num += float((a - b).norm()) ** 2
        den += float(b.norm()) ** 2
    assert (num / den) ** 0.5 <= all_tol, (num / den) ** 0.5


def test_train_cell_placements_follow_the_rules(sharded):
    """The step's outputs keep the rules' placements (2x2 mesh: heads,
    FFN hidden and vocab over "model"; nothing over "data" without
    fsdp)."""
    pl = sharded["yi-6b"]["placements"]
    assert pl["stack.layers.0.attn.wq"] == "(Replicate(), Shard(dim=1))"
    assert pl["stack.layers.0.attn.wo"] == "(Replicate(), Shard(dim=0))"
    assert pl["stack.layers.0.mlp.w_down"] == "(Replicate(), Shard(dim=0))"
    assert pl["embed"] == "(Replicate(), Shard(dim=0))"
    assert pl["stack.layers.0.ln_attn.scale"] == "(Replicate(), Replicate())"
    pl = sharded["falcon-mamba-7b"]["placements"]
    assert pl["stack.layers.0.mamba.a_log"] == "(Replicate(), Shard(dim=0))"
    assert pl["stack.layers.0.mamba.in_proj"] == "(Replicate(), Shard(dim=1))"


@pytest.mark.parametrize("tag", list(w.VARIANT_CELLS))
def test_variant_cells_read_the_mesh(sharded, tag):
    """FSDP shards the big leaves' dim 0 over "data" too; without head
    sharding the q sequence is sharded over "model" ("attn_q_seq") and
    attention runs on replicated heads.  One step's loss and leaves
    against the one-process step, under the train cells' bars."""
    cfg = w.config("yi-6b", **w.VARIANT_CELLS[tag])
    model = build_model(cfg)
    want = w.train_run(make_train_step(model, AdamW(w.OPT)), model, cfg,
                       steps=1)
    got = sharded[tag]
    assert abs(got["losses"][0] - want["losses"][0]) <= \
        LOSS_TOL["yi-6b"] * abs(want["losses"][0])
    for name, b in want["params"].items():
        gap = float((got["params"][name] - b).norm() / b.norm())
        assert gap <= LEAF_TOL["yi-6b"], (name, gap)
    wq = got["placements"]["stack.layers.0.attn.wq"]
    assert wq == {"fsdp": "(Shard(dim=0), Shard(dim=1))",
                  "seq_shard_attn": "(Replicate(), Replicate())"}[tag]


def _serve_reference():
    cfg = w.config(w.SERVE_ARCH)
    model = build_model(cfg)
    params = model.init(0, "cpu")
    logits, caches = model.prefill(params, {
        "tokens": w.train_batch(cfg, 0)["tokens"]})
    logits2, caches2 = model.decode(params, caches, w.decode_tokens(cfg))
    return logits, caches, logits2, caches2


def test_prefill_cell_matches_one_process(sharded):
    logits, caches, _, _ = _serve_reference()
    got = sharded["prefill"]
    assert got["placement"] == "(Shard(dim=0), Shard(dim=2))"
    assert got["k0_placement"] == "(Shard(dim=0), Replicate())"
    gap = float((got["logits"] - logits).abs().max() / logits.abs().max())
    assert gap <= PREFILL_TOL, gap
    assert torch.equal(got["k0"], caches["stack"][0]["k"])


def test_decode_cell_matches_one_process(sharded):
    _, _, logits, caches = _serve_reference()
    got = sharded["decode"]
    assert got["step"] == caches["step"]
    gap = float((got["logits"] - logits).abs().max() / logits.abs().max())
    assert gap <= DECODE_TOL, gap
    assert torch.equal(got["k0"], caches["stack"][0]["k"])


def test_compressed_allreduce_across_processes(sharded, reference_allreduce):
    """int32 sums exact; the mean and the carried residual against the
    reference's ``shard_map`` at rtol 1e-6."""
    got = sharded["allreduce"]
    ref = reference_allreduce
    for i in range(len(w.GRAD_SHAPES)):
        np.testing.assert_array_equal(got["sums"][i].numpy(),
                                      ref[f"sum{i}"][0])
        np.testing.assert_allclose(got["mean"][i].numpy(), ref[f"mean{i}"][0],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got["errors"][i].numpy(),
                                   ref[f"err{i}"][0], rtol=1e-6, atol=1e-7)
        # every rank's mean is the same: rank 0's equals the reference's
        # rank 3 too
        np.testing.assert_allclose(ref[f"mean{i}"][3], ref[f"mean{i}"][0])


def test_compressed_allreduce_world_of_one_is_local():
    """Without a group the sum is the local value: the same function the
    four processes ran, here on rank 0's inputs alone."""
    grads = [torch.as_tensor(g) for g in w.rank_grads(0)]
    mean, err = compressed_allreduce(grads)
    for g, m, e in zip(grads, mean, err):
        assert torch.allclose(m + e, g, atol=1e-6)
