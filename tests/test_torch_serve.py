"""The port's serving engine against the reference's: greedy generation on
the reference's prompts (``tests/test_substrate.py:239-254``) with the
reference's parameters carried across gives the reference's tokens, or,
where the two part, the reference's top-2 margin at that step is under
the models' logit tolerance (atol 0.1, ``test_torch_models.py``); the
reference's left padding, EOS rule and loop (one decode per sampled
token); temperature sampling held on outcome (shape, ids within the
vocab, the same tokens for the same seed); and ``python -m
repro_torch.launch.serve --device cpu --smoke`` as a subprocess, printing
the reference's two lines."""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.launch.mesh import make_debug_mesh
from repro.serve.engine import GenerationConfig as RefGen
from repro.serve.engine import ServeEngine as RefEngine

from repro_torch import configs, convert
from repro_torch.serve import GenerationConfig, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = [[1, 2, 3, 4], [5, 6, 7]]
ATOL = 0.1


def _engines(arch, seed=0):
    ref = RefEngine(get_arch(arch).reduced(), make_debug_mesh(), seed=seed)
    pcfg = configs.get_arch(arch).reduced()
    params = convert.lm_params(jax.tree.map(np.asarray, ref.params), pcfg)
    return ref, ServeEngine(pcfg, "cpu", params=params)


def _ref_step_logits(ref, prompts, tokens):
    """The reference model's last-position logits before each sampled
    token, fed its own tokens (teacher forcing)."""
    padded = jnp.asarray(ref._pad_batch(prompts))
    b, t = padded.shape
    batch = {"tokens": padded,
             "caches": ref.model.init_cache(b, t + tokens.shape[1])}
    if ref.cfg.n_memory:
        batch["memory"] = jnp.zeros((b, ref.cfg.n_memory, ref.cfg.d_model),
                                    jnp.bfloat16)
    logits, caches = ref._prefill(ref.params, batch)
    out = [np.asarray(logits[:, -1])]
    for i in range(tokens.shape[1] - 1):
        logits, caches = ref._decode(ref.params, caches,
                                     jnp.asarray(tokens[:, i:i + 1]))
        out.append(np.asarray(logits[:, -1]))
    return out


@pytest.mark.parametrize("arch", ["yi-6b", "falcon-mamba-7b",
                                  "h2o-danube-3-4b", "whisper-small",
                                  "mixtral-8x7b"])
def test_greedy_tokens_equal_the_reference(arch):
    ref, eng = _engines(arch)
    want = ref.generate(PROMPTS, RefGen(max_new_tokens=6))["tokens"]
    got = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=6))
    assert got["tokens"].shape == want.shape == (2, 6)
    assert got["tokens_per_s"] > 0 and got["prefill_s"] > 0
    if np.array_equal(got["tokens"], want):
        return
    steps = _ref_step_logits(ref, PROMPTS, want)
    for row in range(2):
        diff = np.flatnonzero(got["tokens"][row] != want[row])
        if diff.size:
            top2 = np.sort(steps[diff[0]][row])[-2:]
            assert top2[1] - top2[0] < 2 * ATOL, (row, diff[0], top2)


def test_greedy_is_deterministic_and_left_padded():
    _, eng = _engines("yi-6b")
    g = GenerationConfig(max_new_tokens=6)
    o1, o2 = eng.generate(PROMPTS, g), eng.generate(PROMPTS, g)
    np.testing.assert_array_equal(o1["tokens"], o2["tokens"])
    np.testing.assert_array_equal(eng._pad_batch(PROMPTS),
                                  [[1, 2, 3, 4], [0, 5, 6, 7]])


def test_eos_stops_rows_and_the_loop():
    """A row that sampled EOS keeps EOS; when every row has, the loop
    stops there, as the reference's does."""
    _, eng = _engines("yi-6b")
    free = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=6))["tokens"]
    eos = int(free[0, 2])
    out = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=6,
                                                 eos_id=eos))["tokens"]
    hit = [int(np.flatnonzero(r == eos)[0]) if (r == eos).any() else None
           for r in free]
    for row, first in enumerate(hit):
        if first is not None:
            assert (out[row, first:] == eos).all()
    if all(h is not None for h in hit):
        assert out.shape[1] == max(hit) + 1


def test_decode_calls_per_generate(monkeypatch):
    """One decode per sampled token, the last one's logits unused, as the
    reference's loop (``serve/engine.py:71-86``)."""
    _, eng = _engines("falcon-mamba-7b")
    calls = []
    decode = eng.model.decode
    monkeypatch.setattr(eng.model, "decode",
                        lambda *a: calls.append(1) or decode(*a))
    eng.generate(PROMPTS, GenerationConfig(max_new_tokens=5))
    assert len(calls) == 5


def test_temperature_sampling_on_outcome():
    _, eng = _engines("mixtral-8x7b")
    vocab = eng.cfg.vocab
    g = GenerationConfig(max_new_tokens=5, temperature=0.8, seed=3)
    a, b = eng.generate(PROMPTS, g), eng.generate(PROMPTS, g)
    assert a["tokens"].shape == (2, 5)
    assert ((a["tokens"] >= 0) & (a["tokens"] < vocab)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    hot = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=5,
                                                 temperature=50.0, seed=4))
    greedy = eng.generate(PROMPTS, GenerationConfig(max_new_tokens=5))
    assert not np.array_equal(hot["tokens"], greedy["tokens"])


def test_own_init_is_seeded():
    cfg = configs.get_arch("yi-6b").reduced()
    a, b = (ServeEngine(cfg, "cpu", seed=7) for _ in range(2))
    c = ServeEngine(cfg, "cpu", seed=8)
    pa, pb, pc = (dict(e.params.named_parameters()) for e in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["embed"], pc["embed"])


def test_engine_defaults_to_the_card():
    import inspect
    assert inspect.signature(ServeEngine).parameters["mesh"].default == \
        "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ServeEngine(configs.get_arch("yi-6b").reduced())


def test_launch_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--smoke", "--device", "cpu", "--batch", "3",
         "--prompt-len", "12", "--new-tokens", "4"],
        capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("prefill ") and lines[0].endswith(" tok/s")
    assert lines[1] == "sampled tokens:"
    assert len(lines) == 2 + 3
