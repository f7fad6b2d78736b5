"""The port's ``obs`` spans inside a torch profiler, on the CPU: a span opened
while a profiler runs lands in its trace as a ``user_annotation`` event of
its name; with no profiler a span reads one flag of torch and calls
nothing (so no CUDA call and no synchronise); a training step gives the same
loss, gradient norm and parameters, bit for bit, with and without a
profiler; and ``model.remat`` opens only while a checkpointed layer is
recomputed inside the backward.
"""
import contextlib
import json
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream, to_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import build_model
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import AdamW, AdamWConfig

#: the spans a training step opens, each once (``model.remat`` once a layer)
STEP_SPANS = ("step.forward", "step.backward", "step.optimizer",
              "model.head", "model.loss", "model.remat", "optim.schedule",
              "optim.norm", "optim.guard", "optim.apply")


@pytest.fixture
def fresh_tracer(monkeypatch):
    """A process-wide tracer of this test's own."""
    tr = obs.Tracer(capacity=4096, jsonl_path="")
    monkeypatch.setattr(obs_trace, "_TRACER", tr)
    return tr


def test_span_lands_in_the_profiler_trace(tmp_path, fresh_tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("unit.outer", widget="a"):
            with obs.span("unit.inner"):
                torch.ones(4).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation"}
    assert {"unit.outer", "unit.inner"} <= set(notes)
    outer, inner = notes["unit.outer"], notes["unit.inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    # the ring buffer holds them as before
    assert [e["name"] for e in fresh_tracer.events()] == \
        ["unit.inner", "unit.outer"]


class _Probe:
    """A stand-in for ``torch`` that records each attribute read, truth
    test and call."""

    def __init__(self, path: str, seen: list):
        self._path, self._seen = path, seen

    def __getattr__(self, name):
        self._seen.append(f"{self._path}.{name}")
        return _Probe(f"{self._path}.{name}", self._seen)

    def __bool__(self):
        self._seen.append(f"bool({self._path})")
        return False

    def __call__(self, *args, **kw):
        self._seen.append(f"{self._path}()")


def test_span_without_profiler_reads_one_flag_and_calls_nothing(monkeypatch):
    seen: list = []
    monkeypatch.setitem(sys.modules, "torch", _Probe("torch", seen))
    tr = obs.Tracer(capacity=4, jsonl_path="")
    with tr.span("unit.quiet"):
        pass
    flag = "torch.autograd.profiler._is_profiler_enabled"
    assert seen == ["torch.autograd", "torch.autograd.profiler", flag,
                    f"bool({flag})"]
    assert [e["name"] for e in tr.events()] == ["unit.quiet"]


def _never(*args, **kw):
    raise AssertionError("record_function entered with no profiler running")


def _step(arch: str, microbatches: int, profiled: bool):
    cfg = get_arch(arch).reduced()
    model = build_model(cfg)
    params = model.init(5, torch.device("cpu"), trainable=True)
    optimizer = AdamW(AdamWConfig(peak_lr=1e-2, warmup_steps=2,
                                  total_steps=8))
    state = optimizer.init(params)
    step = make_train_step(model, optimizer, microbatches=microbatches)
    stream = SyntheticLMStream(DataConfig(seq_len=16, global_batch=2,
                                          vocab=cfg.vocab, seed=3))
    batch = to_device(stream.global_batch_at(0), "cpu")
    ctx = profile(activities=[ProfilerActivity.CPU]) if profiled else \
        contextlib.nullcontext()
    with ctx as prof:
        params, state, metrics = step(params, state, batch,
                                      skip_nonfinite=True)
    names = {e.name for e in prof.events()} if profiled else set()
    return (metrics["loss"], metrics["grad_norm"],
            [p.detach().clone() for p in params.parameters()], names)


@pytest.mark.parametrize("arch,microbatches", [
    ("yi-6b", 1), ("falcon-mamba-7b", 1), ("yi-6b", 2)])
def test_profiled_step_is_bit_equal(arch, microbatches, monkeypatch,
                                    fresh_tracer):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _never)
    loss, gnorm, params, _ = _step(arch, microbatches, profiled=False)
    monkeypatch.undo()
    ploss, pgnorm, pparams, names = _step(arch, microbatches, profiled=True)
    assert torch.equal(loss, ploss)
    assert torch.equal(gnorm, pgnorm)
    assert all(torch.equal(a, b) for a, b in zip(params, pparams))
    assert set(STEP_SPANS) <= names


def test_remat_span_opens_only_in_the_recompute(fresh_tracer):
    cfg = get_arch("yi-6b").reduced()
    assert cfg.remat
    model = build_model(cfg)
    params = model.init(5, torch.device("cpu"), trainable=True)
    stream = SyntheticLMStream(DataConfig(seq_len=16, global_batch=2,
                                          vocab=cfg.vocab, seed=3))
    batch = to_device(stream.global_batch_at(0), "cpu")
    count = lambda: sum(e["name"] == "model.remat"
                        for e in fresh_tracer.events())
    loss, _ = model.loss(params, batch)
    assert count() == 0
    torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)
    assert count() == cfg.n_layers
    with torch.no_grad():
        model.loss(params, batch)
    assert count() == cfg.n_layers
