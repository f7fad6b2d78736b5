"""The attribution of a traced run to the program's spans
(``perfbench/spans.py``) on a hand-made Chrome trace, its readings, the
tiny cells' traced run on the CPU, and the ``data_queue_wait_ms.train``
reader of the port's span tracer."""
import dataclasses
import time
import types

import pytest

from perfbench import harness, spans, trace
from perfbench.tests.test_perfbench_trace import EVENTS, ev


def launch(name, ts, corr, tid=1, cat="cuda_runtime"):
    e = ev(name, cat, ts, 5, tid)
    e["args"] = {"correlation": corr}
    return e


def kernel(ts, dur, corr, name="void at::native::kernel()"):
    e = ev(name, "kernel", ts, dur, tid=7)
    e["args"] = {"correlation": corr}
    return e


# the program's spans on the main thread (1) and the autograd engine's (2):
# the backward's launches and the remat recompute come from thread 2
SPANNED = [
    ev(trace.WINDOW_SPAN, "user_annotation", 0, 2000),
    ev("train.step", "user_annotation", 0, 1500),
    ev("step.forward", "user_annotation", 100, 300),
    ev("model.head", "user_annotation", 300, 80),
    ev("step.backward", "user_annotation", 400, 600),
    ev("model.remat", "user_annotation", 450, 150, tid=2),
    ev("step.optimizer", "user_annotation", 1000, 500),
    ev("optim.guard", "user_annotation", 1100, 100),
    ev("data.queue_get", "user_annotation", 1500, 50),
    ev("data.pin_copy", "user_annotation", 1550, 30),
    launch("cudaLaunchKernel", 110, 1),
    launch("cudaLaunchKernel", 310, 2),
    launch("cudaLaunchKernelExC", 460, 3, tid=2),
    launch("cudaLaunchKernel", 700, 4, tid=2),
    launch("cudaLaunchKernel", 1010, 5),
    launch("cuLaunchKernelEx", 1210, 6, cat="cuda_driver"),
    launch("cudaMemcpy", 375, 20),
    launch("cudaStreamSynchronize", 650, 21, tid=2),
    launch("cudaStreamSynchronize", 1120, 22),
    launch("cudaDeviceSynchronize", 1600, 23),
    launch("cudaMemcpyAsync", 1610, 24),
    kernel(120, 100, 1),
    kernel(320, 50, 2),
    kernel(470, 150, 3),
    kernel(620, 200, 4),
    kernel(1020, 80, 5),
    kernel(1210, 240, 6),
    kernel(1450, 5, 99),                  # no launch
]

#: the spans the port opens in a training step
PROGRAM_SPANS = ("step.forward", "step.backward", "step.optimizer",
                 "model.head", "model.loss", "model.remat", "optim.schedule",
                 "optim.norm", "optim.guard", "optim.apply", "data.queue_get",
                 "data.pin_copy")


def test_attribute():
    att = spans.attribute(SPANNED)
    by = att["by_span"]
    assert set(by) == {"step.forward", "model.head", "step.backward",
                       "model.remat", "step.optimizer", "optim.guard",
                       "data.queue_get", "data.pin_copy", spans.OUTSIDE}
    us = pytest.approx
    expect = {  # launches, device, syncs, self syncs, idle, self idle (us)
        "step.forward": (2, 150, 1, 0, 150, 120),
        "model.head": (1, 50, 1, 1, 30, 30),
        "step.backward": (2, 350, 1, 1, 250, 230),
        "model.remat": (1, 150, 0, 0, 20, 20),
        "step.optimizer": (2, 320, 1, 0, 175, 75),
        "optim.guard": (0, 0, 1, 1, 100, 100),
        "data.queue_get": (0, 0, 0, 0, 50, 50),
        "data.pin_copy": (0, 0, 0, 0, 30, 30),
        spans.OUTSIDE: (0, 0, 1, 1, 520, 520),
    }
    for name, (n, dev, syncs, own, idle, own_idle) in expect.items():
        st = by[name]
        assert (st["launches"], st["syncs"], st["self_syncs"]) == \
            (n, syncs, own), name
        assert st["device_s"] == us(dev * 1e-6), name
        assert st["idle_s"] == us(idle * 1e-6), name
        assert st["self_idle_s"] == us(own_idle * 1e-6), name
    assert by["step.forward"]["calls"] == 1
    assert by["step.forward"]["host_s"] == us(300e-6)
    assert by[spans.OUTSIDE]["calls"] == 0
    assert att["unattributed_s"] == us(5e-6)
    assert att["kernels_s"] == us(825e-6)
    # the window as trace.summarize reads it, and every idle microsecond
    # with one innermost owner
    s = trace.summarize(SPANNED)
    assert (att["busy_s"], att["window_s"]) == (us(s.busy_s), us(s.window_s))
    assert sum(st["self_idle_s"] for st in by.values()) == \
        us(s.window_s - s.busy_s)


def test_readings():
    att = spans.attribute(SPANNED)
    got = spans.readings(att, 2)          # 2 traced steps
    assert got["forward_ms"] == (
        pytest.approx(0.075),
        "1 launches a step; model.head 33.3 %, model.loss 0.0 %")
    assert got["backward_ms"][0] == pytest.approx(0.175)
    assert got["remat_ms"] == (pytest.approx(0.075),
                               "0.5 recomputes, 0.5 launches a step")
    assert got["optimizer_ms"][0] == pytest.approx(0.16)
    assert got["optimizer_ms"][1].endswith("optim.apply 0.000 ms")
    assert got["host_syncs"] == (
        pytest.approx(2.0), "model.head 0.5, optim.guard 0.5, "
        "step.backward 0.5, trainer loop 0.5")
    assert got["step_idle_ms"] == (
        pytest.approx((150 + 250 + 175) / 2 * 1e-3),
        "step.backward 0.115 ms, step.forward 0.060 ms, optim.guard 0.050 "
        "ms; outside spans 0.260 ms")
    assert got["queue_wait_ms"] == (pytest.approx(0.025),
                                    "data.pin_copy 0.015 ms a step")
    # past 1 % of the kernels' time unattributed, device time is not read
    for share, missing in ((0.0099, False), (0.0101, True)):
        got = spans.readings(dict(att, unattributed_s=share * 825e-6), 2)
        for key in ("forward_ms", "backward_ms", "remat_ms", "optimizer_ms"):
            value, note = got[key]
            assert (value is None) == missing, (key, share)
            assert ("matched no launch" in note) == missing
    # a program without the spans: nothing to read
    assert spans.readings(spans.attribute(EVENTS), 2) == {}


def test_traced_run_holds_every_program_span(monkeypatch):
    """The tiny cell's traced run on the CPU: each program span once a
    traced step (``model.remat`` once a layer), and the data reader reads
    the port's tracer over the window's steps."""
    import torch

    from perfbench.drivers import train
    from perfbench.tests import tiny
    from repro_torch import obs
    from repro_torch.obs import trace as obs_trace

    monkeypatch.setattr(obs_trace, "_TRACER",
                        obs.Tracer(capacity=4096, jsonl_path=""))
    kept, undo = spans.keep_events()
    try:
        cell = tiny.cell("falcon-mamba-7b.train-2x4096")
        args = types.SimpleNamespace(seed=2 ** 31 + 7, seconds=0.01, trace=1)
        window, *_ = train.measure(cell, args, time.time(),
                                   torch.device("cpu"))
    finally:
        undo()
    by = spans.attribute(kept[-1])["by_span"]
    assert set(by) == set(PROGRAM_SPANS) | {spans.OUTSIDE}
    for name in PROGRAM_SPANS:
        layers = cell.config["n_layers"] if name == "model.remat" else 1
        assert by[name]["calls"] == layers * train.TRACE_STEPS, name
    rec = {"cell": cell, "trace": window["trace"], "window": window,
           "card": None}
    value, note = harness.reader("data_queue_wait_ms.train")(rec)
    assert value >= 0 and note.startswith("data.pin_copy")
    # one data.queue_get a step taken, warm-up included; more steps than
    # spans: nothing to read
    steps = window["attempted"]
    assert harness.reader("data_queue_wait_ms.train")(
        dict(rec, window=dict(window, steps=steps)))[0] >= 0
    assert harness.reader("data_queue_wait_ms.train")(
        dict(rec, window=dict(window, steps=steps + 1))) is None


def test_data_reader_without_program_spans(monkeypatch):
    from repro_torch import obs
    from repro_torch.obs import trace as obs_trace

    monkeypatch.setattr(obs_trace, "_TRACER",
                        obs.Tracer(capacity=16, jsonl_path=""))
    rec = {"window": {"steps": 2}}
    assert harness.reader("data_queue_wait_ms.train")(rec) is None
