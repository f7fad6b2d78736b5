"""The trace reduction on a hand-made Chrome trace, and the readers on
its summary."""
import pytest

from perfbench import harness, trace

ANON = "void (anonymous namespace)::"


def ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    ev(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
    ev("train.data", "user_annotation", 0, 100),
    ev("train.step", "user_annotation", 100, 800),
    ev("train.sync", "user_annotation", 900, 100),
    ev("aten::item", "cpu_op", 920, 60),
    ev("aten::mm", "cpu_op", 150, 20),
    # device: 100-400 and 300-500 overlap, 600-850; a kernel outside
    ev(ANON + "tc::flash_kernel<128, 128, 64>(CUtensorMap)", "kernel", 100, 300),
    ev("void at::native::reduce_kernel<512, 1>(float*)", "kernel", 300, 200),
    ev(ANON + "dq_kernel<128>(CUtensorMap)", "kernel", 600, 250),
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 880, 10),
    ev("nvjet_tst_192x192", "kernel", 2000, 50),
]


def test_summary():
    s = trace.summarize(EVENTS)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx((400 + 250 + 10) * 1e-6)
    assert s.kernels[ANON + "dq_kernel<128>(CUtensorMap)"] == [1, 250e-6]
    assert "nvjet_tst_192x192" not in s.kernels
    # the gaps: 0-100 (data), 500-600 (step), 850-880 (step), 890-1000
    # (sync, inside aten::item)
    assert [g[0] for g in s.idle_gaps] == [
        "train.sync > aten::item", "train.data", "train.step", "train.step"]
    assert s.idle_gaps[0][1] == pytest.approx(110e-6)
    assert s.device_ops[0] == ("_anonymous_namespace_::tc::flash_kernel_128_128_64_CUtensorMap_",
                               pytest.approx(300e-6))


def record(summary, workload="yi-6b.train-1x16384"):
    return {"cell": harness.find_cell(workload), "trace": summary,
            "window": {"data_wait_s": [0.001, 0.003], "untraced": None,
                       "traced_steps": 2},
            "card": None}


def test_readers():
    s = trace.summarize(EVENTS)
    rec = record(s)
    idle = harness.reader("device_idle_share.train")(rec)
    assert idle == pytest.approx(100 * (1 - 0.66))
    # the two anonymous-namespace kernels' 550 us over 2 traced steps
    assert harness.reader("kernel_ms.train")(rec) == pytest.approx(0.275)
    value, note = harness.reader("attention_roofline.train")(rec)
    assert value > 0 and "operations" in note
    assert harness.reader("scan_roofline.train")(rec) is None
    assert harness.reader("data_wait_ms.train")(rec) == pytest.approx(2.0)
    assert harness.reader("step_mfu.train")(rec) is None


def test_traced_window_ends_with_an_untraced_step():
    """A traced run keeps at least one step after the traced stretch,
    however short ``--seconds`` is: ``step_mfu.train`` reads them."""
    import time
    import types

    import torch

    from perfbench.drivers import train
    from perfbench.tests import tiny

    cell = tiny.cell("falcon-mamba-7b.train-2x4096")
    args = types.SimpleNamespace(seed=2 ** 31 + 7, seconds=0.01, trace=1)
    window, *_ = train.measure(cell, args, time.time(), torch.device("cpu"))
    assert window["steps"] == 1 + train.TRACE_STEPS + 1
    assert window["traced_steps"] == train.TRACE_STEPS
    assert window["untraced"]["tokens"] == 2 * 64
    rec = {"cell": cell, "trace": window["trace"], "window": window,
           "card": None}
    value, _ = harness.reader("step_mfu.train")(rec)
    assert value > 0
