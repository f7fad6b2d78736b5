"""The check refuses what it must.  At a test's size on the CPU, with the
harness's look for a card skipped, the rest of a run is driven (set-up,
warm-up, window, reference) with the timed path broken underneath, and
``correct`` comes out false for each fault a training cell on one card can
have: a step that returns its state unchanged, and half of the batch left
out with the mean taken over the rest.  The control, the reference put in
the program's place with its products in fp8, is refused as well, and a
sound run is not."""
import time
import types

import pytest
import torch

from perfbench import check, faults
from perfbench.drivers import train
from perfbench.reference import common
from perfbench.stream import ZipfStream
from perfbench.tests import tiny

SEED = 2 ** 31 + 101
CPU = torch.device("cpu")


def drive(monkeypatch, workload, fault=None):
    cell = tiny.cell(workload)
    if fault is not None:
        build = train.build

        def broken(*args, **kw):
            trainer, *rest = build(*args, **kw)
            trainer.step_fn = fault(trainer.step_fn)
            return (trainer, *rest)
        monkeypatch.setattr(train, "build", broken)
    args = types.SimpleNamespace(seed=SEED, seconds=0.2, trace=0)
    window, prog, _, _, stream = train.measure(cell, args, time.time(), CPU)
    assert window["steps"] >= 1
    return train.reference_check(cell, SEED, stream, prog, window, CPU)


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_sound_run_is_correct(monkeypatch, workload):
    ok, compared = drive(monkeypatch, workload)
    assert ok, compared


@pytest.mark.parametrize("fault", [faults.unchanged, faults.half_batch],
                         ids=["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_fault_is_refused(monkeypatch, workload, fault):
    ok, compared = drive(monkeypatch, workload, fault)
    assert not ok, compared


@pytest.mark.parametrize("workload", list(tiny.CELLS))
def test_control_is_refused(workload):
    cell = tiny.cell(workload)
    tr = cell.traffic
    stream = ZipfStream(SEED, tr["seq_len"], tr["batch"], cell.config["vocab"])
    batches = [stream.global_batch_at(s) for s in range(tr["check_steps"])]
    run = lambda kind: common.train_steps(cell.config, tr["optimizer"],
                                          batches, SEED, CPU,
                                          common.Precision(kind))
    ok, compared = check.verdict(check.numbers(run("fp8"), run("fp32")),
                                 check.load_limits(cell.limits_path), True)
    assert not ok, compared


def test_calibration_reads_every_number():
    from perfbench import calibrate

    cell = tiny.cell("falcon-mamba-7b.train-2x4096")
    out = calibrate.calibrate(cell, [SEED], 1, CPU, emit=lambda line: None)
    row = out["rows"][0]
    assert row["sound"] and row["worst"]["left_out"] == []
    for kind in ("lower", "control", "half_batch"):
        assert set(out[kind]) == {"loss_gap", "grad_gap", "change_gap"}
    # the control and the fault read above the sound program on every number
    for k, v in out["lower"].items():
        assert out["control"][k] > v and out["half_batch"][k] > v, k
