"""The port's trainer on the CPU: a run checkpointed at step 6 and resumed
to step 8 gives the uninterrupted run's losses exactly (same batches,
restored fp32 masters and AdamW state); the history records the
reference's fields; checkpoints land every ``ckpt_every`` steps and at the
end; the batch iterator's thread is stopped when training ends; and
``python -m repro_torch.launch.train --device cpu --smoke`` runs."""
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.optim import AdamWConfig
from repro_torch.train import CheckpointManager, Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
CFG = get_arch("yi-6b").reduced()


def _trainer(tmp, steps, **kw):
    tcfg = TrainerConfig(steps=steps, seq_len=16, global_batch=2,
                         ckpt_every=kw.pop("ckpt_every", 3),
                         ckpt_dir=str(tmp), log_every=1, seed=2,
                         optimizer=AdamWConfig(peak_lr=1e-2, warmup_steps=2,
                                               total_steps=8), **kw)
    return Trainer(CFG, tcfg, "cpu")


def _threads() -> int:
    return sum(1 for t in threading.enumerate() if t.daemon and t.is_alive())


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    before = _threads()
    full = _trainer(tmp_path / "full", 8)
    logs = []
    params, opt = full.train(log=logs.append)
    assert _threads() == before
    assert [r["step"] for r in full.history] == list(range(1, 9))
    assert set(full.history[0]) == {"step", "loss", "grad_norm", "lr",
                                    "skipped", "sec_per_step"}
    assert not any(r["skipped"] for r in full.history)
    assert full.history[-1]["loss"] < full.history[0]["loss"]
    assert opt["step"] == 8
    assert CheckpointManager(str(tmp_path / "full")).latest_step() == 8
    assert sorted(os.listdir(tmp_path / "full")) == [
        "step_000000003", "step_000000006", "step_000000008"]
    assert any(line.startswith("checkpoint @") for line in logs)

    first = _trainer(tmp_path / "resumed", 6)
    first.train(log=lambda s: None)
    again = _trainer(tmp_path / "resumed", 8)
    p2, o2 = again.train(log=lambda s: None)
    assert [r["step"] for r in again.history] == [7, 8]
    assert [r["loss"] for r in first.history + again.history] == \
        [r["loss"] for r in full.history]
    for (n, a), b in zip(params.named_parameters(), p2.parameters()):
        assert torch.equal(a, b), n
    assert o2["step"] == 8


def test_train_cli_smoke(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "falcon-mamba-7b", "--smoke", "--steps", "2", "--batch", "2",
         "--seq", "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--set", "n_layers=1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("step     1 loss")
    assert lines[-1] == "straggler steps: 0"
    assert os.listdir(tmp_path) == ["step_000000002"]


def test_the_card_is_the_default(tmp_path):
    trainer = Trainer(CFG, TrainerConfig(steps=1, ckpt_dir=str(tmp_path)))
    assert trainer.device == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            trainer.init_state()
