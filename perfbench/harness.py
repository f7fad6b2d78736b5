"""The benchmark's harness: it finds a cell's parts by name from its entry
in ``BENCHMARK.json`` and prints the result.

For workload ``w`` with configuration ``c`` and traffic ``t``:

- the configuration is ``perfbench/configs/<c>.json``;
- the traffic mix is ``perfbench/traffic/<t>.json``; its ``kind`` names
  the driver, ``perfbench/drivers/<kind>.py``, whose ``run`` measures
  the cell;
- the limits of the check are ``perfbench/limits/<w>.json``;
- each per-layer metric ``m`` is read by ``perfbench/metrics/<m>.py``,
  whose ``read(record)`` returns a number, a (number, note) pair, or
  None where the run has nothing for it to read.

So a configuration, a mix, a kind or a metric is added with new files
and manifest entries only.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(Exception):
    """A run that cannot give a result: its message goes to stderr and
    the process exits with ``code``."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class Cell:
    workload: str
    entry: dict              # the workload's entry in BENCHMARK.json
    config: dict
    traffic: dict
    limits_path: Path
    end_to_end: list         # the manifest's metric entries for this cell
    per_layer: list
    root: Path


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end values, the record the
    per-layer readers read, the check and the device."""
    end_to_end: dict
    record: dict
    correct: bool
    compared: dict
    attempted: int
    failed: int
    device: dict
    noise: dict
    breakdown: dict | None = None


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, root: Path = ROOT) -> Cell:
    man = load_json(root / "BENCHMARK.json")
    entries = [w for w in man["workloads"] if w["name"] == workload]
    if not entries:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    bench = root / "perfbench"
    return Cell(
        workload=workload, entry=entry,
        config=load_json(bench / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits_path=bench / "limits" / f"{workload}.json",
        end_to_end=[m for m in man["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in man["per_layer"] if _applies(m, workload)],
        root=root)


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{kind}")


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """The forbidden top-level names among the loaded modules, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def guard_modules() -> None:
    found = forbidden_modules()
    if found:
        raise RunError("the run loaded " + ", ".join(found)
                       + ": no part of a run may import JAX or the JAX "
                       "package", code=5)


def need_cards(chips: int) -> None:
    """Refuse a run without ``chips`` CUDA cards: there is no CPU
    fallback."""
    import torch

    if not torch.cuda.is_available():
        raise RunError("no CUDA card: this benchmark measures the card and "
                       "has no CPU fallback", code=3)
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell needs {chips} CUDA cards, this machine has "
                       f"{torch.cuda.device_count()}", code=3)


def need_program(root: Path) -> None:
    if not (root / "src" / "repro_torch" / "__init__.py").is_file():
        raise RunError(f"{root / 'src' / 'repro_torch'} is missing: the "
                       "benchmark measures that package", code=4)
    if str(root / "src") not in sys.path:
        sys.path.insert(0, str(root / "src"))


def card_sample() -> dict | None:
    """The card's SM clock, power draw and limit and temperature now, by
    ``nvidia-smi`` (None where it gives nothing)."""
    keys = ("clocks_sm_mhz", "power_w", "power_limit_w", "temp_c")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return dict(zip(keys, (float(x) for x in out.split(","))))
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed place inside the checkout
    (the port's own libraries go to ``build/repro_torch``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def result_line(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The last line of standard output, the compared numbers last."""
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(m["name"], cell.root)(out.record)
            if isinstance(value, tuple):          # (value, a note on it)
                value, note = value
                out.noise.setdefault("notes", {})[m["name"]] = note
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in out.end_to_end]
        if missing:
            raise RunError(f"the driver gave no {', '.join(missing)}")
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": out.device}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["compared"] = out.compared
    return line


def main(args, t_start: float, root: Path = ROOT) -> int:
    try:
        cell = find_cell(args.workload, root)
        set_cache_dirs(root)
        need_program(root)
        need_cards(cell.entry["chips"])
        out = driver(cell.traffic["kind"]).run(cell, args, t_start)
        guard_modules()
        line = result_line(cell, out, bool(args.trace))
    except RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    print(json.dumps({"noise": out.noise}))
    for k, v in out.compared.items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
