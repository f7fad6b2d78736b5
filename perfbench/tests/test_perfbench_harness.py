"""The harness: it finds a cell's parts by name, loads no JAX, and gives
no result without a card or without the port."""
import ast
import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.tiny import ROOT

BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def copy_benchmark(dest):
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_every_cell_resolves():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        cell = harness.find_cell(w["name"])
        assert harness.driver(cell.traffic["kind"]).run
        assert cell.limits_path.is_file()
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(harness.reader(m["name"]))
    for m in man["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_new_config_traffic_and_metric_need_only_new_files(tmp_path):
    copy_benchmark(tmp_path)
    before = digests(tmp_path / "perfbench")
    bench = tmp_path / "perfbench"
    cfg = json.loads((bench / "configs" / "yi-6b.json").read_text())
    cfg.update(name="yi-6b-8l", n_layers=8)
    (bench / "configs" / "yi-6b-8l.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "train-1x16384.json").read_text())
    tr.update(seq_len=4096, batch=4)
    (bench / "traffic" / "train-4x4096.json").write_text(json.dumps(tr))
    (bench / "limits" / "yi-6b-8l.train-4x4096.json").write_text(
        (bench / "limits" / "yi-6b.train-1x16384.json").read_text())
    (bench / "metrics" / "steps.train.py").write_text(
        "def read(record):\n    return record['window']['steps']\n")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "yi-6b-8l", "source": "x",
                           "file": "perfbench/configs/yi-6b-8l.json",
                           "reduced": ["n_layers"], "why": "x"})
    man["workloads"].append({"name": "yi-6b-8l.train-4x4096",
                             "config": "yi-6b-8l", "traffic": "train-4x4096",
                             "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "steps.train", "unit": "steps",
                             "better": "higher", "source": "host_clock",
                             "layer": "trainer step loop",
                             "moves": "train_tokens_per_s",
                             "workloads": ["yi-6b-8l.train-4x4096"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    cell = harness.find_cell("yi-6b-8l.train-4x4096", tmp_path)
    assert cell.config["n_layers"] == 8 and cell.traffic["batch"] == 4
    assert [m["name"] for m in cell.per_layer][-1] == "steps.train"
    assert harness.reader("steps.train", tmp_path)(
        {"window": {"steps": 5}}) == 5
    after = digests(tmp_path / "perfbench")
    assert {k: v for k, v in after.items() if k in before} == before


def imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "repro_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "repro"]
    with pytest.raises(harness.RunError):
        harness.guard_modules()


def run_cell(cwd, root):
    return subprocess.run(
        [sys.executable, str(root / "perfbench" / "run.py"), "--workload",
         "yi-6b.train-1x16384", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    proc = run_cell(ROOT, ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_no_port_no_result(tmp_path):
    copy_benchmark(tmp_path)
    proc = run_cell(tmp_path, tmp_path)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "repro_torch" in proc.stderr
