"""The timing scripts under ``scripts/`` call ``chip_smoke.py``'s helpers
with arguments those helpers take.  The scripts run only on the card, so a
helper whose signature changed would otherwise fail there first:
``kernel_times.py`` called ``strategy_eval_rows`` with four arguments too
few after the helper gained ``ref``, ``cost_model`` and ``fp64_shapes``."""
import ast
import inspect
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

SCRIPTS = sorted(p for p in (ROOT / "scripts").glob("*.py")
                 if "import chip_smoke as cs" in p.read_text())


def _calls(path: pathlib.Path):
    """Each ``cs.<name>(...)`` call of a script: (name, line, positional
    count, keyword names), or None where it unpacks ``*`` or ``**``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id == "cs":
            if any(isinstance(a, ast.Starred) for a in node.args) or \
                    any(k.arg is None for k in node.keywords):
                continue
            yield (node.func.attr, node.lineno, len(node.args),
                   [k.arg for k in node.keywords])


@pytest.mark.parametrize("path", SCRIPTS, ids=lambda p: p.name)
def test_script_calls_bind_to_chip_smoke_helpers(path):
    for name, line, n_pos, keywords in _calls(path):
        fn = getattr(chip_smoke, name)
        if not callable(fn) or isinstance(fn, type):
            continue
        try:
            inspect.signature(fn).bind(*range(n_pos),
                                       **dict.fromkeys(keywords))
        except TypeError as e:
            pytest.fail(f"{path.name}:{line}: cs.{name}(...): {e}")
