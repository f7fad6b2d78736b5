"""Kernels: the port's hand-written kernels' device time a traced step,
in ms.  They are the kernels whose outermost scope is the anonymous
namespace every ``kernels/csrc/*.cu`` file compiles them in (PyTorch's
own sit under ``at::``, cuBLAS's have no namespace)."""
import re

OURS = re.compile(r"^(?:void\s+)?\(anonymous namespace\)::")


def read(record):
    summary, steps = record["trace"], record["window"]["traced_steps"]
    if summary is None or not steps:
        return None
    ours = sum(sec for name, (_, sec) in summary.kernels.items()
               if OURS.search(name))
    return 1e3 * ours / steps if ours else None
