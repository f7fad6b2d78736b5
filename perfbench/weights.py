"""The benchmark's weights: the layout of the port's trainable tree (names,
shapes, initial distributions), worked out from a configuration file and
the block kinds under ``reference/blocks/``, and the values, drawn from
the seed on the device in a few large calls.

The normal leaves lie end to end in one index space; chunk ``c`` of it is
one ``torch.randn`` call from a generator seeded with ``(seed, c)``.  So
the values at any place can be drawn again, a chunk at a time, to measure
how far training moved the parameters without keeping a copy of them.
Both the program and the reference start from these values.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

#: elements a draw (1 GiB of fp32)
CHUNK = 1 << 28


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    init: tuple          # ("normal", std) | ("const", value) | ("log_arange",)
    product: bool        # a matrix-product weight (counts in model FLOPs)

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def layer_kinds(cfg: dict) -> list[str]:
    """Each layer's block kind: whole periods of ``pattern``, then its
    prefix."""
    pattern = list(cfg["pattern"])
    full, rem = divmod(cfg["n_layers"], len(pattern))
    return pattern * full + pattern[:rem]


def block(kind: str):
    """The plain reference module of a block kind."""
    return importlib.import_module(f"perfbench.reference.blocks.{kind}")


def layout(cfg: dict) -> list[Leaf]:
    """Every leaf of the trainable tree, in the port's order of
    ``named_parameters``: the embedding, the untied head, the layers,
    the final norm."""
    d, v = cfg["d_model"], cfg["vocab"]
    leaves = [Leaf("embed", (v, d), ("normal", 0.02), False),
              Leaf("lm_head", (d, v), ("normal", 1 / math.sqrt(d)), True)]
    for i, kind in enumerate(layer_kinds(cfg)):
        leaves += [dataclasses.replace(leaf, name=f"stack.layers.{i}.{leaf.name}")
                   for leaf in block(kind).leaves(cfg)]
    leaves.append(Leaf("ln_final.scale", (d,), ("const", 0.0), False))
    return leaves


def chunk_seed(seed: int, chunk: int) -> int:
    """A 63-bit generator seed for one chunk of the draws."""
    ss = np.random.SeedSequence([seed % 2 ** 63, chunk])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _const(leaf: Leaf, device) -> torch.Tensor:
    if leaf.init[0] == "const":
        return torch.full(leaf.shape, float(leaf.init[1]), dtype=torch.float32,
                          device=device)
    # log(1..S) along the last axis (Mamba's A = -exp(a_log))
    s = leaf.shape[-1]
    row = torch.log(torch.arange(1, s + 1, dtype=torch.float32, device=device))
    return row.expand(leaf.shape).contiguous()


def draws(leaves: list[Leaf], seed: int, device):
    """Yield ``(leaf index, first element, values)``: every element of
    every leaf once, fp32 on ``device``; the normal leaves' values from
    ``CHUNK``-sized ``torch.randn`` calls."""
    device = torch.device(device)
    normal = [(i, leaf) for i, leaf in enumerate(leaves)
              if leaf.init[0] == "normal"]
    total = sum(leaf.numel for _, leaf in normal)
    k, start = 0, 0                # leaf, its first element not yet given
    for c in range(0, total, CHUNK):
        gen = torch.Generator(device=device)
        gen.manual_seed(chunk_seed(seed, c // CHUNK))
        buf = torch.randn(min(CHUNK, total - c), generator=gen, device=device,
                          dtype=torch.float32)
        used = 0
        while used < buf.numel():
            i, leaf = normal[k]
            n = min(leaf.numel - start, buf.numel() - used)
            yield i, start, buf[used:used + n] * leaf.init[1]
            used += n
            start += n
            if start == leaf.numel:
                k, start = k + 1, 0
        del buf
    for i, leaf in enumerate(leaves):
        if leaf.init[0] != "normal":
            yield i, 0, _const(leaf, device).reshape(-1)


@torch.no_grad()
def make(leaves: list[Leaf], seed: int, device) -> list[torch.Tensor]:
    """The initial values of every leaf, fp32 on ``device``."""
    out = [torch.empty(leaf.shape, dtype=torch.float32, device=device)
           for leaf in leaves]
    for i, start, vals in draws(leaves, seed, device):
        out[i].view(-1)[start:start + vals.numel()] = vals
    return out


@torch.no_grad()
def change_norms(leaves: list[Leaf], current: list[torch.Tensor], seed: int
                 ) -> list[float]:
    """Each leaf's norm of (current - initial), the initial values drawn
    again a chunk at a time."""
    device = current[0].device
    sums = torch.zeros(len(leaves), dtype=torch.float64, device=device)
    for i, start, vals in draws(leaves, seed, device):
        now = current[i].detach().reshape(-1)[start:start + vals.numel()]
        sums[i] += torch.sum(torch.square(now.float() - vals), dtype=torch.float64)
    return torch.sqrt(sums).tolist()


def tree(leaves: list[Leaf], values: list[torch.Tensor]) -> dict:
    """Nested dicts and lists of ``values`` by the leaves' dotted names
    (``stack.layers.3.attn.wq``), the shape of the port's ``ParamTree``."""
    root: dict = {}
    for leaf, val in zip(leaves, values):
        *path, last = leaf.name.split(".")
        node = root
        for key, nxt in zip(path, path[1:] + [last]):
            fresh = lambda: [] if nxt.isdigit() else {}
            if isinstance(node, list):
                key = int(key)
                while len(node) <= key:
                    node.append(fresh())
                node = node[key]
            else:
                node = node.setdefault(key, fresh())
        node[last] = val
    return root


def param_count(cfg: dict) -> int:
    """Every parameter of the trainable tree."""
    return sum(leaf.numel for leaf in layout(cfg))


def model_flops_per_token(cfg: dict, seq_len: int) -> float:
    """A training step's model FLOPs a token: 6 x the matrix-product
    weights (the head in, the embedding lookup out) plus each block
    kind's own (causal attention's 6 T H dh); recomputation is not
    counted."""
    mats = sum(leaf.numel for leaf in layout(cfg) if leaf.product)
    return 6.0 * mats + sum(block(kind).flops_per_token(cfg, seq_len)
                            for kind in layer_kinds(cfg))
