"""Carry the reference's objects across into the port's.

Each function reads a reference object by duck typing -- dataclass fields
through ``dataclasses.asdict``, NamedTuple fields through ``_asdict``, the
models' pytrees as nested dicts of numpy arrays -- and never imports the
reference package, so a test can build its inputs once and feed the same
values to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.calibration import CorrectionFactors, TechConstants
from repro_torch.core.compiler import Instr
from repro_torch.core.ir import MatmulOp, Workload
from repro_torch.core.macro import MacroSpec
from repro_torch.core.pruning import DesignSpace
from repro_torch.core.systolic import SystolicConfig
from repro_torch.core.template import AcceleratorConfig
from repro_torch.models import transformer as tf


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def macro_spec(obj) -> MacroSpec:
    """A reference ``MacroSpec`` as the port's."""
    return MacroSpec(**_fields(obj))


def tech_constants(obj) -> TechConstants:
    """A reference ``TechConstants`` as the port's."""
    return TechConstants(**_fields(obj))


def correction_factors(obj) -> CorrectionFactors:
    """A reference ``CorrectionFactors`` as the port's."""
    return CorrectionFactors(**_fields(obj))


def measurement_records(records) -> list[dict]:
    """Reference ``MeasurementRecord`` dicts as the port's (the schema is
    the same: kernel, bucket, tiling, us, flops, bytes, seed)."""
    keys = ("kernel", "bucket", "tiling", "us", "flops", "bytes", "seed")
    return [{k: r[k] for k in keys} for r in records]


def matmul_op(obj) -> MatmulOp:
    """A reference ``MatmulOp`` as the port's."""
    return MatmulOp(**_fields(obj))


def workload(obj) -> Workload:
    """A reference ``Workload`` (and its operators) as the port's."""
    return Workload(name=obj.name, ops=tuple(matmul_op(op) for op in obj.ops))


def design_space(obj) -> DesignSpace:
    """A reference ``DesignSpace`` as the port's."""
    return DesignSpace(**{k: tuple(v) for k, v in _fields(obj).items()})


def accelerator_config(obj) -> AcceleratorConfig:
    """A reference ``AcceleratorConfig`` as the port's."""
    return AcceleratorConfig(**_fields(obj))


def systolic_config(obj) -> SystolicConfig:
    """A reference ``SystolicConfig`` as the port's."""
    return SystolicConfig(**_fields(obj))


def instr(obj) -> Instr:
    """A reference compiler ``Instr`` (one instruction of a trace) as the
    port's."""
    return Instr(**_fields(obj))


def job_params(obj, dtype: torch.dtype = torch.float64,
               device="cpu") -> cost_model.JobParams:
    """A reference ``JobParams`` whose leaves are numpy arrays (stacked
    along a leading job axis) as the port's tensors."""
    leaves = obj._asdict()
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    return cost_model.JobParams(
        ops=t(leaves["ops"]),
        macro=cost_model.MacroParams(
            *[t(v) for v in leaves["macro"]._asdict().values()]),
        tech=cost_model.TechParams(
            *[t(v) for v in leaves["tech"]._asdict().values()]),
        allowed=t(leaves["allowed"]),
        obj_code=t(leaves["obj_code"]),
        area_budget=t(leaves["area_budget"]),
        bw=t(leaves["bw"]),
    )


# ---------------------------------------------------------------------- #
# the LM substrate: parameter and cache pytrees
# ---------------------------------------------------------------------- #
def _tensor(x, device="cpu") -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included, which torch
    cannot read directly; its values are exact in float32) as a tensor of
    the same dtype."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layers(stack: dict, pattern: tuple[str, ...], n_layers: int) -> list:
    """The reference's scanned groups (leaves stacked [G, ...]) and
    remainder layers as one list of per-layer trees, in layer order."""
    full, rem = divmod(n_layers, len(pattern))
    out = [_map(lambda a, g=g: a[g], stack["groups"][f"b{i}_{kind}"])
           for g in range(full) for i, kind in enumerate(pattern)]
    return out + [stack["rem"][f"b{i}_{kind}"]
                  for i, kind in enumerate(pattern[:rem])]


def _lm_tree(np_tree: dict, cfg) -> dict:
    """The reference's LM pytree (groups stacked [G, ...]) in the port's
    layout (one tree per layer, in layer order), leaves as they were."""
    tree = {k: v for k, v in np_tree.items() if k not in ("stack", "encoder")}
    tree["stack"] = {"layers": _layers(np_tree["stack"], cfg.pattern,
                                       cfg.n_layers)}
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        tree["encoder"] = {
            "pos": enc["pos"], "ln_final": enc["ln_final"],
            "stack": {"layers": _layers(enc["stack"], ("enc_self",),
                                        cfg.encoder_layers)}}
    return tree


def _leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_leaves(fn, v) for v in tree]
    return fn(tree)


def lm_params(np_tree: dict, cfg, device="cpu",
              trainable: bool = False) -> tf.ParamTree:
    """The reference's ``lm_init`` pytree (numpy leaves, groups stacked
    [G, ...]) as the port's parameters on ``device``: each leaf in the
    dtype the port serves it in (``transformer.storage_dtype``), or, with
    ``trainable``, fp32 as the reference trains it, requiring gradients.
    The same function carries a gradient pytree of the parameters across
    (``trainable=True``), leaf for leaf."""
    tree = _leaves(lambda x: _tensor(x, device).float(),
                   _lm_tree(np_tree, cfg))
    if trainable:
        return tf.ParamTree(tree, trainable=True)
    return tf.ParamTree(tf.to_storage(tree, cfg))


def adamw_state(np_state: dict, cfg, device="cpu") -> dict:
    """The reference's AdamW state (``{"m", "v", "step"}``, the moments
    pytrees shaped as the parameters) as the port's: the moments as lists
    in the order of the port's ``ParamTree.parameters()`` (fp32), the step
    an int."""
    def flat(np_tree):
        return [p.detach() for p in lm_params(np_tree, cfg, device,
                                               trainable=True).parameters()]
    return {"m": flat(np_state["m"]), "v": flat(np_state["v"]),
            "step": int(np.asarray(np_state["step"]))}


def lm_cache(np_tree: dict, cfg, device="cpu") -> dict:
    """The reference's decode caches (``init_cache`` / ``prefill``'s,
    numpy leaves) in the port's layout: one cache per layer, lengths and
    the step as ints."""
    def leaf(x):
        a = np.asarray(x)
        return int(a) if a.ndim == 0 else _tensor(a, device)

    def layer(c):
        if c is None:
            return None
        return {k: layer(v) if isinstance(v, dict) else leaf(v)
                for k, v in c.items()}
    return {"stack": [layer(c) for c in _layers(
        np_tree["stack"], cfg.pattern, cfg.n_layers)],
        "step": int(np.asarray(np_tree["step"]))}
