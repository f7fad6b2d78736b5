"""Carry the reference's objects across into the port's.

Each function reads a reference object by duck typing -- dataclass fields
through ``dataclasses.asdict``, NamedTuple fields through ``_asdict`` --
and never imports the reference package, so a test can build its inputs
once and feed the same values to both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.calibration import CorrectionFactors, TechConstants
from repro_torch.core.ir import MatmulOp, Workload
from repro_torch.core.macro import MacroSpec
from repro_torch.core.pruning import DesignSpace
from repro_torch.core.template import AcceleratorConfig


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
