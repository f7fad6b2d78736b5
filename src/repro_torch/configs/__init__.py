"""Per-architecture configs (``get_arch(<id>)``).  See base.py for the registry."""
from repro_torch.configs.base import ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, all_archs, get_arch

__all__ = ["ARCH_IDS", "SHAPES", "ArchConfig", "ShapeSpec", "all_archs", "get_arch"]
