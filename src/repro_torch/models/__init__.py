"""Model zoo substrate: the 10 assigned architectures in PyTorch.

Every architecture is built from the shared blocks in ``layers.py`` /
``moe.py`` / ``ssm.py`` and assembled by ``transformer.py``; ``model.py``
exposes the uniform factory the serving engine uses.  Prefill attention
and the Mamba scan launch the hand-written ``flash_attention`` and
``selective_scan`` kernels on the card.
"""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
