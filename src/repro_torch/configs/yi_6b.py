"""Yi-6B [arXiv:2403.04652]: llama-arch GQA decoder."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000,
    mlp_act="swiglu", rope_theta=5e6,
    skip_shapes=("long_500k",),   # pure full attention (see DESIGN.md)
)
