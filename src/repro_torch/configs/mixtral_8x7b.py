"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE with sliding-window
attention -> runs long_500k (O(window) cache).  FSDP on: 47B params."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    mlp_act="swiglu", rope_theta=1e6, window=4096,
    pattern=("moe",),
    n_experts=8, moe_top_k=2,
    fsdp=True,
)
