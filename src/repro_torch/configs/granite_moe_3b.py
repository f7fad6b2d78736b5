"""Granite-MoE-3B-A800M [hf:ibm-granite]: 40-expert top-8 MoE with tiny
(512) expert FFNs -- the operator-merging showcase.  24 heads don't divide
the 16-wide model axis -> attention replicated (shard_attn=False)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    mlp_act="swiglu", rope_theta=1e4,
    pattern=("moe",),
    n_experts=40, moe_top_k=8,
    tie_embeddings=True,
    shard_attn=False,
    skip_shapes=("long_500k",),
)
