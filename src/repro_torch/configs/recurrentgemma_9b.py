"""RecurrentGemma-9B [arXiv:2402.19427]: Griffin hybrid, RG-LRU + local
attention 1:2 pattern; 38 = 12 x (rglru, rglru, local_attn) + 2 remainder
rglru layers.  Sub-quadratic: runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    mlp_act="geglu", rope_theta=1e4, window=2048,
    pattern=("rglru", "rglru", "local_attn"),
    d_inner=4096, ssm_conv=4,
    tie_embeddings=True, emb_scale=True,
)
