"""Gemma-7B [arXiv:2403.08295]: GeGLU, head_dim=256, MHA (kv=16), 256k vocab,
tied + scaled embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    mlp_act="geglu", rope_theta=1e4,
    tie_embeddings=True, emb_scale=True,
    skip_shapes=("long_500k",),
)
