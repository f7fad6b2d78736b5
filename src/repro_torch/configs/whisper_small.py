"""Whisper-small [arXiv:2212.04356]: encoder-decoder; the conv audio
frontend is a STUB (input_specs provides 1500 precomputed frame embeddings).
Decoder shapes run mechanically at the assigned 32k even though the real
model caps at 448 positions (dry-run exercises sharding, not semantics)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab=51865,
    mlp_act="gelu", norm="layernorm", rope_theta=None,
    pattern=("dec_self_cross",),
    n_memory=1500, encoder_layers=12, max_decode_len=32768,
    shard_attn=False,
    skip_shapes=("long_500k",),
)
