"""Falcon-Mamba-7B [arXiv:2410.05355]: pure Mamba-1, attention-free,
O(1)-state decode -> runs long_500k."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, head_dim=1,
    d_ff=0, vocab=65024,
    rope_theta=None,
    pattern=("mamba",),
    ssm_state=16, ssm_conv=4, d_inner=8192, dt_rank=256,
)
