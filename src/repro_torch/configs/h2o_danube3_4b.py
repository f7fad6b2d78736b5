"""H2O-Danube3-4B [arXiv:2401.16818]: llama+mistral mix with sliding-window
attention -> the 500k-decode cell runs (O(window) cache)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, head_dim=120,
    d_ff=10240, vocab=32000,
    mlp_act="swiglu", rope_theta=1e4,
    window=4096,
)
