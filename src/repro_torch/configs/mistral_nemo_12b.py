"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: 128k-context GQA,
head_dim 128 (not d_model/n_heads), 131k vocab.  FSDP on: 12B params."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072,
    mlp_act="swiglu", rope_theta=1e6,
    fsdp=True,
    skip_shapes=("long_500k",),
)
