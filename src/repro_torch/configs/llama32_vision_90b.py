"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision]: text backbone
with gated cross-attention image layers every 5th layer; the vision tower is
a STUB (input_specs provides projected patch embeddings).  FSDP on: 90B."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256,
    mlp_act="swiglu", rope_theta=5e5,
    pattern=("cross", "self", "self", "self", "self"),
    n_memory=1024,
    fsdp=True,
    skip_shapes=("long_500k",),
)
