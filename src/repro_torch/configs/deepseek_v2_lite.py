"""DeepSeek-V2-Lite [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]:
27 layers of latent attention (MLA: 16 heads, query/key width 128 + 64
rope, value width 128, keys and values rebuilt per head from a 512-wide
normed latent, the rope key shared by the heads; no query latent) with
YaRN rope scaling (factor 40 over 4,096 positions); layer 0 a dense SwiGLU
MLP of 10,944, layers 1-26 MoE: 64 routed SwiGLU experts of 1,408,
softmax scores, greedy top-6 without renormalisation (the held-expert
layer never renormalises), and two shared
experts (one SwiGLU of 2,816).  Published size; a chip's expert-parallel
share sets ``n_experts`` below ``router_experts`` (the benchmark's
``perfbench/configs/deepseek-v2-lite.json``).  No load-balancing loss
(``moe_aux_coef`` 0): the published model balances by a sequence-level
loss this port does not have."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=192,
    d_ff=1408, vocab=102400,
    mlp_act="swiglu", rope_theta=1e4,
    pattern=("mla_dense",) + ("mla_moe",) * 26,
    n_experts=64, moe_top_k=6, shared_d_ff=2816, dense_d_ff=10944,
    moe_aux_coef=0.0,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128,
    yarn_factor=40.0, yarn_original_len=4096, yarn_beta_fast=32.0,
    yarn_beta_slow=1.0, yarn_mscale=0.707,
    skip_shapes=("long_500k",),
)
