"""Phi-3.5-MoE-42B (A6.6B) — MoE LM, 16 experts top-2, per-expert d_ff=6400.

[hf:microsoft/Phi-3.5-MoE-instruct]
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    head_dim=128,
    mlp_act="swiglu",
    n_experts=16,
    top_k=2,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    head_dim=8,
    mlp_act="swiglu",
    n_experts=4,
    top_k=2,
)
