"""Phi-3-mini-3.8B — dense MHA (kv == heads) RoPE SwiGLU LM. [arXiv:2404.14219]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    head_dim=96,
    mlp_act="swiglu",
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="phi3-mini-3.8b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    mlp_act="swiglu",
)
