"""Hymba-1.5B — hybrid: parallel attention + mamba heads in every layer.

Sliding-window attention in most layers, full attention in {first, middle,
last}; 128 learned meta tokens prepended. [arXiv:2411.13676; hf]
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    mlp_act="swiglu",
    ssm_state=16,
    window=1024,
    global_attn_layers=(0, 15, 31),
    n_meta_tokens=128,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=2,
    d_model=64,
    n_heads=5,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    mlp_act="swiglu",
    ssm_state=4,
    window=32,
    global_attn_layers=(0,),
    n_meta_tokens=8,
)
