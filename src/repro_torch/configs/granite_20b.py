"""Granite-20B-Code — dense LM with MQA (kv=1). [arXiv:2405.04324; hf]

d_ff = 4 x d_model implies a non-gated MLP (gpt-bigcode lineage); with gelu
the count lands on ~20B as published.
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    head_dim=128,
    mlp_act="gelu",
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="granite-20b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=160,
    vocab_size=512,
    head_dim=8,
    mlp_act="gelu",
)
