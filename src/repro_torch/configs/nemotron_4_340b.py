"""Nemotron-4-340B — dense GQA LM with squared-ReLU MLP. [arXiv:2402.16819]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    head_dim=192,
    mlp_act="squared_relu",
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="nemotron-4-340b-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=384,
    vocab_size=512,
    head_dim=16,
    mlp_act="squared_relu",
)
