"""xLSTM-1.3B — recurrent LM of mLSTM blocks with one sLSTM per 8 (7:1 ratio).

d_ff=0: mixing happens inside the (s/m)LSTM blocks via a 2x up-projection.
[arXiv:2405.04517]
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=0,  # inner dim / n_heads, resolved in the model
    slstm_every=8,
    proj_factor=2.0,
)

SMOKE = ArchConfig(
    name="xlstm-1.3b-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    slstm_every=2,
    proj_factor=2.0,
)
