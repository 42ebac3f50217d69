"""Whisper-tiny — encoder-decoder audio transformer, backbone only.

The conv frontend is a stub per the task spec: ``input_specs()`` provides
precomputed frame embeddings of shape (batch, n_frames, d_model).
[arXiv:2212.04356]
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    mlp_act="gelu",
    n_frames=1500,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke",
    family="audio",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    mlp_act="gelu",
    n_frames=32,
)
