"""Pixtral-12B — VLM: mistral-nemo decoder backbone; ViT frontend is a stub.

``input_specs()`` provides precomputed patch embeddings (batch,
n_image_tokens, d_model) already projected into the decoder width.
[hf:mistralai/Pixtral-12B-2409]
"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=131072,
    head_dim=128,
    mlp_act="swiglu",
    rope_theta=1_000_000.0,
    n_image_tokens=256,
)

SMOKE = ArchConfig(
    name="pixtral-12b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=8,
    mlp_act="swiglu",
    n_image_tokens=8,
)
