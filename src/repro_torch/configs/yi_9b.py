"""Yi-9B — llama-arch dense GQA LM. [arXiv:2403.04652; hf]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    head_dim=128,
    mlp_act="swiglu",
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=8,
    mlp_act="swiglu",
)
