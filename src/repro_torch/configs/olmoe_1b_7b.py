"""OLMoE-1B-7B — MoE LM, 64 experts top-8, per-expert d_ff=1024. [arXiv:2409.02060; hf]"""

from repro_torch.configs import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    head_dim=128,
    mlp_act="swiglu",
    n_experts=64,
    top_k=8,
    rope_theta=10_000.0,
)

SMOKE = ArchConfig(
    name="olmoe-1b-7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=64,
    vocab_size=512,
    head_dim=16,
    mlp_act="swiglu",
    n_experts=8,
    top_k=2,
)
