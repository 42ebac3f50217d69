"""Architecture configs and input-shape specs.

Every assigned architecture is a selectable config (``--arch <id>``). Each
config file exports ``CONFIG`` (the exact published numbers) and ``SMOKE``
(a reduced same-family config used by CPU smoke tests). The registry here
resolves ids to configs.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional

# ---------------------------------------------------------------------------
# Shape specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) input-shape cell.

    kind:
      train   -> lowers train_step
      prefill -> lowers serve_prefill (full-sequence forward, builds KV cache)
      decode  -> lowers serve_step (1 new token against a cache of seq_len)
    """

    name: str
    kind: str
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # --- MLP activation: swiglu | squared_relu | gelu
    mlp_act: str = "swiglu"
    rope_theta: float = 10_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- hybrid / ssm ---
    ssm_state: int = 0
    window: int = 0  # sliding-window size (0 = full attention)
    global_attn_layers: tuple[int, ...] = ()  # layers w/ full attn in SWA archs
    n_meta_tokens: int = 0  # hymba learned meta tokens
    slstm_every: int = 0  # xLSTM: one sLSTM block every k blocks (0 = none)
    proj_factor: float = 2.0  # xLSTM mLSTM up-projection factor
    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    n_frames: int = 0  # stub frontend: precomputed frame embeddings
    # --- vlm ---
    n_image_tokens: int = 0  # stub frontend: precomputed patch embeddings
    # --- embedding handling: dense (pjit) | hier_ps (paper technique) ---
    embedding_mode: str = "hier_ps"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """True when decode state does not grow quadratically w/ context."""
        return self.family in ("ssm", "hybrid")

    def supports(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            # long-context decode needs sub-quadratic attention.
            return self.subquadratic
        return True

    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embedding + backbone [+ experts])."""
        d, hd = self.d_model, self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * q + 2 * d * kv + q * d  # wq wk wv wo
        if self.mlp_act == "swiglu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        norms = 2 * d
        if self.family == "ssm":
            # mLSTM block params (qkv + gates + out) approximation via actual
            # shapes used in models/xlstm.py
            dp = int(d * self.proj_factor)
            block = d * dp * 2 + 3 * dp * hd * self.n_heads // max(self.n_heads, 1)
            block = 2 * d * dp + 3 * dp * dp + dp * d + norms
            per_layer = block
        elif self.family == "hybrid":
            dssm = 2 * d  # mamba inner dim
            ssm = d * 2 * dssm + dssm * (2 * self.ssm_state + 1) + dssm * d
            per_layer = attn + ssm + d * self.d_ff * 3 + norms
        elif self.is_moe:
            per_layer = attn + self.n_experts * 3 * d * self.d_ff + d * self.n_experts + norms
            if active_only:
                per_layer = attn + self.top_k * 3 * d * self.d_ff + d * self.n_experts + norms
        else:
            per_layer = attn + mlp_dense + norms
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        enc = self.encoder_layers * (attn + mlp_dense + norms)
        return emb + head + self.n_layers * per_layer + enc


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS = (
    "yi-9b",
    "granite-20b",
    "nemotron-4-340b",
    "phi3-mini-3.8b",
    "olmoe-1b-7b",
    "phi3.5-moe-42b-a6.6b",
    "hymba-1.5b",
    "xlstm-1.3b",
    "whisper-tiny",
    "pixtral-12b",
)

_MODULES = {
    "yi-9b": "yi_9b",
    "granite-20b": "granite_20b",
    "nemotron-4-340b": "nemotron_4_340b",
    "phi3-mini-3.8b": "phi3_mini_3p8b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "hymba-1.5b": "hymba_1p5b",
    "xlstm-1.3b": "xlstm_1p3b",
    "whisper-tiny": "whisper_tiny",
    "pixtral-12b": "pixtral_12b",
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE


def all_cells() -> list[tuple[str, str]]:
    """Every supported (arch_id, shape_name) dry-run cell."""
    cells = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if cfg.supports(s):
                cells.append((a, s.name))
    return cells


__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "get_smoke_config",
    "all_cells",
    "replace",
]
