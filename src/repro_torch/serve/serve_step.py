"""Serving-step factories: prefill and decode programs per family — the
port of the reference's ``serve/serve_step.py``. Decode caches:

  transformer — KVCache stacked [L, B, Hkv, C, Dh]; C = context length
  hymba       — HymbaCache: ring buffers (SWA) + full caches (global layers)
                + SSM states
  xlstm       — XLSTMCache: O(1) recurrent state (no KV at all)
  whisper     — WhisperCache: decoder self cache + precomputed cross K/V

Each decode step writes its family's cache in place. The ``ssm`` prefill is
the forward's last logits with no state, as in the reference: its decode
starts from ``init_cache``. :func:`grow_cache` gives a prefill's cache room
for the decode steps that follow.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import get_model


def make_prefill_step(cfg: ArchConfig, attn_impl: str = "auto"):
    """fn(params, batch) -> (last_logits [B, 1, V], cache-or-state).
    ``batch`` holds ``"tokens"`` [B, S] (working slots in hier_ps mode), in
    hier_ps mode ``"working_table"``, for a VLM ``"image_embeds"`` [B, n_img,
    d] and for the audio family ``"frames"`` [B, n_frames, d]."""
    model = get_model(cfg)

    def step(params, batch):
        kwargs = {}
        if cfg.embedding_mode == "hier_ps":
            kwargs["working_table"] = batch["working_table"]
        if cfg.family == "vlm":
            kwargs["image_embeds"] = batch["image_embeds"]
        if cfg.family == "audio":
            return model.prefill(cfg, params, batch["tokens"], batch["frames"],
                                 attn_impl=attn_impl, **kwargs)
        if cfg.family == "ssm":
            logits, _ = model.forward(cfg, params, batch["tokens"], **kwargs)
            return logits[:, -1:], None
        return model.prefill(cfg, params, batch["tokens"], attn_impl=attn_impl, **kwargs)

    return step


def make_decode_step(cfg: ArchConfig, attn_impl: str = "naive"):
    """fn(params, batch, cache, pos) -> (logits [B, 1, V], cache).

    ``batch["token"]``: [B, 1] int (working slot in hier_ps mode);
    ``pos``: int — current context length (the ``ssm`` family takes none)."""
    model = get_model(cfg)

    def step(params, batch, cache, pos):
        kwargs = {}
        if cfg.embedding_mode == "hier_ps":
            kwargs["working_table"] = batch["working_table"]
        if cfg.family == "ssm":
            return model.decode_step(cfg, params, batch["token"], cache, **kwargs)
        return model.decode_step(cfg, params, batch["token"], cache, pos,
                                 attn_impl=attn_impl, **kwargs)

    return step


def grow_cache(cfg: ArchConfig, cache, steps: int, *, batch: int, device="cuda"):
    """The prefill's decode cache with room for ``steps`` more positions: the
    transformer's KV cache and whisper's self cache padded; hymba's global
    caches padded (its rings and mamba states need none: this equals its
    ``prefill(max_len=n_meta + S + steps)``); for the ``ssm`` family, whose
    prefill keeps no state, ``init_cache(cfg, batch)``."""
    import torch.nn.functional as F

    from repro_torch.models.attention import KVCache
    from repro_torch.models.hymba import HymbaCache
    from repro_torch.models.whisper import WhisperCache

    def pad(kv):
        return KVCache(*(F.pad(a, (0, 0, 0, steps)) for a in kv))

    if cfg.family == "hybrid":
        return HymbaCache(cache.swa, pad(cache.glb), cache.ssm_swa, cache.ssm_glb)
    if cfg.family == "audio":
        return WhisperCache(pad(cache.self_kv), cache.cross_kv)
    if cfg.family == "ssm":
        return get_model(cfg).init_cache(cfg, batch, device=device)
    return pad(cache)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
