"""GQA attention block: projections + RoPE + cache plumbing — the port of
the reference's ``models/attention.py`` for its three dense-LM modes:

  train    — full-sequence causal attention, no cache
  prefill  — full-sequence causal attention, emits this segment's K/V
  decode   — new tokens against a cache (kv_len = cache_pos + S)

The sliding-window ring cache and encoder-decoder cross attention belong to
the hybrid and audio slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamSpec, apply_rope, rope_tables


class KVCache(NamedTuple):
    k: torch.Tensor  # [B, Hkv, C, Dh] (stacked: [L, B, Hkv, C, Dh])
    v: torch.Tensor


def attention_schema(cfg: ArchConfig, layers: int | None = None, rope: bool = True) -> dict:
    """Schema for stacked attention projections (leading ``layers`` dim)."""
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    L = cfg.n_layers if layers is None else layers
    stack = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    return {
        "wq": ParamSpec(stack + (d, H * hd), lax_ + ("embed", "heads"), fan_axis=len(stack)),
        "wk": ParamSpec(stack + (d, Hkv * hd), lax_ + ("embed", "kv_heads"), fan_axis=len(stack)),
        "wv": ParamSpec(stack + (d, Hkv * hd), lax_ + ("embed", "kv_heads"), fan_axis=len(stack)),
        "wo": ParamSpec(stack + (H * hd, d), lax_ + ("heads", "embed"), fan_axis=len(stack)),
    }


def attention_block(
    x: torch.Tensor,  # [B, S, d]
    p: dict,  # one layer's {wq, wk, wv, wo}
    cfg: ArchConfig,
    *,
    positions: torch.Tensor,  # [S] absolute positions of x
    causal: bool = True,
    window: int = 0,
    rope: bool = True,
    impl: str = "auto",
    cache: Optional[KVCache] = None,
    cache_pos: Optional[int] = None,  # write position (decode)
    ring: bool = False,
    q_offset: int = 0,
    kv_len: int | None = None,
    cross_kv: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    return_kv: bool = False,  # cache-less prefill: emit this segment's K/V
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """-> (output [B, S, d], cache). With a ``cache``, this segment's K/V are
    written into it **in place** at ``cache_pos`` (the reference's
    ``dynamic_update_slice`` makes a new array; updating in place saves a
    copy of the whole cache per step) and the same cache is returned. A
    write past the cache's end raises, where JAX would clamp the position."""
    if ring:
        raise NotImplementedError("the sliding-window ring cache belongs to the hybrid slice")
    if cross_kv is not None:
        raise NotImplementedError("cross attention belongs to the audio slice")
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    q = (x @ p["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd).transpose(1, 2)
    if rope:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is None and return_kv:
        new_cache = KVCache(k, v)
    if cache is not None:
        C = cache.k.shape[2]
        pos = int(cache_pos)
        if pos < 0 or pos + S > C:
            raise ValueError(f"cache write at positions [{pos}, {pos + S}) outside a cache of {C}")
        cache.k[:, :, pos:pos + S] = k
        cache.v[:, :, pos:pos + S] = v
        new_cache = cache
        k, v = cache.k, cache.v
        causal = False
        kv_len = pos + S

    out = kops.attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv_len, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p["wo"], new_cache


def init_kv_cache(cfg: ArchConfig, batch: int, length: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, Hkv, length, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
