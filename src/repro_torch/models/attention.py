"""GQA attention block: projections + RoPE + cache plumbing — the port of
the reference's ``models/attention.py``. One module serves all four
execution modes:

  train    — full-sequence causal attention, no cache
  prefill  — full-sequence causal attention, emits this segment's K/V
  decode   — new tokens against a cache (kv_len = cache_pos + S)
  ring     — one token against a sliding-window ring buffer (slot = pos % W)

and encoder-decoder cross attention (``cross_kv``: K/V given, no K/V
projection and no RoPE).

Under tensor parallelism (``common.set_model_group``) the block reads its
placement from the local weights' shapes: ``wq`` holds this rank's
contiguous q heads (column-parallel), ``wk``/``wv`` its kv heads when the
rules put ``kv_heads`` on ``model`` and the whole projection otherwise,
``wo`` the matching rows (row-parallel, its partial products summed over
the group).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    copy_to_model,
    local_range,
    reduce_from_model,
    rope_tables,
)


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
    entered: bool = False,  # x has entered the model region (the caller's copy_to_model)
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """-> (output [B, S, d], cache). With a ``cache``, this segment's K/V are
    written into it **in place** at ``cache_pos`` (the ring: at slot
    ``cache_pos % W``) — the reference's ``dynamic_update_slice`` makes a new
    array; updating in place saves a copy of the whole cache per step — and
    the same cache is returned. A write past the cache's end raises, where
    JAX would clamp the position."""
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H, Hkv = p["wq"].shape[-1] // hd, cfg.n_kv_heads  # H: this rank's q heads
    h_lo, h_hi = local_range(cfg.n_heads, H)
    xp = copy_to_model(x) if H < cfg.n_heads and not entered else x  # the q heads' region

    # reference :65, q on "heads_sep": this rank's q heads
    q = (xp @ p["wq"]).reshape(B, S, H, hd).transpose(1, 2)
    if cross_kv is None:
        kv_local = p["wk"].shape[-1] < Hkv * hd
        if kv_local or H == cfg.n_heads:  # this rank's kv heads, or no tensor parallelism
            xk, Hkv = (xp, p["wk"].shape[-1] // hd) if kv_local else (x, Hkv)
            k = (xk @ p["wk"]).reshape(B, S, Hkv, hd).transpose(1, 2)
            v = (xk @ p["wv"]).reshape(B, S, Hkv, hd).transpose(1, 2)
        else:  # replicated kv: every rank's q heads read it, so its gradient sums them
            if entered:  # x's gradient is summed at the caller's entry: sum wk's and wv's
                k, v = x @ copy_to_model(p["wk"]), x @ copy_to_model(p["wv"])
            else:
                k, v = copy_to_model(x @ p["wk"]), copy_to_model(x @ p["wv"])
            k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
            v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
            k, v = _kv_for_heads(k, cfg, h_lo, h_hi), _kv_for_heads(v, cfg, h_lo, h_hi)
            Hkv = k.shape[1]
    else:  # encoder-decoder cross attention: kv precomputed from the encoder
        k, v = cross_kv
    if rope and cross_kv is None:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if cache is None and return_kv:
        new_cache = KVCache(k, v)
    if cache is not None:
        C = cache.k.shape[2]
        pos = int(cache_pos)
        slot = pos % C if ring else pos  # ring: sliding-window buffer, slot = pos % W
        if pos < 0 or slot + S > C:
            raise ValueError(f"cache write at positions [{slot}, {slot + S}) outside a cache "
                             f"of {C}")
        cache.k[:, :, slot:slot + S] = k
        cache.v[:, :, slot:slot + S] = v
        new_cache = cache
        k, v = cache.k, cache.v
        causal = False  # every filled slot is past context
        if ring:
            kv_len = min(pos + 1, C)
            window = 0  # the ring itself enforces the window
        else:
            kv_len = pos + S

    out = kops.attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                         kv_len=kv_len, impl=impl)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    out = out @ p["wo"]
    # reference :105, the output on "embed_act": the heads' partial sums
    return (reduce_from_model(out) if H < cfg.n_heads else out), new_cache


def _kv_for_heads(kv: torch.Tensor, cfg: ArchConfig, lo: int, hi: int) -> torch.Tensor:
    """The kv heads [B, Hkv, S, Dh] that q heads [lo, hi) read (q head i
    reads kv head i // (H / Hkv)): a contiguous run, each read by the same
    number of local q heads (``launch.sharding.check_model_parallel``
    refuses the axes where it would not be)."""
    g = cfg.n_heads // cfg.n_kv_heads
    return kv[:, lo // g:(hi - 1) // g + 1]


def init_kv_cache(cfg: ArchConfig, batch: int, length: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, Hkv, length, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
