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
contiguous 1/M of the q heads' columns (column-parallel), ``wk``/``wv`` its
kv heads when the rules put ``kv_heads`` on ``model`` and the whole
projection otherwise, ``wo`` the matching rows (row-parallel, its partial
products summed over the group). Rank r attends with the whole q heads
[floor(r H / M), floor((r + 1) H / M)) (``common.block_range``): where M
divides H those are its columns; where the rules cut ``wq``'s columns inside
a head (H % M != 0), q is all-gathered over the group and the rank takes its
heads, and its heads' output is gathered back and cut to its columns for
``wo`` (``common.gather_over_model`` both ways, whose backward sums the
ranks' parts), where GSPMD reshards in the reference. A rank may own no
head (whisper-tiny's 6 at a model axis of 8): it attends nothing. Replicated
kv heads are cut to the ones the rank's heads read, and the index of its
first head inside its kv group goes to the kernel (``head_offset``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (
    ParamSpec,
    apply_rope,
    block_range,
    copy_to_model,
    gather_over_model,
    kv_heads_read,
    local_range,
    model_rank_and_size,
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
    Hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    cols = p["wq"].shape[-1]  # this rank's columns of the q heads
    tp = cols < cfg.n_heads * hd
    h_lo, h_hi = local_range(cfg.n_heads, cols // hd)  # the q heads this rank attends with
    H = h_hi - h_lo
    inside = tp and cfg.n_heads % model_rank_and_size()[1] != 0  # wq cut inside a head
    xp = copy_to_model(x) if tp and not entered else x  # the q heads' region

    # reference :65, q on "heads_sep": this rank's q heads
    q = xp @ p["wq"]
    if inside:  # the rules leave "heads_sep" whole here: the rank's heads from every rank's columns
        q = gather_over_model(q, -1)[..., h_lo * hd:h_hi * hd]
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    kv_lo, kv_hi, off = kv_heads_read(h_lo, h_hi, g) if tp else (0, Hkv, 0)
    kv_whole = p["wk"].shape[-1] == Hkv * hd  # replicated (or no tensor parallelism)
    if cross_kv is None:
        if not kv_whole or not tp:  # this rank's kv heads, or no tensor parallelism
            xk, n_kv = (x, Hkv) if kv_whole else (xp, p["wk"].shape[-1] // hd)
            k = (xk @ p["wk"]).reshape(B, S, n_kv, hd).transpose(1, 2)
            v = (xk @ p["wv"]).reshape(B, S, n_kv, hd).transpose(1, 2)
        else:  # replicated kv: every rank's q heads read it, so its gradient sums them
            if entered:  # x's gradient is summed at the caller's entry: sum wk's and wv's
                k, v = x @ copy_to_model(p["wk"]), x @ copy_to_model(p["wv"])
            else:
                k, v = copy_to_model(x @ p["wk"]), copy_to_model(x @ p["wv"])
            k = k.reshape(B, S, Hkv, hd).transpose(1, 2)[:, kv_lo:kv_hi]
            v = v.reshape(B, S, Hkv, hd).transpose(1, 2)[:, kv_lo:kv_hi]
    else:  # encoder-decoder cross attention: kv precomputed from the encoder
        k, v = cross_kv
        if tp and kv_whole and k.shape[1] == Hkv:  # replicated: the heads this rank's read
            k, v = copy_to_model(k)[:, kv_lo:kv_hi], copy_to_model(v)[:, kv_lo:kv_hi]
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

    if H:
        out = kops.attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                             kv_len=kv_len, impl=impl, group=g, head_offset=off)
    else:  # a rank with no head attends nothing; k and v stay in the graph, so
        # their backward's collectives run on every rank
        out = q + (k.sum() + v.sum()).to(q.dtype)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    if inside:  # back to this rank's columns, wo's rows
        out = _heads_to_columns(out, cfg.n_heads, hd, cols)
    out = out @ p["wo"]
    # reference :105, the output on "embed_act": the heads' partial sums
    return (reduce_from_model(out) if tp else out), new_cache


def _heads_to_columns(out: torch.Tensor, n_heads: int, hd: int, cols: int) -> torch.Tensor:
    """This rank's heads' output [B, S, H_r * hd] -> its contiguous block of
    ``cols`` columns of all ``n_heads`` heads' output: every rank's part,
    padded to the largest, gathered over ``model`` and put back in head
    order."""
    r, M = model_rank_and_size()
    B, S, _ = out.shape
    width = -(-n_heads // M) * hd  # the most heads a rank owns
    parts = gather_over_model(torch.nn.functional.pad(out, (0, width - out.shape[-1])), -1)
    parts = parts.reshape(B, S, M, width)
    owned = [hi - lo for lo, hi in (block_range(n_heads, i, M) for i in range(M))]
    heads = torch.cat([parts[:, :, i, :n * hd] for i, n in enumerate(owned)], dim=-1)
    return heads[..., r * cols:(r + 1) * cols]


def init_kv_cache(cfg: ArchConfig, batch: int, length: int, n_layers: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_layers, batch, Hkv, length, hd)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))
