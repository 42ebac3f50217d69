"""The port's kernel entry points, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. There is no other
fallback: nothing on the card quietly takes the plain path. Attention's
naive, blockwise and banded paths are plain PyTorch on either device, as
they are plain jnp in the reference; only its flash path is a kernel.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
from repro_torch.kernels.embedding_lookup import embedding_lookup_cuda, embedding_lookup_plain
from repro_torch.kernels.feature_extract import feature_extract_cuda, feature_extract_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_plain
from repro_torch.kernels.scatter_add import scatter_add_cuda_, scatter_add_plain_
from repro_torch.kernels.topk_mips import topk_mips_cuda, topk_mips_plain

KERNEL_WRAPPERS = {
    "topk_mips": topk_mips_cuda,
    "embedding_bag": embedding_bag_cuda,
    "scatter_add": scatter_add_cuda_,
    "fused_adagrad": adagrad_cuda,
    "feature_extract": feature_extract_cuda,
    "embedding_lookup": embedding_lookup_cuda,
    "flash_attention": flash_attention_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
              n_valid: int | None = None):
    """Top-k maximum-inner-product search -> (scores f32 [Q, k], indices
    i32 [Q, k]): descending score, ties by ascending corpus index,
    positions past the live corpus (``n_valid``, default all of
    ``corpus``) as (-inf, -1)."""
    if queries.is_cuda or corpus.is_cuda:
        return topk_mips_cuda(queries, corpus, k, n_valid=n_valid)
    return topk_mips_plain(queries, corpus, k, n_valid=n_valid)


def _scatter_add_into(table: torch.Tensor, sorted_ids: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """``scatter_add`` into ``table`` itself: for a caller that owns the
    table and nothing else reads it (the bag's backward into fresh zeros)."""
    if table.is_cuda:
        return scatter_add_cuda_(table, sorted_ids.to(torch.int32).contiguous(),
                                 grads.contiguous())
    return scatter_add_plain_(table, sorted_ids, grads)


def scatter_add(table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor, *,
                assume_sorted: bool = False) -> torch.Tensor:
    """``table[ids[i]] += grads[i]`` with duplicates accumulating in position
    order -> a new table. The kernel needs duplicate ids adjacent, so the
    ids are sorted stably unless the caller says they already are."""
    if not assume_sorted:
        ids, order = torch.sort(ids, stable=True)
        grads = grads[order]
    return _scatter_add_into(table.clone(), ids, grads)


def adagrad_update(params: torch.Tensor, accum: torch.Tensor, grads: torch.Tensor,
                   lr: float, *, eps: float = 1e-8):
    """Fused row-Adagrad on the working set -> new (params, accum); one flat
    pass over any shape."""
    if params.is_cuda:
        return adagrad_cuda(params, accum, grads.contiguous(), lr, eps)
    return adagrad_plain(params, accum, grads, lr, eps)


def feature_extract(raw: torch.Tensor, valid: torch.Tensor, *, n_keys: int, n_slots: int,
                    key_seed: int = 17, slot_seed: int = 31):
    """Hash raw feature ids into keys and slots -> (keys int64 holding u64
    bits, slot_of int32), both of ``raw``'s shape: ``key =
    splitmix64(raw ^ key_seed) % n_keys``, ``slot = splitmix64(key ^
    slot_seed) % n_slots``, key 0 / slot 0 where ``valid`` (read as ``!= 0``)
    is false. ``raw`` is int64 holding u64 bit patterns."""
    kw = dict(n_keys=int(n_keys), n_slots=int(n_slots), key_seed=int(key_seed),
              slot_seed=int(slot_seed))
    if raw.is_cuda or valid.is_cuda:
        if valid.dtype != torch.bool:
            valid = valid != 0
        return feature_extract_cuda(raw.contiguous(), valid.contiguous(), **kw)
    return feature_extract_plain(raw, valid, **kw)


class _EmbeddingBag(torch.autograd.Function):
    """The bag with its backward: the reference's ``_embedding_bag`` custom
    VJP. The gradient of a table row is the sum of the pooled gradients of
    the (example, slot) buckets its kept nonzeros fell in, accumulated
    through ``scatter_add`` (the kernel on the card)."""

    @staticmethod
    def forward(ctx, table, slot_ids, slot_of, valid, n_slots):
        ctx.n_slots = n_slots
        ctx.save_for_backward(slot_ids, slot_of, valid)
        ctx.table_shape = table.shape
        if table.is_cuda:
            return embedding_bag_cuda(
                table,
                slot_ids.to(torch.int32).contiguous(),
                slot_of.to(torch.int32).contiguous(),
                valid.contiguous(),
                n_slots,
            )
        return embedding_bag_plain(table, slot_ids, slot_of, valid, n_slots)

    @staticmethod
    def backward(ctx, g):
        slot_ids, slot_of, valid = ctx.saved_tensors
        B, nnz = slot_ids.shape
        D = ctx.table_shape[1]
        s = slot_of.long()
        # a nonzero the forward dropped (slot outside [0, n_slots)) gets no
        # gradient; the reference's take_along_axis clamps the slot instead
        kept = valid & (s >= 0) & (s < ctx.n_slots)
        idx = torch.where(kept, s, 0).reshape(B, nnz, 1).expand(B, nnz, D)
        grad_rows = torch.gather(g, 1, idx) * kept.unsqueeze(-1).to(g.dtype)
        flat_ids, order = torch.sort(slot_ids.reshape(-1), stable=True)
        zeros = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        d_table = _scatter_add_into(zeros, flat_ids, grad_rows.reshape(-1, D)[order])
        return d_table, None, None, None, None


def embedding_bag(table: torch.Tensor, slot_ids: torch.Tensor,
                  slot_of: torch.Tensor, valid: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """Fused gather + per-(example, slot) sum-pool -> [B, n_slots, D],
    differentiable in ``table``. ``valid`` is a mask, not weights: any dtype
    is read as ``!= 0``."""
    if valid.dtype != torch.bool:
        valid = valid != 0
    return _EmbeddingBag.apply(table, slot_ids, slot_of, valid, int(n_slots))


# --------------------------------------------------------------------------
# embedding lookup
# --------------------------------------------------------------------------


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[ids]`` -> [B, D], bit for bit; ids must lie in
    ``[0, N)``. The kernel takes ids as int32, as the reference casts them."""
    if table.is_cuda or ids.is_cuda:
        return embedding_lookup_cuda(table, ids.to(torch.int32).contiguous())
    return embedding_lookup_plain(table, ids)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Blockwise softmax attention forward (GQA, causal and window masks by
    absolute position, static ``q_offset``) -> [B, H, Sq, Dh] in q's dtype."""
    if q.is_cuda or k.is_cuda or v.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)


def attention_blockwise(
    q: torch.Tensor,  # [B, H, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,  # [B, Hkv, Skv, Dh]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: int | None = None,
    block_k: int = 512,
) -> torch.Tensor:
    """Streaming-softmax attention over KV blocks of ``block_k`` (the
    reference's ``lax.scan`` as a loop): memory O(Sq * block_k), fp32, GQA
    without repeating K/V, ``-inf`` masks with fully masked rows -> 0."""
    B, H, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    rep = H // Hkv
    bk = min(block_k, Skv)
    if Skv % bk != 0:  # pad K/V to a block multiple; padded keys masked out
        pad = bk - Skv % bk
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if kv_len is None:
            kv_len = Skv
        Skv = Skv + pad
    scale = 1.0 / (Dh**0.5)
    dev = q.device
    qf = q.float().reshape(B, Hkv, rep, Sq, Dh)
    kf, vf = k.float(), v.float()
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, rep, Sq), -torch.inf, device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, Dh), device=dev)
    for jk in range(Skv // bk):
        kblk, vblk = kf[:, :, jk * bk:(jk + 1) * bk], vf[:, :, jk * bk:(jk + 1) * bk]
        s = torch.einsum("bgrqd,bgkd->bgrqk", qf, kblk) * scale
        k_pos = jk * bk + torch.arange(bk, device=dev)
        mask = torch.ones((Sq, bk), dtype=torch.bool, device=dev)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        s = torch.where(mask, s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard -inf - -inf for fully masked rows
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bgrqk,bgkd->bgrqd", p, vblk)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).reshape(B, H, Sq, Dh).to(q.dtype)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int) -> torch.Tensor:
    """Causal sliding-window self-attention (``Sq == Skv``) by banded chunks:
    the queries of chunk ``i`` (of ``window`` positions) attend the keys of
    chunks ``[i-1, i]``, which exactly cover the ``(p - W, p]`` window, so
    compute is O(S * 2W) instead of O(S^2). fp32, ``-inf`` masks."""
    B, H, S, Dh = q.shape
    Hkv = k.shape[1]
    W = window
    if S % W != 0:  # pad the sequence to a chunk multiple (tail masked)
        pad = (0, 0, 0, W - S % W)
        F = torch.nn.functional
        return attention_banded(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), window=W)[:, :, :S]
    n = S // W
    rep = H // Hkv
    dev = q.device
    qf = q.float().reshape(B, Hkv, rep, n, W, Dh)
    kc = k.float().reshape(B, Hkv, n, W, Dh)
    vc = v.float().reshape(B, Hkv, n, W, Dh)
    # neighborhood [i-1, i]: prepend a zero chunk for i = 0
    zeros = torch.zeros_like(kc[:, :, :1])
    k2 = torch.cat([torch.cat([zeros, kc[:, :, :-1]], dim=2), kc], dim=3)
    v2 = torch.cat([torch.cat([zeros, vc[:, :, :-1]], dim=2), vc], dim=3)
    scale = 1.0 / (Dh**0.5)
    s = torch.einsum("bgrnqd,bgnkd->bgrnqk", qf, k2) * scale  # [.., W, 2W]
    qpos = torch.arange(W, device=dev)[:, None] + W  # position within the 2W band
    kpos = torch.arange(2 * W, device=dev)[None, :]
    first = torch.arange(n, device=dev) == 0
    mask = (kpos <= qpos) & (kpos > qpos - W)  # causal + window
    valid_prev = ~first[:, None, None]  # chunk 0 has no left neighbor
    mask = mask[None, :, :] & (valid_prev | (kpos[None] >= W))
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrnqk,bgnkd->bgrnqd", p, v2)
    return out.reshape(B, H, S, Dh).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    kv_len: int | None = None,
    impl: Literal["auto", "naive", "blockwise", "flash"] = "auto",
    block_k: int = 512,
) -> torch.Tensor:
    """Attention with GQA + causal/sliding-window masks, dispatched as the
    reference dispatches: ``impl="auto"`` takes the flash kernel for CUDA
    tensors (the reference's TPU) when ``Sq >= 128``, ``q_offset`` is a
    static int and there is no ``kv_len``; otherwise blockwise above 2048^2
    scores, else naive. Full-sequence causal window self-attention goes
    banded on the non-flash paths."""
    Sq, Skv = q.shape[2], k.shape[2]
    static = isinstance(q_offset, int) and kv_len is None
    if impl == "auto":
        if q.is_cuda and Sq >= 128 and static:
            impl = "flash"
        elif Sq * Skv > 2048 * 2048:
            impl = "blockwise"
        else:
            impl = "naive"
    if impl == "flash":
        if not static:
            raise ValueError("impl='flash' needs an int q_offset and no kv_len")
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if window > 0 and causal and Sq == Skv and Sq > window and static and q_offset == 0:
        return attention_banded(q, k, v, window=window)
    if impl == "blockwise":
        return attention_blockwise(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   kv_len=kv_len, block_k=block_k)
    if impl == "naive":
        return _ref.attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                  kv_len=kv_len)
    raise ValueError(f"unknown attention impl {impl!r}")
