"""The port's kernel entry points, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. There is no other
fallback: nothing on the card quietly takes the plain path. A ``meta``
tensor (a dry run, ``launch/dryrun.py``) goes where a CUDA tensor goes,
to the kernel's ``*_meta`` stand-in (``kernels/meta.py``), which returns
an empty output of the kernel's shape and reports the kernel's cost; the
LM path's kernels (flash's backward among them) have one, and the other
three refuse meta tensors. Attention's naive, blockwise and banded paths
are plain PyTorch on any device, as they are plain jnp in the reference;
only its flash path is a kernel, and ``attention`` picks it for meta
tensors as for CUDA ones.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
from repro_torch.kernels.embedding_lookup import (
    embedding_lookup_cuda,
    embedding_lookup_meta,
    embedding_lookup_plain,
)
from repro_torch.kernels.feature_extract import feature_extract_cuda, feature_extract_plain
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_meta,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_meta,
    flash_attention_plain,
    kv_groups,
    pad_to_groups,
)
from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_meta, adagrad_plain
from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_meta, gmm_plain
from repro_torch.kernels.scatter_add import scatter_add_cuda_, scatter_add_meta_, scatter_add_plain_
from repro_torch.kernels.topk_mips import topk_mips_cuda, topk_mips_plain

KERNEL_WRAPPERS = {
    "topk_mips": topk_mips_cuda,
    "embedding_bag": embedding_bag_cuda,
    "scatter_add": scatter_add_cuda_,
    "fused_adagrad": adagrad_cuda,
    "feature_extract": feature_extract_cuda,
    "embedding_lookup": embedding_lookup_cuda,
    "flash_attention": flash_attention_cuda,
    "flash_attention_backward": flash_attention_bwd_cuda,
    "moe_gmm": gmm_cuda,
}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "launches_by_variant"):
            fn.launches_by_variant = dict.fromkeys(fn.launches_by_variant, 0)
        if hasattr(fn, "launches_by_mode"):
            fn.launches_by_mode = {}
        if hasattr(fn, "launches_by_layout"):
            fn.launches_by_layout = dict.fromkeys(fn.launches_by_layout, 0)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def _on_meta(*tensors) -> bool:
    return any(t.is_meta for t in tensors)


def _no_meta(kernel: str, *tensors) -> None:
    """Refuse meta tensors in a kernel that has no meta stand-in (it is on
    no LM path): its plain version is never run on them."""
    if _on_meta(*tensors):
        raise NotImplementedError(f"{kernel} has no meta-device stand-in")


def topk_mips(queries: torch.Tensor, corpus: torch.Tensor, k: int, *,
              n_valid: int | None = None):
    """Top-k maximum-inner-product search -> (scores f32 [Q, k], indices
    i32 [Q, k]): descending score, ties by ascending corpus index,
    positions past the live corpus (``n_valid``, default all of
    ``corpus``) as (-inf, -1)."""
    _no_meta("topk_mips", queries, corpus)
    if queries.is_cuda or corpus.is_cuda:
        return topk_mips_cuda(queries, corpus, k, n_valid=n_valid)
    return topk_mips_plain(queries, corpus, k, n_valid=n_valid)


def _scatter_add_into(table: torch.Tensor, sorted_ids: torch.Tensor,
                      grads: torch.Tensor) -> torch.Tensor:
    """``scatter_add`` into ``table`` itself: for a caller that owns the
    table and nothing else reads it (the bag's backward into fresh zeros)."""
    if table.is_cuda or table.is_meta:
        kernel = scatter_add_meta_ if table.is_meta else scatter_add_cuda_
        return kernel(table, sorted_ids.to(torch.int32).contiguous(), grads.contiguous())
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
    if params.is_cuda or params.is_meta:
        kernel = adagrad_meta if params.is_meta else adagrad_cuda
        return kernel(params, accum, grads.contiguous(), lr, eps)
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
    _no_meta("feature_extract", raw, valid)
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
        _no_meta("embedding_bag", table, slot_ids)
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


class _EmbeddingLookup(torch.autograd.Function):
    """The row gather with its backward: the gradient of a table row is the
    sum of the gradients of the positions that read it, accumulated through
    ``scatter_add`` (the kernel on the card) over the stably sorted ids, so
    duplicates add in position order."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        if _on_meta(table, ids):
            return embedding_lookup_meta(table, ids.to(torch.int32).contiguous())
        if table.is_cuda or ids.is_cuda:
            return embedding_lookup_cuda(table, ids.to(torch.int32).contiguous())
        return embedding_lookup_plain(table, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if (g.is_cuda or g.is_meta) and g.dtype != torch.float32:
            raise TypeError(f"the embedding_lookup backward on the card takes an fp32 gradient "
                            f"(scatter_add's), got {g.dtype}: keep the table in fp32")
        sorted_ids, order = torch.sort(ids.reshape(-1), stable=True)
        zeros = torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
        return _scatter_add_into(zeros, sorted_ids, g[order]), None


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row gather ``table[ids]`` -> [B, D], bit for bit; ids must lie in
    ``[0, N)``. The kernel takes ids as int32, as the reference casts them.
    Differentiable in ``table``: the backward scatter-adds through
    ``scatter_add``, which takes fp32 only on the card."""
    return _EmbeddingLookup.apply(table, ids)


# --------------------------------------------------------------------------
# grouped matmul (MoE expert compute)
# --------------------------------------------------------------------------


def _gmm(x, w, group_sizes, tiles, mode="forward"):
    if _on_meta(x, w):
        return gmm_meta(x, w, group_sizes, tiles=tiles)
    if x.is_cuda or w.is_cuda:
        return gmm_cuda(x, w, group_sizes, tiles=tiles, mode=mode)
    return gmm_plain(x, w, group_sizes, tiles=tiles)


def gmm_dw(x: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The weight gradient of a grouped matmul: ``dw[e] = x_e^T @ dy_e`` over
    group ``e``'s rows -> [len(group_sizes), K, N] in x's dtype, summed in
    fp32; a group with no rows gets zeros and rows past the groups are not
    read. One ``torch._grouped_mm`` ragged over the rows, its offsets a
    cumsum on the device (the reference's einsum autodiff, outside any
    kernel). K and N are multiples of 16 bytes' worth of x's dtype."""
    offs = torch.cumsum(group_sizes.to(x.device).clamp(min=0), 0, dtype=torch.int32)
    return torch._grouped_mm(x.T, dy, offs=offs.clamp(max=x.shape[0]))


class _Gmm(torch.autograd.Function):
    """The grouped matmul with its backward. ``dx = gmm(dy, w^T)`` over the
    same grouping and tile plan (the kernel on the card, counted as
    ``"dx"``): w^T is the view ``w.transpose(1, 2)``, unit stride over its
    depth, which the wgmma + TMA kernel reads K-major where it lies, with no
    transposed copy; ``dw`` is :func:`gmm_dw`."""

    @staticmethod
    def forward(ctx, x, w, group_sizes, tiles):
        ctx.save_for_backward(x, w, group_sizes, tiles)
        return _gmm(x, w, group_sizes, tiles)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes, tiles = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _gmm(dy, w.transpose(1, 2), group_sizes, tiles, mode="dx")
        if ctx.needs_input_grad[1]:
            dw = gmm_dw(x, dy, group_sizes).to(w.dtype)
        return dx, dw, None, None


def gmm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, *,
        tiles: torch.Tensor | None = None) -> torch.Tensor:
    """Grouped matmul: rows of ``x`` [T, K] are contiguous groups (sorted by
    expert), ``group_sizes[e]`` rows each; row t multiplies ``w[group_of(t)]``
    of ``w`` [E, K, N] -> [T, N] in x's dtype, summed in fp32. ``tiles``: the
    kernel's tile plan built once for several products over one grouping
    (``moe_gmm.gmm_tiles``); the plain version has no plan and ignores it.
    Differentiable in ``x`` and ``w`` (:class:`_Gmm`)."""
    return _Gmm.apply(x, w, group_sizes, tiles)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward, the reference's ``_flash_bwd``
    (the vector-Jacobian product of the same attention): where a gradient
    is wanted (``save``) the forward also returns each row's log-sum-exp and
    saves q, k, v, the output and it; the backward computes dq, dk and dv
    from them, on the card in ``flash_attention_bwd_cuda``'s kernels, on CPU
    tensors in their plain version. Without ``save`` (serving) no
    log-sum-exp is written."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, group, head_offset, save):
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset, group=group,
                        head_offset=head_offset)
        kw = dict(ctx.mask, return_lse=save)
        if _on_meta(q, k, v):
            res = flash_attention_meta(q, k, v, **kw)
        elif q.is_cuda or k.is_cuda or v.is_cuda:
            res = flash_attention_cuda(q, k, v, **kw)
        else:
            res = flash_attention_plain(q, k, v, **kw)
        if not save:
            return res
        out, lse = res
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()  # the layout the hopper kernels' loads take
        if _on_meta(q, k, v, g):
            grads = flash_attention_bwd_meta(q, k, v, out, lse, g, **ctx.mask)
        elif q.is_cuda or k.is_cuda or v.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, g, **ctx.mask)
        else:
            grads = flash_attention_bwd_plain(q, k, v, out, lse, g, **ctx.mask)
        return (*(d if need else None for d, need in zip(grads, ctx.needs_input_grad[:3])),
                None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    group: int | None = None, head_offset: int = 0) -> torch.Tensor:
    """Blockwise softmax attention forward (GQA, causal and window masks by
    absolute position, static ``q_offset``; query head h reads KV head ``(h
    + head_offset) // group``, default ``group = H / Hkv``) -> [B, H, Sq,
    Dh] in q's dtype. Differentiable: the backward is a kernel of its own on
    the card (:class:`_FlashAttention`)."""
    group, head_offset = kv_groups(q.shape[1], k.shape[1], group, int(head_offset))
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, bool(causal), int(window), int(q_offset), group,
                                 head_offset, save)


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
    group: int | None = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Streaming-softmax attention over KV blocks of ``block_k`` (the
    reference's ``lax.scan`` as a loop): memory O(Sq * block_k), fp32, GQA
    without repeating K/V, ``-inf`` masks with fully masked rows -> 0. Query
    head h reads KV head ``(h + head_offset) // group`` (default ``group = H
    / Hkv``; otherwise q runs padded with zero heads, ``pad_to_groups``)."""
    B, H, Sq, Dh = q.shape
    _, Hkv, Skv, _ = k.shape
    group, head_offset = kv_groups(H, Hkv, group, head_offset)
    if group * Hkv != H:
        out = attention_blockwise(pad_to_groups(q, Hkv, group, head_offset), k, v,
                                  causal=causal, window=window, q_offset=q_offset,
                                  kv_len=kv_len, block_k=block_k)
        return out[:, head_offset:head_offset + H]
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
    group: int | None = None,
    head_offset: int = 0,
) -> torch.Tensor:
    """Attention with GQA + causal/sliding-window masks, dispatched as the
    reference dispatches: ``impl="auto"`` takes the flash kernel for CUDA
    (and meta) tensors (the reference's TPU) when ``Sq >= 128``, ``q_offset`` is a
    static int and there is no ``kv_len``; otherwise blockwise above 2048^2
    scores, else naive. Full-sequence causal window self-attention goes
    banded on the non-flash paths. Query head h reads KV head ``(h +
    head_offset) // group`` (default ``group = H / Hkv``): the flash kernel
    takes the offset itself; the plain paths run q padded with zero heads
    to plain GQA's layout (``pad_to_groups``) and drop the padding."""
    H, Sq, Skv = q.shape[1], q.shape[2], k.shape[2]
    group, head_offset = kv_groups(H, k.shape[1], group, head_offset)
    static = isinstance(q_offset, int) and kv_len is None
    if impl == "auto":
        if (q.is_cuda or q.is_meta) and Sq >= 128 and static:
            impl = "flash"
        elif Sq * Skv > 2048 * 2048:
            impl = "blockwise"
        else:
            impl = "naive"
    if impl == "flash":
        if not static:
            raise ValueError("impl='flash' needs an int q_offset and no kv_len")
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               group=group, head_offset=head_offset)
    if group * k.shape[1] != H:
        out = attention(pad_to_groups(q, k.shape[1], group, head_offset), k, v, causal=causal,
                        window=window, q_offset=q_offset, kv_len=kv_len, impl=impl,
                        block_k=block_k)
        return out[:, head_offset:head_offset + H]
    if window > 0 and causal and Sq == Skv and Sq > window and static and q_offset == 0:
        return attention_banded(q, k, v, window=window)
    if impl == "blockwise":
        return attention_blockwise(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   kv_len=kv_len, block_k=block_k)
    if impl == "naive":
        return _ref.attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                  kv_len=kv_len)
    raise ValueError(f"unknown attention impl {impl!r}")
