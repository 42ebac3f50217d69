"""Plain-PyTorch oracles: the semantic contracts the port's kernels match.

One for one with the reference's ``repro/kernels/ref.py`` (the functions the
serving, training, LM and MoE serving slices reach), on torch tensors; the
tests hold each against its JAX twin on shared numpy inputs.
"""

from __future__ import annotations

import torch


def embedding_lookup_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[N, D] gathered by int ids [B] -> [B, D]."""
    return table[ids.long()]


def scatter_add_ref(table: torch.Tensor, ids: torch.Tensor, grads: torch.Tensor) -> torch.Tensor:
    """table[ids[i]] += grads[i] with duplicate ids accumulating, as a new
    tensor. ``index_add`` adds in position order on the CPU; ids outside
    ``[0, N)`` are dropped, as the reference's scatter drops them."""
    ids = ids.long()
    keep = (ids >= 0) & (ids < table.shape[0])
    if not bool(keep.all()):
        ids, grads = ids[keep], grads[keep]
    return table.index_add(0, ids, grads.to(table.dtype))


def adagrad_ref(
    params: torch.Tensor,
    accum: torch.Tensor,
    grads: torch.Tensor,
    lr: float,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad (the paper's CTR-style sparse optimizer), one op per
    rounding: ``a' = a + g*g``, ``p' = p - (lr*g) / (sqrt(a') + eps)``.

    The square root goes through float64: PyTorch's fp32 ``sqrt`` on the CPU
    is vectorised and not always correctly rounded, while the float64 root
    rounded once to fp32 is (double rounding is harmless for sqrt), on any
    device. With it this equals the reference's ``adagrad_ref`` bitwise."""
    g = grads.to(torch.float32)
    new_accum = accum + g * g
    root = torch.sqrt(new_accum.to(torch.float64)).to(torch.float32)
    new_params = params.to(torch.float32) - (lr * g) / (root + eps)
    return new_params.to(params.dtype), new_accum


def embedding_bag_ref(
    table: torch.Tensor,  # [N, emb]
    slot_ids: torch.Tensor,  # [B, nnz] int
    slot_of: torch.Tensor,  # [B, nnz] int in [0, n_slots)
    valid: torch.Tensor,  # [B, nnz] bool
    n_slots: int,
) -> torch.Tensor:
    """Gather rows and sum-pool per (example, slot) -> [B, n_slots, emb]:
    materialized gather + one-hot einsum, the reference's seed CTR math. A
    ``slot_of`` outside ``[0, n_slots)`` has an all-zero one-hot row, so its
    nonzero is dropped."""
    emb = table[slot_ids.long()]  # [B, nnz, emb]
    emb = emb * valid[..., None].to(emb.dtype)
    s = slot_of.long()
    inside = (s >= 0) & (s < n_slots)
    onehot = torch.nn.functional.one_hot(torch.where(inside, s, 0), n_slots)
    onehot = (onehot * inside[..., None]).to(emb.dtype)  # [B, nnz, n_slots]
    return torch.einsum("bne,bns->bse", emb, onehot)


def attention_ref(
    q: torch.Tensor,  # [B, H, Sq, Dh]
    k: torch.Tensor,  # [B, Hkv, Skv, Dh]
    v: torch.Tensor,  # [B, Hkv, Skv, Dh]
    causal: bool = True,
    window: int = 0,  # sliding window size; 0 = unlimited
    q_offset: int = 0,  # absolute position of q[..., 0, :]
    kv_len: int | None = None,  # valid kv prefix (decode caches)
) -> torch.Tensor:
    """Naive full-materialization attention with GQA (KV heads repeated) +
    causal/window masks, in fp32: masked scores are ``-inf`` and a row with
    no key left (its softmax all NaN) becomes 0. Returns ``q.dtype``."""
    B, H, Sq, Dh = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32, device=q.device))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def topk_mips_ref(
    queries: torch.Tensor,  # [Q, D]
    corpus: torch.Tensor,  # [N, D]
    k: int,
    n_valid: int | None = None,  # live corpus prefix; rows >= n_valid masked
) -> tuple[torch.Tensor, torch.Tensor]:
    """Brute-force top-k maximum-inner-product search: (scores f32 [Q, k],
    indices i32 [Q, k]) sorted by descending score with ties broken by
    ascending corpus index (stable sort), positions past the live corpus
    padded with (-inf, -1). fp32 throughout: on the card TF32 is switched
    off for the score matmul."""
    k = int(k)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    q = queries.to(torch.float32)
    c = corpus.to(torch.float32)
    if q.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    N = c.shape[0]
    n = N if n_valid is None else int(n_valid)
    scores = torch.matmul(q, c.T)  # [Q, N]
    live = torch.arange(N, device=c.device)[None, :] < min(n, N)
    scores = torch.where(live, scores, torch.full_like(scores, -torch.inf))
    kk = min(k, N)
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :kk]
    vals = torch.gather(scores, 1, order)
    idx = torch.where(torch.isneginf(vals), -1, order).to(torch.int32)
    if k > N:
        vals = torch.nn.functional.pad(vals, (0, k - N), value=-torch.inf)
        idx = torch.nn.functional.pad(idx, (0, k - N), value=-1)
    return vals, idx


def gmm_ref(x: torch.Tensor, w: torch.Tensor, group_sizes) -> torch.Tensor:
    """Grouped matmul oracle: rows of x [T, K] are grouped contiguously by
    expert, ``group_sizes[e]`` rows for ``w[e]`` of w [E, K, N]. One fp32
    product per group, ``x[s:e] @ w[g]``, cast to x's dtype (the reference
    indexes ``w[gid]`` per row, which at an MoE layer's full width would
    materialise [T, K, N]). Groups are cut at row T, negative sizes count as
    0, and rows past the last group are 0."""
    T, N = x.shape[0], w.shape[2]
    out = torch.zeros((T, N), dtype=x.dtype, device=x.device)
    start = 0
    for g, n in enumerate(torch.as_tensor(group_sizes).tolist()):
        end = min(T, start + max(0, int(n)))
        if end > start:
            out[start:end] = (x[start:end].float() @ w[g].float()).to(x.dtype)
        start = end
    return out
