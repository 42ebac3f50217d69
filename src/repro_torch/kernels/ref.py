"""Plain-PyTorch oracles: the semantic contracts the port's kernels match.

One for one with the reference's ``repro/kernels/ref.py`` (the functions the
serving slice reaches), on torch tensors; the tests hold each against its
JAX twin on shared numpy inputs.
"""

from __future__ import annotations

import torch


def embedding_lookup_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[N, D] gathered by int ids [B] -> [B, D]."""
    return table[ids.long()]


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
