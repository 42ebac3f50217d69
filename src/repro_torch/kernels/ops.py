"""The port's kernel entry points, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. There is no other
fallback: nothing on the card quietly takes the plain path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_plain
from repro_torch.kernels.scatter_add import scatter_add_cuda_, scatter_add_plain_
from repro_torch.kernels.topk_mips import topk_mips_cuda, topk_mips_plain

KERNEL_WRAPPERS = {
    "topk_mips": topk_mips_cuda,
    "embedding_bag": embedding_bag_cuda,
    "scatter_add": scatter_add_cuda_,
    "fused_adagrad": adagrad_cuda,
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
