"""The port's kernel entry points, dispatched by the tensors' device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the kernel's plain PyTorch version. There is no other
fallback: nothing on the card quietly takes the plain path.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
from repro_torch.kernels.topk_mips import topk_mips_cuda, topk_mips_plain

KERNEL_WRAPPERS = {"topk_mips": topk_mips_cuda, "embedding_bag": embedding_bag_cuda}


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


def embedding_bag(table: torch.Tensor, slot_ids: torch.Tensor,
                  slot_of: torch.Tensor, valid: torch.Tensor,
                  n_slots: int) -> torch.Tensor:
    """Fused gather + per-(example, slot) sum-pool -> [B, n_slots, D].
    ``valid`` is a mask, not weights: any dtype is read as ``!= 0``."""
    if valid.dtype != torch.bool:
        valid = valid != 0
    if table.is_cuda:
        return embedding_bag_cuda(
            table,
            slot_ids.to(torch.int32).contiguous(),
            slot_of.to(torch.int32).contiguous(),
            valid.contiguous(),
            n_slots,
        )
    return embedding_bag_plain(table, slot_ids, slot_of, valid, n_slots)
