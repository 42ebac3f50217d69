"""The CTR train step: one pulled working set, k mini-batches (Algorithm 1
lines 11-15), in PyTorch.

The reference's ``make_ctr_train_step`` runs the k mini-batches in one
jitted ``lax.scan``; here they are a Python loop, run eagerly. Each
mini-batch: bag forward, tower, BCE, backward (the bag's backward through
the ``scatter_add`` kernel on the card), AdamW on the tower, then
row-Adagrad on the working table through ``kops.adagrad_update`` (the
``fused_adagrad`` kernel on the card) — before the next mini-batch sees the
table (Algorithm 1 line 14: parameters synchronised after every
mini-batch).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import ctr as ctr_model
from repro_torch.train.optim import AdamW


def make_ctr_train_step(ctr_cfg, row_lr: float = 0.05, tower_opt: AdamW = AdamW(lr=1e-3)):
    """step(tower, opt_state, working_table, row_accum, minibatches)
      -> (tower, opt_state, table, accum, metrics)

    minibatches: dict of stacked [k, mb, ...] tensors (slot_ids, slot_of,
    valid, labels) on the table's device. The inputs are not modified;
    ``metrics["loss"]`` is the mean mini-batch loss, a device scalar."""

    def step(tower, opt_state, working_table, row_accum, minibatches):
        table, accum = working_table, row_accum
        losses = []
        for i in range(minibatches["labels"].shape[0]):
            mb = {k: v[i] for k, v in minibatches.items()}
            tw = {k: v.detach().requires_grad_() for k, v in tower.items()}
            tb = table.detach().requires_grad_()
            loss = ctr_model.loss_fn(
                ctr_cfg, tw, tb, mb["slot_ids"], mb["slot_of"], mb["valid"], mb["labels"]
            )
            grads = torch.autograd.grad(loss, [*tw.values(), tb])
            tower, opt_state = tower_opt.update(dict(zip(tw, grads[:-1])), opt_state, tower)
            table, accum = kops.adagrad_update(table, accum, grads[-1], row_lr)
            losses.append(loss.detach())
        return tower, opt_state, table, accum, {"loss": torch.stack(losses).mean()}

    return step
