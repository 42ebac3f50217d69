"""Optimizers on trees of tensors: AdamW and Adagrad, and the cosine
learning-rate schedule.

The reference's ``train/optim.py``, in plain PyTorch: the reference runs
them in ``jnp`` outside any kernel, so they have no kernel here either. A
tree is a tensor or a dict of trees: the CTR tower's flat dict and the LM's
nested parameter dict alike. ``update`` is functional: it returns new
parameters and a new state and leaves its inputs as they were; it walks the
tree one leaf at a time, so its temporaries are those of one leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch import collectives as coll
from repro_torch.models.common import data_group, model_group


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same nesting) -> a tree of ``tree``'s nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in its dicts' order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples -> n trees."""
    if isinstance(tree, dict):
        parts = {k: _unzip(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params) -> AdamState:
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    def update(self, grads, state: AdamState, params, replicated=None):
        """``replicated``: see :func:`global_norm` (tensor parallelism and
        FSDP)."""
        step = state.step + 1
        scale = None
        if self.clip_norm > 0:
            gnorm = global_norm(grads, replicated)
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
        b1, b2 = self.b1, self.b2
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def leaf(p, g, mu, nu):
            if scale is not None:
                g = g * scale
            mu = b1 * mu + (1 - b1) * g.float()
            nu = b2 * nu + (1 - b2) * torch.square(g.float())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - self.lr * u).to(p.dtype), mu, nu

        new_params, m, v = _unzip(tree_map(leaf, params, grads, state.m, state.v), 3)
        return new_params, AdamState(step, m, v)


class AdagradState(NamedTuple):
    accum: Any


@dataclass(frozen=True)
class Adagrad:
    lr: float = 0.05
    eps: float = 1e-8

    def init(self, params) -> AdagradState:
        return AdagradState(tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(self, grads, state: AdagradState, params):
        def leaf(p, g, a):
            a = a + torch.square(g.float())
            new_p = (p.float() - self.lr * g.float() / (torch.sqrt(a) + self.eps)).to(p.dtype)
            return new_p, a

        new_params, accum = _unzip(tree_map(leaf, params, grads, state.accum), 2)
        return new_params, AdagradState(accum)


def global_norm(tree, replicated=None) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together. Under tensor
    parallelism or FSDP (a ``model`` or ``data`` group installed) and
    ``replicated`` given ({axis: a tree of bools beside ``tree``, whether
    each leaf is whole over that axis}), a leaf cut over an axis is this
    rank's shard: the squares of those are summed over that axis's group
    (over ``data``, then ``model``), and a leaf whole over an axis is
    counted once over it, so every rank clips alike."""
    leaves = tree_leaves(tree)
    squares = lambda flags: [torch.sum(torch.square(t.float()))
                             for t, f in zip(leaves, flags) if f]
    mgroup, dgroup = model_group(), data_group()
    if replicated is None or (mgroup is None and dgroup is None):
        return torch.sqrt(sum(squares([True] * len(leaves))))
    flags = lambda axis: tree_leaves(tree_map(lambda _, f: f, tree, replicated[axis]))
    on_m = flags("model")
    on_d = flags("data") if dgroup is not None else [True] * len(leaves)
    zero = [torch.zeros((), device=leaves[0].device)]
    # the model-cut leaves whole over data, then (after the data sums) the
    # leaves cut on both axes; the leaves whole over model: the same
    over_m = squares([not m and d for m, d in zip(on_m, on_d)])
    whole = squares([m and d for m, d in zip(on_m, on_d)])
    if dgroup is not None:
        pair = torch.stack([
            torch.stack(squares([not m and not d for m, d in zip(on_m, on_d)]) or zero).sum(),
            torch.stack(squares([m and not d for m, d in zip(on_m, on_d)]) or zero).sum()])
        coll.all_reduce(pair, coll.ReduceOp.SUM, group=dgroup)
        over_m.append(pair[0])
        whole.append(pair[1])
    sharded = torch.stack(over_m or zero).sum()
    if mgroup is not None:
        coll.all_reduce(sharded, coll.ReduceOp.SUM, group=mgroup)
    return torch.sqrt(sharded + sum(whole))


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine decay
    to 0 at ``total``: ``lr(step)`` for a step tensor (or int) -> fp32."""

    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(1, warmup)
        frac = torch.clamp((step - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr
