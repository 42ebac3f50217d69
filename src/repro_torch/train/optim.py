"""AdamW for the CTR tower, on dicts of tensors.

The reference's ``train/optim.py`` AdamW (with its global-norm clip), in
plain PyTorch: the reference runs it in ``jnp`` outside any kernel, so it
has no kernel here either. ``update`` is functional: it returns new
parameters and a new state and leaves its inputs as they were.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: torch.Tensor  # int32 scalar, on the parameters' device
    m: dict
    v: dict


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params: dict) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        device = next(iter(params.values())).device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    def update(self, grads: dict, state: AdamState, params: dict):
        step = state.step + 1
        if self.clip_norm > 0:
            gnorm = global_norm(grads)
            scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
        b1, b2 = self.b1, self.b2
        m = {k: b1 * state.m[k] + (1 - b1) * g.float() for k, g in grads.items()}
        v = {k: b2 * state.v[k] + (1 - b2) * torch.square(g.float()) for k, g in grads.items()}
        stepf = step.float()
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        def upd(p, mu, nu):
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - self.lr * u).to(p.dtype)

        new_params = {k: upd(p, m[k], v[k]) for k, p in params.items()}
        return new_params, AdamState(step, m, v)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in tree.values()))
