"""Serving-step factories: the prefill and decode programs of the dense LM
family — the port of the reference's ``serve/serve_step.py``.

The decode cache is the transformer's ``KVCache``, stacked [L, B, Hkv, C,
Dh] with C the context length; the decode step writes each new token's K/V
into it in place. Other families raise ``NotImplementedError`` (through
:func:`~repro_torch.models.get_model`).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import get_model


def make_prefill_step(cfg: ArchConfig, attn_impl: str = "auto"):
    """fn(params, batch) -> (last_logits [B, 1, V], cache). ``batch`` holds
    ``"tokens"`` [B, S] (working slots in hier_ps mode) and, in hier_ps
    mode, ``"working_table"``."""
    model = get_model(cfg)

    def step(params, batch):
        kwargs = {}
        if cfg.embedding_mode == "hier_ps":
            kwargs["working_table"] = batch["working_table"]
        return model.prefill(cfg, params, batch["tokens"], attn_impl=attn_impl, **kwargs)

    return step


def make_decode_step(cfg: ArchConfig, attn_impl: str = "naive"):
    """fn(params, batch, cache, pos) -> (logits [B, 1, V], cache).

    ``batch["token"]``: [B, 1] int (working slot in hier_ps mode);
    ``pos``: int — current context length."""
    model = get_model(cfg)

    def step(params, batch, cache, pos):
        kwargs = {}
        if cfg.embedding_mode == "hier_ps":
            kwargs["working_table"] = batch["working_table"]
        return model.decode_step(cfg, params, batch["token"], cache, pos,
                                 attn_impl=attn_impl, **kwargs)

    return step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
