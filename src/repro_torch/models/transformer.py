"""Decoder-only transformer LM, dense family — the port of the reference's
``models/transformer.py``.

Conventions kept from the reference:

* stacked parameters: every layer leaf has a leading ``[n_layers]`` dim, and
  the layer loop indexes it (a Python loop stands in for ``lax.scan``);
* bf16 compute: each layer's fp32 leaves are cast to bf16 at use
  (``_cast``), ``final_norm`` stays fp32, logits are bf16 cast to fp32;
* the input embedding follows the paper's technique when
  ``cfg.embedding_mode == 'hier_ps'``: the step takes a dense *working
  table* (the batch's unique token rows, pulled by the MEM-PS) and
  renumbered ``slots`` instead of owning a [vocab, d] parameter. The output
  head is a dense parameter either way, as in the paper.

``init`` can store the layers and ``lm_head`` in bf16 directly
(``dtype=torch.bfloat16``), which is what ``_cast`` would make of them, so a
full-width model need not hold fp32 weights. MoE layers and image inputs
belong to the MoE/VLM slice and raise ``NotImplementedError``; this slice
has no backward, so there is no remat.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import KVCache, attention_block, attention_schema
from repro_torch.models.common import (
    ParamSpec,
    embed_gather,
    init_params,
    mlp_activation,
    rms_norm,
)

COMPUTE_DTYPE = torch.bfloat16


def _dense_only(cfg: ArchConfig, image_embeds=None) -> None:
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE layers belong to the MoE/VLM slice")
    if image_embeds is not None:
        raise NotImplementedError("image inputs belong to the MoE/VLM slice")


def mlp_schema(cfg: ArchConfig, layers: int | None = None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    L = cfg.n_layers if layers is None else layers
    stack = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    fan = len(stack)
    schema = {
        "wi": ParamSpec(stack + (d, ff), lax_ + ("embed", "mlp"), fan_axis=fan),
        "wo": ParamSpec(stack + (ff, d), lax_ + ("mlp", "embed"), fan_axis=fan),
    }
    if cfg.mlp_act == "swiglu":
        schema["wg"] = ParamSpec(stack + (d, ff), lax_ + ("embed", "mlp"), fan_axis=fan)
    return schema


def mlp_block(x: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.mlp_act == "swiglu":
        h = mlp_activation("swiglu", h, x @ p["wg"])
    else:
        h = mlp_activation(cfg.mlp_act, h)
    return h @ p["wo"]


def schema(cfg: ArchConfig) -> dict:
    _dense_only(cfg)
    d = cfg.d_model
    layers: dict = {
        "ln1": ParamSpec((cfg.n_layers, d), ("layers", None), init="ones"),
        "ln2": ParamSpec((cfg.n_layers, d), ("layers", None), init="ones"),
        "attn": attention_schema(cfg),
        "mlp": mlp_schema(cfg),
    }
    out: dict = {
        "layers": layers,
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab"), fan_axis=0),
    }
    if cfg.embedding_mode == "dense":
        out["embed"] = ParamSpec((cfg.vocab_size, d), ("vocab_rep", "embed_tp"), scale=0.02)
    return out


def init(cfg: ArchConfig, generator: torch.Generator, *, dtype: torch.dtype = torch.float32):
    """Parameters on ``generator``'s device. ``dtype`` is the storage type of
    the layer leaves and ``lm_head`` (``final_norm`` and a dense ``embed``
    stay fp32, as the reference keeps them)."""

    def stored(node):
        if isinstance(node, ParamSpec):
            return dataclasses.replace(node, dtype=dtype)
        return {k: stored(v) for k, v in node.items()}

    sch = schema(cfg)
    sch["layers"] = stored(sch["layers"])
    sch["lm_head"] = stored(sch["lm_head"])
    return init_params(sch, generator)


# --------------------------------------------------------------------------
# embedding resolution
# --------------------------------------------------------------------------


def embed_tokens(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S] int — token ids (dense) or working slots
    working_table: Optional[torch.Tensor],  # [n_working, d] (hier_ps mode)
) -> torch.Tensor:
    if cfg.embedding_mode == "hier_ps":
        if working_table is None:
            raise ValueError("hier_ps mode needs the working table")
        h = embed_gather(working_table, tokens)
    else:
        h = embed_gather(params["embed"], tokens)
    return h.to(COMPUTE_DTYPE)


# --------------------------------------------------------------------------
# forward (train / prefill share the layer stack)
# --------------------------------------------------------------------------


def _cast(p):
    if isinstance(p, dict):
        return {k: _cast(v) for k, v in p.items()}
    return p.to(COMPUTE_DTYPE) if p.dtype == torch.float32 else p


def _layer(params, i: int) -> dict:
    """Layer ``i``'s leaves (views into the stacked tensors), bf16."""

    def go(node):
        if isinstance(node, dict):
            return {k: go(v) for k, v in node.items()}
        return node[i]

    return _cast(go(params["layers"]))


def _block(cfg: ArchConfig, h: torch.Tensor, lp: dict, positions: torch.Tensor, **attn_kw):
    a = rms_norm(h, lp["ln1"], cfg.norm_eps)
    attn_out, kv = attention_block(a, lp["attn"], cfg, positions=positions, **attn_kw)
    # the norm reads the residual sum before its bf16 rounding, as the
    # reference's compiled layer does (XLA fuses the add into the norm's
    # fp32 upcast); the residual stream itself is rounded to bf16
    m = rms_norm(h.float() + attn_out.float(), lp["ln2"], cfg.norm_eps).to(h.dtype)
    h = h + attn_out
    return h + mlp_block(m, lp["mlp"], cfg), kv


def _logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return (h @ params["lm_head"].to(COMPUTE_DTYPE)).float()


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    working_table: Optional[torch.Tensor] = None,
    image_embeds: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    logits_for: str = "all",  # all | last
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits fp32, moe_aux_loss): the dense family has no aux loss."""
    _dense_only(cfg, image_embeds)
    h = embed_tokens(cfg, params, tokens, working_table)
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.n_layers):
        h, _ = _block(cfg, h, _layer(params, i), positions, causal=True, impl=attn_impl)
    if logits_for == "last":
        h = h[:, -1:]
    return _logits(cfg, params, h), torch.zeros((), device=h.device)


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    working_table: Optional[torch.Tensor] = None,
    image_embeds: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
) -> tuple[torch.Tensor, KVCache]:
    """Full-sequence forward emitting the KV cache (stacked [L, B, Hkv, S,
    Dh], bf16) + last-position logits [B, 1, V]."""
    _dense_only(cfg, image_embeds)
    h = embed_tokens(cfg, params, tokens, working_table)
    positions = torch.arange(h.shape[1], device=h.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, kv = _block(cfg, h, _layer(params, i), positions, causal=True, impl=attn_impl,
                       return_kv=True)
        ks.append(kv.k.to(COMPUTE_DTYPE))
        vs.append(kv.v.to(COMPUTE_DTYPE))
    return _logits(cfg, params, h[:, -1:]), KVCache(torch.stack(ks), torch.stack(vs))


def decode_step(
    cfg: ArchConfig,
    params,
    token: torch.Tensor,  # [B, 1] int
    cache: KVCache,  # stacked [L, B, Hkv, C, Dh]
    pos: int,  # number of tokens already in the cache
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "naive",
) -> tuple[torch.Tensor, KVCache]:
    """One step for ``token`` at position ``pos`` -> (logits [B, 1, V], the
    cache, written in place at ``pos``)."""
    _dense_only(cfg)
    h = embed_tokens(cfg, params, token, working_table)
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        h, _ = _block(cfg, h, _layer(params, i), positions, impl=attn_impl,
                      cache=KVCache(cache.k[i], cache.v[i]), cache_pos=pos, q_offset=pos)
    return _logits(cfg, params, h), cache
