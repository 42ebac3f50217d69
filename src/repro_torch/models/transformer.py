"""Decoder-only transformer LM: dense, MoE and VLM families — the port of
the reference's ``models/transformer.py``.

Conventions kept from the reference:

* stacked parameters: every layer leaf has a leading ``[n_layers]`` dim, and
  the layer loop indexes it (a Python loop stands in for ``lax.scan``);
* bf16 compute: each layer's fp32 leaves are cast to bf16 at use
  (``_cast``), ``final_norm`` stays fp32, logits are bf16 cast to fp32;
* an MoE config (``cfg.is_moe``) has ``moe`` layers (router, experts) where
  a dense one has ``mlp``; ``forward`` returns the sum of their aux losses;
* a VLM takes ``image_embeds`` [B, n_img, d], cast to bf16 and put before
  the token embeddings;
* the input embedding follows the paper's technique when
  ``cfg.embedding_mode == 'hier_ps'``: the step takes a dense *working
  table* (the batch's unique token rows, pulled by the MEM-PS) and
  renumbered ``slots`` instead of owning a [vocab, d] parameter. The output
  head is a dense parameter either way, as in the paper.

Tensor parallelism over ``model`` (``common.set_model_group``; the launcher
installs it) reads each weight's placement from its local shape: the MLP's
``wi``/``wg`` are column-parallel and ``wo`` row-parallel, ``lm_head`` is
column-parallel over the vocabulary (the logits stay vocab-sharded, as the
reference's ``vocab_act``), and a working table (or dense ``embed``) that
holds a d-slice is gathered over the group after the lookup. With no group
installed every weight is whole and the model computes what it did. FSDP
over ``data`` (``common.set_data_group``): each layer's weights, and
``lm_head``, are gathered whole over ``data`` where they are read
(``common.gather_weights``), inside the layer's remat region.

``init`` can store the layers and ``lm_head`` in bf16 directly
(``dtype=torch.bfloat16``), which is what ``_cast`` would make of them, so a
full-width model need not hold fp32 weights.

``forward`` is the training forward: with ``remat`` (the default, as in the
reference) each layer runs under ``torch.utils.checkpoint``, so the backward
recomputes it from its input and nothing inside it is kept (the reference's
``jax.checkpoint(..., nothing_saveable)`` around its scan body). Serving's
``prefill`` and ``decode_step`` run without it.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVCache, attention_block, attention_schema
from repro_torch.models.common import (
    ParamSpec,
    copy_to_model,
    embed_gather,
    gather_from_model,
    gather_weights,
    init_params,
    mlp_activation,
    remat as remat_call,
    reduce_from_model,
    rms_norm,
    stored_as,
    take,
    unstack,
)

COMPUTE_DTYPE = torch.bfloat16


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
    tp = p["wi"].shape[-1] < cfg.d_ff  # this rank's columns of d_ff
    if tp:
        x = copy_to_model(x)
    h = x @ p["wi"]
    if cfg.mlp_act == "swiglu":
        h = mlp_activation("swiglu", h, x @ p["wg"])
    else:
        h = mlp_activation(cfg.mlp_act, h)
    # reference :59 (h on "mlp_act") and :62 (the output on "embed_act")
    out = h @ p["wo"]
    return reduce_from_model(out) if tp else out


def schema(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    layers: dict = {
        "ln1": ParamSpec((cfg.n_layers, d), ("layers", None), init="ones"),
        "ln2": ParamSpec((cfg.n_layers, d), ("layers", None), init="ones"),
        "attn": attention_schema(cfg),
    }
    if cfg.is_moe:
        layers["moe"] = moe_mod.moe_schema(cfg)
    else:
        layers["mlp"] = mlp_schema(cfg)
    out: dict = {
        "layers": layers,
        "final_norm": ParamSpec((d,), (None,), init="ones"),
        "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab"), fan_axis=0),
    }
    if cfg.embedding_mode == "dense":
        out["embed"] = ParamSpec((cfg.vocab_size, d), ("vocab_rep", "embed_tp"), scale=0.02)
    return out


# the leaves ``init(dtype=)`` stores in ``dtype``: those cast to bf16 at use
STORED = ("layers", "lm_head")


def init(cfg: ArchConfig, generator: torch.Generator, *, dtype: torch.dtype = torch.float32):
    """Parameters on ``generator``'s device. ``dtype`` is the storage type of
    the layer leaves and ``lm_head`` (``final_norm`` and a dense ``embed``
    stay fp32, as the reference keeps them)."""
    return init_params(stored_as(schema(cfg), dtype, STORED), generator)


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
        table = working_table
    else:
        table = params["embed"]
    h = embed_gather(table, tokens)
    if table.shape[-1] < cfg.d_model:  # reference :111, "embed_tp": this rank's d-slice
        h = gather_from_model(h, -1)
    return h.to(COMPUTE_DTYPE)


def _embed(cfg: ArchConfig, params, tokens, working_table, image_embeds) -> torch.Tensor:
    h = embed_tokens(cfg, params, tokens, working_table)
    if image_embeds is not None:  # vlm: image patch embeddings first
        h = torch.cat([image_embeds.to(COMPUTE_DTYPE), h], dim=1)
    return h


# --------------------------------------------------------------------------
# forward (train / prefill share the layer stack)
# --------------------------------------------------------------------------


def _cast(p):
    if isinstance(p, dict):
        return {k: _cast(v) for k, v in p.items()}
    return p.to(COMPUTE_DTYPE) if p.dtype == torch.float32 else p


def _layer(params, i: int) -> dict:
    """Layer ``i``'s leaves (views into the stacked tensors, gathered over
    ``data``), bf16."""
    return _cast(gather_weights(take(params["layers"], i), "layers"))


def _block(cfg: ArchConfig, h: torch.Tensor, lp: dict, positions: torch.Tensor, **attn_kw):
    """One layer -> (h, this segment's K/V or the cache, the MoE aux loss or
    None)."""
    a = rms_norm(h, lp["ln1"], cfg.norm_eps)
    attn_out, kv = attention_block(a, lp["attn"], cfg, positions=positions, **attn_kw)
    # the norm reads the residual sum before its bf16 rounding, as the
    # reference's compiled layer does (XLA fuses the add into the norm's
    # fp32 upcast); the residual stream itself is rounded to bf16
    m = rms_norm(h.float() + attn_out.float(), lp["ln2"], cfg.norm_eps).to(h.dtype)
    h = h + attn_out
    if cfg.is_moe:
        mlp_out, aux = moe_mod.moe_block(m, lp["moe"], cfg)
    else:
        mlp_out, aux = mlp_block(m, lp["mlp"], cfg), None
    return h + mlp_out, kv, aux


def _logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits; this rank's vocabulary columns where ``lm_head`` is
    column-parallel (reference :174, "vocab_act")."""
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if params["lm_head"].shape[-1] < cfg.vocab_size:
        h = copy_to_model(h)
    return (h @ gather_weights(params["lm_head"], "lm_head").to(COMPUTE_DTYPE)).float()


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    working_table: Optional[torch.Tensor] = None,
    image_embeds: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = True,
    logits_for: str = "all",  # all | last
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits fp32, moe_aux_loss): the sum of the layers' aux losses
    (0 for the dense and VLM families). ``remat``: each layer under
    ``torch.utils.checkpoint`` while autograd records (no value changes)."""
    h = _embed(cfg, params, tokens, working_table, image_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    aux_sum = torch.zeros((), device=h.device)

    def layer(h, lp):
        h, _, aux = _block(cfg, h, _cast(gather_weights(lp, "layers")), positions, causal=True,
                           impl=attn_impl)
        return h, aux

    for lp in unstack(params["layers"], cfg.n_layers):
        h, aux = remat_call(remat, layer, h, lp)
        if aux is not None:
            aux_sum = aux_sum + aux
    if logits_for == "last":
        h = h[:, -1:]
    return _logits(cfg, params, h), aux_sum


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
    Dh], bf16) + last-position logits [B, 1, V]. A VLM's ``image_embeds``
    come first, so the cache holds n_img + S positions."""
    h = _embed(cfg, params, tokens, working_table, image_embeds)
    positions = torch.arange(h.shape[1], device=h.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, kv, _ = _block(cfg, h, _layer(params, i), positions, causal=True, impl=attn_impl,
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
    h = embed_tokens(cfg, params, token, working_table)
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        h, _, _ = _block(cfg, h, _layer(params, i), positions, impl=attn_impl,
                      cache=KVCache(cache.k[i], cache.v[i]), cache_pos=pos, q_offset=pos)
    return _logits(cfg, params, h), cache
