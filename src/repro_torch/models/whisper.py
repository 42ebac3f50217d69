"""Whisper backbone: transformer encoder + decoder with cross-attention; the
port of the reference's ``models/whisper.py``.

The conv/mel frontend is a stub, as in the reference: the caller gives
precomputed frame embeddings [B, n_frames, d_model] (what the two conv
layers would emit). Everything downstream — sinusoidal encoder positions,
pre-LN blocks with biased LayerNorm, GELU MLPs, learned decoder positions,
causal self-attention + cross-attention — is implemented. Python loops over
the stacked layers stand in for the reference's scans. The training
``forward`` (and its ``encode``) run each layer under
``torch.utils.checkpoint`` when ``remat`` (the default), as the reference
checkpoints its scan bodies; ``prefill`` and ``decode_step`` run without it.
Remat changes no value.

Tensor parallelism over ``model`` (the launcher installs the group) reads
each weight's placement from its local shape: the encoder's, the decoder's
self and cross attention run on this rank's heads (``attention_block``),
the cross K/V projected from the replicated encoder states by the local
``wk``/``wv`` (the encoder states enter through ``copy_to_model``, so their
gradient sums every rank's heads); the MLPs are column/row-parallel, ``bo``
added once after the sum; ``lm_head`` is column-parallel where the
vocabulary divides (whole at whisper-tiny's odd 51,865).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.attention import KVCache, attention_block, attention_schema
from repro_torch.models.common import (
    ParamSpec,
    copy_to_model,
    gather_weights,
    gelu,
    init_params,
    layer_norm,
    reduce_from_model,
    remat as remat_call,
    stored_as,
    take,
    unstack,
)
from repro_torch.models.transformer import COMPUTE_DTYPE, _cast, embed_tokens


class WhisperCache(NamedTuple):
    self_kv: KVCache  # [L, B, H, C, Dh] decoder self-attention
    cross_kv: KVCache  # [L, B, H, n_frames, Dh] precomputed from encoder


def _ln(L: int, d: int) -> dict:
    return {
        "w": ParamSpec((L, d), ("layers", None), init="ones"),
        "b": ParamSpec((L, d), ("layers", None), init="zeros"),
    }


def _mlp(L: int, d: int, ff: int) -> dict:
    return {
        "wi": ParamSpec((L, d, ff), ("layers", "embed", "mlp"), fan_axis=1),
        "bi": ParamSpec((L, ff), ("layers", "mlp"), init="zeros"),
        "wo": ParamSpec((L, ff, d), ("layers", "mlp", "embed"), fan_axis=1),
        "bo": ParamSpec((L, d), ("layers", "embed"), init="zeros"),
    }


def schema(cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    out: dict = {
        "encoder": {
            "ln1": _ln(Le, d),
            "attn": attention_schema(cfg, layers=Le),
            "ln2": _ln(Le, d),
            "mlp": _mlp(Le, d, ff),
        },
        "enc_final_ln": {"w": ParamSpec((d,), (None,), init="ones"),
                         "b": ParamSpec((d,), (None,), init="zeros")},
        "decoder": {
            "ln1": _ln(Ld, d),
            "self_attn": attention_schema(cfg, layers=Ld),
            "ln_x": _ln(Ld, d),
            "cross_attn": attention_schema(cfg, layers=Ld),
            "ln2": _ln(Ld, d),
            "mlp": _mlp(Ld, d, ff),
        },
        "dec_final_ln": {"w": ParamSpec((d,), (None,), init="ones"),
                         "b": ParamSpec((d,), (None,), init="zeros")},
        # published whisper uses 448 decoder positions; the reference sizes
        # the table to 65,536 to cover its long decode cell
        "dec_pos": ParamSpec((65536, d), (None, "embed"), scale=0.02),
        "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab")),
    }
    if cfg.embedding_mode == "dense":
        out["embed"] = ParamSpec((cfg.vocab_size, d), ("vocab_rep", "embed_tp"), scale=0.02)
    return out


# the leaves ``init(dtype=)`` stores in ``dtype``: those cast to bf16 at use
STORED = ("encoder", "decoder", "dec_pos", "lm_head")


def init(cfg: ArchConfig, generator: torch.Generator, *, dtype: torch.dtype = torch.float32):
    """Parameters on ``generator``'s device; ``dtype`` is the storage type of
    the ``STORED`` leaves (the final LayerNorms and a dense ``embed`` stay
    fp32)."""
    return init_params(stored_as(schema(cfg), dtype, STORED), generator)


def _sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """[length, d] fp32: sin then cos of position x geometric timescales."""
    half = d // 2
    log_timescale = math.log(10000.0) / (half - 1)
    inv = torch.exp(-log_timescale * torch.arange(half, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def _mlp_block(m: torch.Tensor, p: dict, cfg: ArchConfig) -> torch.Tensor:
    """GELU MLP; column/row-parallel where ``wi`` holds this rank's columns
    of ``d_ff``, the replicated ``bo`` added once, after the sum."""
    if p["wi"].shape[-1] < cfg.d_ff:
        return reduce_from_model(gelu(copy_to_model(m) @ p["wi"] + p["bi"]) @ p["wo"]) + p["bo"]
    return gelu(m @ p["wi"] + p["bi"]) @ p["wo"] + p["bo"]


def _ln_of_sum(h: torch.Tensor, delta: torch.Tensor, ln: dict, cfg: ArchConfig) -> torch.Tensor:
    """``layer_norm(h + delta)`` reading the residual sum before its bf16
    rounding, as the reference's compiled layer does (XLA fuses the add into
    the norm's fp32 upcast; see ``transformer._block``)."""
    return layer_norm(h.float() + delta.float(), ln["w"], ln["b"], cfg.norm_eps).to(h.dtype)


def encode(cfg: ArchConfig, params, frames: torch.Tensor, *,
           attn_impl: str = "auto", remat: bool = True) -> torch.Tensor:
    """frames: [B, n_frames, d] stub conv output. Returns encoder states.
    ``remat``: each layer under ``torch.utils.checkpoint`` while autograd
    records."""
    n = frames.shape[1]
    h = frames.to(COMPUTE_DTYPE) + _sinusoids(n, cfg.d_model, frames.device).to(COMPUTE_DTYPE)
    positions = torch.arange(n, device=frames.device)

    def layer(h, lp):
        lp = _cast(gather_weights(lp, "encoder"))
        a = layer_norm(h, lp["ln1"]["w"], lp["ln1"]["b"], cfg.norm_eps)
        attn_out, _ = attention_block(a, lp["attn"], cfg, positions=positions, causal=False,
                                      rope=False, impl=attn_impl)
        m = _ln_of_sum(h, attn_out, lp["ln2"], cfg)
        h = h + attn_out
        return h + _mlp_block(m, lp["mlp"], cfg)

    for lp in unstack(params["encoder"], cfg.encoder_layers):
        h = remat_call(remat, layer, h, lp)
    return layer_norm(h, params["enc_final_ln"]["w"], params["enc_final_ln"]["b"], cfg.norm_eps)


def _decoder_layer(cfg, carry, lp, positions, enc_or_kv, *, self_cache=None, cache_pos=None,
                   attn_impl="auto", return_kv=False):
    a = layer_norm(carry, lp["ln1"]["w"], lp["ln1"]["b"], cfg.norm_eps)
    self_out, new_self = attention_block(
        a, lp["self_attn"], cfg, positions=positions, causal=True, rope=False,
        impl=attn_impl, cache=self_cache, cache_pos=cache_pos,
        q_offset=0 if cache_pos is None else cache_pos, return_kv=return_kv,
    )
    x = _ln_of_sum(carry, self_out, lp["ln_x"], cfg)
    h = carry + self_out
    if isinstance(enc_or_kv, KVCache):  # precomputed cross K/V (decode)
        new_cross = enc_or_kv
    else:  # encoder states: project K/V here (prefill) and emit them
        B, Se, _ = enc_or_kv.shape
        hd = cfg.resolved_head_dim
        Hkv = lp["cross_attn"]["wk"].shape[-1] // hd  # this rank's kv heads
        ck = (enc_or_kv @ lp["cross_attn"]["wk"]).reshape(B, Se, Hkv, hd).transpose(1, 2)
        cv = (enc_or_kv @ lp["cross_attn"]["wv"]).reshape(B, Se, Hkv, hd).transpose(1, 2)
        new_cross = KVCache(ck, cv)
    cross_out, _ = attention_block(
        x, lp["cross_attn"], cfg, positions=positions, causal=False, rope=False,
        impl=attn_impl, cross_kv=(new_cross.k, new_cross.v),
    )
    m = _ln_of_sum(h, cross_out, lp["ln2"], cfg)
    h = h + cross_out
    return h + _mlp_block(m, lp["mlp"], cfg), new_self, new_cross


def _decoder_weights(params, i: int) -> dict:
    """Decoder layer ``i``'s leaves (views, gathered over ``data``), bf16."""
    return _cast(gather_weights(take(params["decoder"], i), "decoder"))


def _cross_source(cfg: ArchConfig, params, enc: torch.Tensor) -> torch.Tensor:
    """The encoder states as the decoder layers' cross K/V projections read
    them: through ``copy_to_model`` where those hold this rank's kv heads,
    so the encoder's gradient sums every rank's."""
    wk = params["decoder"]["cross_attn"]["wk"]
    return copy_to_model(enc) if wk.shape[-1] < cfg.n_kv_heads * cfg.resolved_head_dim else enc


def _decoder_input(cfg, params, tokens, working_table, start: int) -> torch.Tensor:
    h = embed_tokens(cfg, params, tokens, working_table)
    pos = gather_weights(params["dec_pos"][start:start + tokens.shape[1]], "dec_pos")
    return h + pos.to(COMPUTE_DTYPE)


def _logits(cfg: ArchConfig, params, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits; this rank's vocabulary columns where ``lm_head`` is
    column-parallel."""
    h = layer_norm(h, params["dec_final_ln"]["w"], params["dec_final_ln"]["b"], cfg.norm_eps)
    if params["lm_head"].shape[-1] < cfg.vocab_size:
        h = copy_to_model(h)
    return (h @ gather_weights(params["lm_head"], "lm_head").to(COMPUTE_DTYPE)).float()


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S] decoder tokens
    frames: torch.Tensor,  # [B, n_frames, d] stub frontend embeddings
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = True,
):
    """Training forward: encoder + teacher-forced decoder. Returns (logits
    fp32, aux 0). ``remat``: each encoder and decoder layer under
    ``torch.utils.checkpoint`` while autograd records (no value changes)."""
    enc = _cross_source(cfg, params, encode(cfg, params, frames, attn_impl=attn_impl,
                                            remat=remat))
    h = _decoder_input(cfg, params, tokens, working_table, 0)
    positions = torch.arange(tokens.shape[1], device=h.device)

    def layer(h, lp, enc):
        return _decoder_layer(cfg, h, _cast(gather_weights(lp, "decoder")), positions, enc,
                              attn_impl=attn_impl)[0]

    for lp in unstack(params["decoder"], cfg.n_layers):
        h = remat_call(remat, layer, h, lp, enc)
    return _logits(cfg, params, h), torch.zeros((), device=h.device)


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    frames: torch.Tensor,
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
):
    """Encode audio + consume the decoder prompt -> (last logits [B, 1, V],
    WhisperCache: the self K/V of the S prompt positions and the cross K/V of
    the encoder states, stacked over the decoder layers)."""
    enc = _cross_source(cfg, params, encode(cfg, params, frames, attn_impl=attn_impl,
                                            remat=False))
    h = _decoder_input(cfg, params, tokens, working_table, 0)
    positions = torch.arange(tokens.shape[1], device=h.device)
    sk, sv, ck, cv = [], [], [], []
    for i in range(cfg.n_layers):
        h, skv, ckv = _decoder_layer(cfg, h, _decoder_weights(params, i), positions, enc,
                                     attn_impl=attn_impl, return_kv=True)
        sk.append(skv.k), sv.append(skv.v), ck.append(ckv.k), cv.append(ckv.v)
    cache = WhisperCache(KVCache(torch.stack(sk), torch.stack(sv)),
                         KVCache(torch.stack(ck), torch.stack(cv)))
    return _logits(cfg, params, h[:, -1:]), cache


def decode_step(
    cfg: ArchConfig,
    params,
    token: torch.Tensor,  # [B, 1]
    cache: WhisperCache,
    pos: int,
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "naive",
):
    """One step for ``token`` at decoder position ``pos`` -> (logits [B, 1,
    V], the cache, its self K/V written in place at ``pos``)."""
    pos = int(pos)
    h = _decoder_input(cfg, params, token, working_table, pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    for i in range(cfg.n_layers):
        h, _, _ = _decoder_layer(
            cfg, h, _decoder_weights(params, i), positions,
            KVCache(cache.cross_kv.k[i], cache.cross_kv.v[i]),
            self_cache=KVCache(cache.self_kv.k[i], cache.self_kv.v[i]), cache_pos=pos,
            attn_impl=attn_impl,
        )
    return _logits(cfg, params, h), cache
