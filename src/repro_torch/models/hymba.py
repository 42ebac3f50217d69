"""Hymba: hybrid-head LM — parallel attention + mamba heads in every layer;
the port of the reference's ``models/hymba.py``.

Per the paper [arXiv:2411.13676]: each layer normalizes its input once, runs
*attention heads* and *SSM (mamba) heads* in parallel on it, normalizes each
branch output and averages them (learned per-branch scale), then a SwiGLU MLP.
Learned meta tokens are prepended to the sequence. Most layers use
sliding-window attention (SWA); layers {first, middle, last} use full
("global") attention.

Layer layout, as the reference keeps it: the interleaved global/SWA pattern
is realized as *segments*; the SWA layers and the global layers are stacked
in two groups (``swa_layers``, ``glb_layers``), and a Python loop over the
segments stands in for the reference's scans. Each group has its own cache
geometry for decode:

  * SWA layers — ring-buffer KV cache of size ``window``  (O(1) in context)
  * global layers — full-length KV cache
  * mamba heads — O(1) recurrent state

Tensor parallelism over ``model`` (the launcher installs the group) reads
each weight's placement from its local shape, as the transformer family
does: the attention branch on this rank's q (and kv) heads, the mamba
branch on its channels (``models/mamba.py``), both entering the group's
region through one ``copy_to_model`` and each leaving through a sum
over the group, so the norms, ``beta_*``, the meta tokens and the residual
stay replicated; the MLP column/row-parallel where ``d_ff`` divides (whole
otherwise), and ``lm_head`` column-parallel over the vocabulary where it
divides.

``forward`` is the training forward: with ``remat`` (the default, as in the
reference) each layer runs under ``torch.utils.checkpoint`` and is recomputed
in the backward (the reference's ``jax.checkpoint(..., nothing_saveable)``
around its scan body). Serving's ``prefill`` and ``decode_step`` run without
it. Remat changes no value.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.attention import KVCache, attention_block, attention_schema
from repro_torch.models.common import (
    ParamSpec,
    copy_to_model,
    gather_weights,
    init_params,
    remat as remat_call,
    rms_norm,
    stored_as,
    take,
    unstack,
)
from repro_torch.models.transformer import (
    COMPUTE_DTYPE,
    _cast,
    _logits,
    embed_tokens,
    mlp_block,
    mlp_schema,
)


class HymbaCache(NamedTuple):
    swa: KVCache  # [n_swa, B, Hkv, W, Dh] ring buffers
    glb: KVCache  # [n_glb, B, Hkv, C, Dh] full caches
    ssm_swa: mamba_mod.MambaState  # stacked [n_swa, ...]
    ssm_glb: mamba_mod.MambaState  # stacked [n_glb, ...]


def segments(cfg: ArchConfig) -> list[tuple[str, int, int]]:
    """[(kind, start_layer, n_layers)] covering 0..n_layers in order."""
    glb = sorted(cfg.global_attn_layers)
    out: list[tuple[str, int, int]] = []
    prev = 0
    for g in glb:
        if g > prev:
            out.append(("swa", prev, g - prev))
        out.append(("global", g, 1))
        prev = g + 1
    if prev < cfg.n_layers:
        out.append(("swa", prev, cfg.n_layers - prev))
    return out


def _layer_schema(cfg: ArchConfig, L: int) -> dict:
    d = cfg.d_model
    return {
        "ln_in": ParamSpec((L, d), ("layers", None), init="ones"),
        "ln_attn": ParamSpec((L, d), ("layers", None), init="ones"),
        "ln_ssm": ParamSpec((L, d), ("layers", None), init="ones"),
        "beta_attn": ParamSpec((L, d), ("layers", None), init="ones"),
        "beta_ssm": ParamSpec((L, d), ("layers", None), init="ones"),
        "ln_mlp": ParamSpec((L, d), ("layers", None), init="ones"),
        "attn": attention_schema(cfg, layers=L),
        "ssm": mamba_mod.mamba_schema(d, cfg.ssm_state, layers=L),
        "mlp": mlp_schema(cfg, layers=L),
    }


def schema(cfg: ArchConfig) -> dict:
    n_glb = len(cfg.global_attn_layers)
    n_swa = cfg.n_layers - n_glb
    out: dict = {
        "swa_layers": _layer_schema(cfg, n_swa),
        "glb_layers": _layer_schema(cfg, n_glb),
        "meta_tokens": ParamSpec((cfg.n_meta_tokens, cfg.d_model), (None, "embed"), scale=0.02),
        "final_norm": ParamSpec((cfg.d_model,), (None,), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }
    if cfg.embedding_mode == "dense":
        out["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab_rep", "embed_tp"),
                                 scale=0.02)
    return out


# the leaves ``init(dtype=)`` stores in ``dtype``: those cast to bf16 at use
STORED = ("swa_layers", "glb_layers", "meta_tokens", "lm_head")


def init(cfg: ArchConfig, generator: torch.Generator, *, dtype: torch.dtype = torch.float32):
    """Parameters on ``generator``'s device; ``dtype`` is the storage type of
    the ``STORED`` leaves (``final_norm`` and a dense ``embed`` stay fp32)."""
    return init_params(stored_as(schema(cfg), dtype, STORED), generator)


def _hymba_layer(
    cfg: ArchConfig,
    h: torch.Tensor,
    lp: dict,
    *,
    positions: torch.Tensor,
    window: int,
    attn_impl: str,
    cache: Optional[KVCache] = None,
    cache_pos=None,
    ring: bool = False,
    ssm_state: Optional[mamba_mod.MambaState] = None,
    q_offset=0,
):
    x = rms_norm(h, lp["ln_in"], cfg.norm_eps)
    # where both branches read x on their local shards, x enters the model
    # region once: the backward sums the two branches' gradients in one all-reduce
    entered = (lp["attn"]["wq"].shape[-1] < cfg.n_heads * cfg.resolved_head_dim
               and lp["ssm"]["out_proj"].shape[0] < mamba_mod.EXPAND * cfg.d_model)
    if entered:
        x = copy_to_model(x)
    attn_out, new_kv = attention_block(
        x, lp["attn"], cfg,
        positions=positions, causal=True, window=window, impl=attn_impl,
        cache=cache, cache_pos=cache_pos, ring=ring, q_offset=q_offset,
        return_kv=cache is None, entered=entered,
    )
    ssm_out, new_state = mamba_mod.mamba_mixer(lp["ssm"], x, state=ssm_state, entered=entered)
    mixed = 0.5 * (
        rms_norm(attn_out, lp["ln_attn"], cfg.norm_eps) * lp["beta_attn"]
        + rms_norm(ssm_out, lp["ln_ssm"], cfg.norm_eps) * lp["beta_ssm"]
    )
    # the norm reads the residual sum before its bf16 rounding, as the
    # reference's compiled layer does (see ``transformer._block``)
    m = rms_norm(h.float() + mixed.float(), lp["ln_mlp"], cfg.norm_eps).to(h.dtype)
    h = h + mixed
    h = h + mlp_block(m, lp["mlp"], cfg)
    return h, new_kv, new_state


def _key(kind: str) -> str:
    return "glb_layers" if kind == "global" else "swa_layers"


def _group(params, kind: str):
    return params[_key(kind)]


def _layers(params, tokens, working_table, cfg: ArchConfig, attn_impl: str, collect: bool,
            remat: bool = False):
    """Meta tokens + the layer stack -> (h [B, n_meta + S, d], and where
    ``collect`` each segment's (kind, (k, v, ssm h, ssm conv)) stacked over
    its layers). ``remat``: each layer under ``torch.utils.checkpoint``."""
    h = embed_tokens(cfg, params, tokens, working_table)
    B = h.shape[0]
    meta_tokens = gather_weights(params["meta_tokens"], "meta_tokens")
    meta = meta_tokens.to(COMPUTE_DTYPE)[None].expand((B,) + meta_tokens.shape)
    h = torch.cat([meta, h], dim=1)
    positions = torch.arange(h.shape[1], device=h.device)
    stacks = {kind: unstack(_group(params, kind), len(_group(params, kind)["ln_in"]))
              for kind in ("swa", "global")}

    collected: list = []
    idx = {"swa": 0, "global": 0}
    for kind, _start, n in segments(cfg):
        window = 0 if kind == "global" else cfg.window

        def layer(h, lp, window=window, key=_key(kind)):
            return _hymba_layer(cfg, h, _cast(gather_weights(lp, key)), positions=positions,
                                window=window, attn_impl=attn_impl)

        ys = []
        for i in range(idx[kind], idx[kind] + n):
            h, kv, st = remat_call(remat, layer, h, stacks[kind][i])
            if collect:
                ys.append((kv.k.to(COMPUTE_DTYPE), kv.v.to(COMPUTE_DTYPE), st.h, st.conv))
        if collect:
            collected.append((kind, tuple(torch.stack(a) for a in zip(*ys))))
        idx[kind] += n
    return h, collected


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,  # [B, S]
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    remat: bool = True,
    collect: bool = False,
):
    """Train/prefill forward. Meta tokens prepended. Returns
    (logits [B, S, V] fp32, aux 0) — or (logits, per-segment (kind, (k, v,
    ssm h, ssm conv)) stacks) when ``collect`` (prefill builds the decode
    cache from these). ``remat``: each layer under ``torch.utils.checkpoint``
    while autograd records (no value changes)."""
    h, collected = _layers(params, tokens, working_table, cfg, attn_impl, collect, remat)
    # drop meta-token positions from the output
    logits = _logits(cfg, params, h)[:, cfg.n_meta_tokens:]
    if collect:
        return logits, collected
    return logits, torch.zeros((), device=logits.device)


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    max_len: int | None = None,
):
    """Returns (last_logits [B,1,V], HymbaCache ready for decode at
    pos = n_meta + S). SWA caches become ring buffers (last ``window``
    positions, rolled so slot = pos % window); global caches are padded to
    ``max_len``. Only the last position goes through the output head."""
    B, S_in = tokens.shape
    S_tot = cfg.n_meta_tokens + S_in
    W = cfg.window
    max_len = max_len or S_tot
    h, collected = _layers(params, tokens, working_table, cfg, attn_impl, True)
    swa_k, swa_v, swa_h, swa_c = [], [], [], []
    glb_k, glb_v, glb_h, glb_c = [], [], [], []
    for kind, (ks, vs, hs, cs) in collected:
        if kind == "global":
            pad = (0, 0, 0, max_len - S_tot)
            glb_k.append(F.pad(ks, pad)), glb_v.append(F.pad(vs, pad))
            glb_h.append(hs), glb_c.append(cs)
        else:
            if S_tot >= W:  # ring: slot j holds position p with p % W == j
                rk = torch.roll(ks[..., S_tot - W:, :], S_tot % W, dims=-2)
                rv = torch.roll(vs[..., S_tot - W:, :], S_tot % W, dims=-2)
            else:
                pad = (0, 0, 0, W - S_tot)
                rk, rv = F.pad(ks, pad), F.pad(vs, pad)
            swa_k.append(rk), swa_v.append(rv)
            swa_h.append(hs), swa_c.append(cs)
    cache = HymbaCache(
        KVCache(torch.cat(swa_k), torch.cat(swa_v)),
        KVCache(torch.cat(glb_k), torch.cat(glb_v)),
        mamba_mod.MambaState(torch.cat(swa_h), torch.cat(swa_c)),
        mamba_mod.MambaState(torch.cat(glb_h), torch.cat(glb_c)),
    )
    return _logits(cfg, params, h[:, -1:]), cache


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> HymbaCache:
    n_glb = len(cfg.global_attn_layers)
    n_swa = cfg.n_layers - n_glb
    Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    W = min(cfg.window, max_len)
    swa_shape = (n_swa, batch, Hkv, W, hd)
    glb_shape = (n_glb, batch, Hkv, max_len, hd)
    one_layer = mamba_mod.mamba_schema(cfg.d_model, cfg.ssm_state, layers=None)
    zeros = lambda shape: torch.zeros(shape, dtype=dtype, device=device)
    return HymbaCache(
        KVCache(zeros(swa_shape), zeros(swa_shape)),
        KVCache(zeros(glb_shape), zeros(glb_shape)),
        mamba_mod.init_mamba_state(one_layer, batch, n_layers=n_swa, device=device),
        mamba_mod.init_mamba_state(one_layer, batch, n_layers=n_glb, device=device),
    )


def decode_step(
    cfg: ArchConfig,
    params,
    token: torch.Tensor,  # [B, 1]
    cache: HymbaCache,
    pos: int,  # tokens already consumed (incl. meta)
    *,
    working_table: Optional[torch.Tensor] = None,
    attn_impl: str = "naive",
):
    """One step for ``token`` at position ``pos`` -> (logits [B, 1, V], the
    cache, written in place: the ring slot ``pos % W`` of the SWA layers, the
    position ``pos`` of the global ones, and every layer's mamba state)."""
    h = embed_tokens(cfg, params, token, working_table)
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=h.device)
    idx = {"swa": 0, "global": 0}
    for kind, _start, n in segments(cfg):
        is_glb = kind == "global"
        kv = cache.glb if is_glb else cache.swa
        st = cache.ssm_glb if is_glb else cache.ssm_swa
        for i in range(idx[kind], idx[kind] + n):
            h, _, new_state = _hymba_layer(
                cfg, h, _cast(gather_weights(take(_group(params, kind), i), _key(kind))),
                positions=positions, window=0, attn_impl=attn_impl,
                cache=KVCache(kv.k[i], kv.v[i]), cache_pos=pos, ring=not is_glb,
                ssm_state=mamba_mod.MambaState(st.h[i], st.conv[i]), q_offset=pos,
            )
            st.h[i].copy_(new_state.h)
            st.conv[i].copy_(new_state.conv)
        idx[kind] += n
    return _logits(cfg, params, h), cache
