"""xLSTM LM: mLSTM blocks with one sLSTM block every ``slstm_every`` layers;
the port of the reference's ``models/xlstm.py``.

mLSTM (matrix-memory, exponential gating) is parallelizable; as the
reference, the port has

  * an exact **sequential** recurrence (oracle + decode step), and
  * a **chunkwise-parallel** form (intra-chunk quadratic products + O(1)
    inter-chunk state, the FlashLinearAttention/TFLA structure) used for
    prefill.

sLSTM (scalar memory, hidden-to-hidden recurrence) is inherently sequential;
it runs as a loop over time with block-diagonal per-head recurrent
matrices, exactly as published.

Layer layout: supersteps of (slstm_every - 1) mLSTM blocks followed by one
sLSTM block; params are stacked [n_super, m_per, ...] (sLSTM [n_super,
...]), and two nested Python loops stand in for the reference's scans.
All of it is plain PyTorch: the reference reaches no Pallas kernel here.
``forward`` (training) runs each mLSTM block under ``torch.utils.checkpoint``
when ``remat`` (the default), as the reference checkpoints its mLSTM scan
body; remat changes no value.

Tensor parallelism over ``model`` (the launcher installs the group) reads
each weight's placement from its local shape. An mLSTM block runs on this
rank's heads: its columns of ``w_up``'s two blocks, its channels of the
conv and ``out_norm``, its heads of ``wq``/``wk``/``wv``; ``w_i``/``w_f``
are row-parallel: their partial sums are reduced, the replicated biases
added once, and each rank reads its heads' slice (``copy_to_model``, so
the biases' gradient sums every rank's); ``w_down`` is
row-parallel, reduced on the way out. An sLSTM block computes its columns
of the four gate preactivations, gathers them, and runs the recurrence
whole on every rank with ``r_zifo`` replicated; its FFN is
column/row-parallel. A block whose leaves the rules leave whole (the axis
divides neither the inner width nor, for the sLSTM, four times
``d_model``: xlstm-1.3b at 3, 5 and 6) runs whole on every rank, each
part reading its placement from its own leaves' shapes.
``lm_head`` is column-parallel over the vocabulary where it divides. With
no group installed every weight is whole.

Stabilized mLSTM recurrence (per head; q,k in R^dk, v in R^dv):

  m_t = max(lf_t + m_{t-1}, li_t)
  C_t = exp(lf_t + m_{t-1} - m_t) C_{t-1} + exp(li_t - m_t) k_t v_t^T
  n_t = exp(lf_t + m_{t-1} - m_t) n_{t-1} + exp(li_t - m_t) k_t
  h_t = (q_t C_t) / (max(|q_t . n_t|, exp(-m_t)) + eps)

with lf = logsigmoid(f-preact), li = i-preact, q scaled by dk^-1/2.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.common import (
    remat as remat_call,
    ParamSpec,
    copy_to_model,
    gather_from_model,
    gather_weights,
    gelu,
    local_range,
    reduce_from_model,
    init_params,
    log_sigmoid,
    rms_norm,
    sigmoid,
    silu,
    stored_as,
    take,
    unstack,
)
from repro_torch.models.transformer import _cast, _logits, embed_tokens

EPS = 1e-6


class MLSTMState(NamedTuple):
    C: torch.Tensor  # [B, H, dk, dv]
    n: torch.Tensor  # [B, H, dk]
    m: torch.Tensor  # [B, H]
    conv: torch.Tensor  # [B, K-1, dp]


class SLSTMState(NamedTuple):
    c: torch.Tensor  # [B, H, dh]
    n: torch.Tensor  # [B, H, dh]
    m: torch.Tensor  # [B, H, dh]
    h: torch.Tensor  # [B, H, dh]


class XLSTMCache(NamedTuple):
    mlstm: MLSTMState  # stacked [n_super, m_per, ...]
    slstm: SLSTMState  # stacked [n_super, ...]


# --------------------------------------------------------------------------
# schemas
# --------------------------------------------------------------------------

CONV_K = 4


def _mlstm_schema(cfg: ArchConfig, stack: tuple[int, ...]) -> dict:
    d = cfg.d_model
    dp = int(cfg.proj_factor * d)
    H = cfg.n_heads
    dh = dp // H
    lax_ = tuple("layers" for _ in stack)
    f = len(stack)
    return {
        "ln": ParamSpec(stack + (d,), lax_ + (None,), init="ones"),
        "w_up": ParamSpec(stack + (d, 2 * dp), lax_ + ("embed", "ssm"), fan_axis=f),
        "conv_w": ParamSpec(stack + (CONV_K, dp), lax_ + (None, "ssm"), scale=0.5),
        "conv_b": ParamSpec(stack + (dp,), lax_ + ("ssm",), init="zeros"),
        # block-diagonal per-head projections
        "wq": ParamSpec(stack + (H, dh, dh), lax_ + (None, None, "ssm"), fan_axis=f + 1),
        "wk": ParamSpec(stack + (H, dh, dh), lax_ + (None, None, "ssm"), fan_axis=f + 1),
        "wv": ParamSpec(stack + (H, dh, dh), lax_ + (None, None, "ssm"), fan_axis=f + 1),
        "w_i": ParamSpec(stack + (dp, H), lax_ + ("ssm", None), fan_axis=f),
        "b_i": ParamSpec(stack + (H,), lax_ + (None,), init="zeros"),
        "w_f": ParamSpec(stack + (dp, H), lax_ + ("ssm", None), fan_axis=f),
        "b_f": ParamSpec(stack + (H,), lax_ + (None,), init="ones"),
        "out_norm": ParamSpec(stack + (dp,), lax_ + ("ssm",), init="ones"),
        "w_down": ParamSpec(stack + (dp, d), lax_ + ("ssm", "embed"), fan_axis=f),
    }


def _slstm_dff(d: int) -> int:
    return int(4 * d / 3 + 127) // 128 * 128  # PF=4/3, padded to lanes


def _slstm_schema(cfg: ArchConfig, stack: tuple[int, ...]) -> dict:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    dff = _slstm_dff(d)
    lax_ = tuple("layers" for _ in stack)
    f = len(stack)
    return {
        "ln": ParamSpec(stack + (d,), lax_ + (None,), init="ones"),
        "w_zifo": ParamSpec(stack + (d, 4 * d), lax_ + ("embed", "ssm"), fan_axis=f),
        "r_zifo": ParamSpec(stack + (H, dh, 4 * dh), lax_ + (None, None, None), fan_axis=f + 1),
        "b_zifo": ParamSpec(stack + (4 * d,), lax_ + ("ssm",), init="zeros"),
        "out_norm": ParamSpec(stack + (d,), lax_ + (None,), init="ones"),
        "ln_ffn": ParamSpec(stack + (d,), lax_ + (None,), init="ones"),
        "ffn_up": ParamSpec(stack + (d, 2 * dff), lax_ + ("embed", "mlp"), fan_axis=f),
        "ffn_down": ParamSpec(stack + (dff, d), lax_ + ("mlp", "embed"), fan_axis=f),
    }


def layout(cfg: ArchConfig) -> tuple[int, int]:
    """(n_super, mlstm_per_super). slstm_every == 0 -> pure mLSTM."""
    if cfg.slstm_every == 0:
        return 1, cfg.n_layers
    if cfg.n_layers % cfg.slstm_every:
        raise ValueError(f"{cfg.n_layers} layers do not tile by slstm_every={cfg.slstm_every}")
    return cfg.n_layers // cfg.slstm_every, cfg.slstm_every - 1


def schema(cfg: ArchConfig) -> dict:
    n_super, m_per = layout(cfg)
    out: dict = {
        "mlstm": _mlstm_schema(cfg, (n_super, m_per)),
        "final_norm": ParamSpec((cfg.d_model,), (None,), init="ones"),
        "lm_head": ParamSpec((cfg.d_model, cfg.vocab_size), ("embed", "vocab")),
    }
    if cfg.slstm_every > 0:
        out["slstm"] = _slstm_schema(cfg, (n_super,))
    if cfg.embedding_mode == "dense":
        out["embed"] = ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab_rep", "embed_tp"),
                                 scale=0.02)
    return out


# the leaves ``init(dtype=)`` stores in ``dtype``: those cast to bf16 at use
STORED = ("mlstm", "slstm", "lm_head")


def init(cfg: ArchConfig, generator: torch.Generator, *, dtype: torch.dtype = torch.float32):
    """Parameters on ``generator``'s device; ``dtype`` is the storage type of
    the ``STORED`` leaves (``final_norm`` and a dense ``embed`` stay fp32)."""
    return init_params(stored_as(schema(cfg), dtype, STORED), generator)


# --------------------------------------------------------------------------
# mLSTM cell — sequential (oracle/decode) and chunkwise (prefill)
# --------------------------------------------------------------------------


def _zero_cell(q: torch.Tensor):
    B, H, _, dh = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((B, H, dh, dh), **f32), torch.zeros((B, H, dh), **f32),
            torch.full((B, H), -torch.inf, **f32))


def mlstm_sequential(q, k, v, li, lf, state: tuple | None = None):
    """q,k,v: [B,H,S,dh]; li,lf: [B,H,S]. Returns (h [B,H,S,dh], state)."""
    S, dh = q.shape[2], q.shape[3]
    C, n, m = _zero_cell(q) if state is None else state
    qf = q.float() * (dh**-0.5)
    kf, vf = k.float(), v.float()
    hs = []
    for t in range(S):
        q_t, k_t, v_t, li_t, lf_t = qf[:, :, t], kf[:, :, t], vf[:, :, t], li[..., t], lf[..., t]
        m_new = torch.maximum(lf_t + m, li_t)
        decay = torch.exp(lf_t + m - m_new)[..., None]
        inject = torch.exp(li_t - m_new)[..., None]
        C = decay[..., None] * C + inject[..., None] * (k_t[..., :, None] * v_t[..., None, :])
        n = decay * n + inject * k_t
        num = torch.einsum("bhk,bhkv->bhv", q_t, C)
        den = torch.abs(torch.einsum("bhk,bhk->bh", q_t, n))
        den = torch.maximum(den, torch.exp(-m_new)) + EPS
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=2).to(q.dtype), (C, n, m)


def mlstm_chunkwise(q, k, v, li, lf, state: tuple | None = None, *, chunk: int = 64):
    """Chunkwise-parallel mLSTM, numerically identical to sequential."""
    B, H, S, dh = q.shape
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"S={S} must tile by chunk={Q}")
    C, n, m = _zero_cell(q) if state is None else state
    qf = q.float() * (dh**-0.5)
    kf, vf = k.float(), v.float()
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    hs = []
    for c0 in range(0, S, Q):
        q_c, k_c, v_c = qf[:, :, c0:c0 + Q], kf[:, :, c0:c0 + Q], vf[:, :, c0:c0 + Q]
        li_c, lf_c = li[..., c0:c0 + Q], lf[..., c0:c0 + Q]
        a = torch.cumsum(lf_c, dim=-1)  # decay chunk-start..j (inclusive)
        g = a[..., -1]  # total chunk decay
        # per-position stabilizer: max(inter, intra)
        intra_sc = a[..., :, None] - a[..., None, :] + li_c[..., None, :]  # [B,H,Q,Q] (j,t)
        intra_sc = torch.where(tri, intra_sc, -torch.inf)
        m_intra = intra_sc.amax(dim=-1)  # [B,H,Q]
        m_inter = a + m[..., None]  # [B,H,Q]
        m_j = torch.maximum(m_inter, m_intra)
        # inter-chunk contribution
        inter_w = torch.exp(m_inter - m_j)  # [B,H,Q]
        h_inter = torch.einsum("bhqk,bhkv->bhqv", q_c, C) * inter_w[..., None]
        n_inter = torch.einsum("bhqk,bhk->bhq", q_c, n) * inter_w
        # intra-chunk (masked quadratic)
        w = torch.exp(intra_sc - m_j[..., None])  # [B,H,Q,Q]
        s = torch.einsum("bhqk,bhtk->bhqt", q_c, k_c) * w
        h_intra = torch.einsum("bhqt,bhtv->bhqv", s, v_c)
        n_intra = s.sum(dim=-1)
        den = torch.abs(n_inter + n_intra)
        den = torch.maximum(den, torch.exp(-m_j)) + EPS
        hs.append((h_inter + h_intra) / den[..., None])
        # state update
        m_next = torch.maximum(g + m, (g[..., None] - a + li_c).amax(dim=-1))
        carry_decay = torch.exp(g + m - m_next)  # [B,H]
        kw = torch.exp(g[..., None] - a + li_c - m_next[..., None])  # [B,H,Q]
        C = carry_decay[..., None, None] * C + torch.einsum(
            "bhtk,bhtv->bhkv", k_c * kw[..., None], v_c)
        n = carry_decay[..., None] * n + (k_c * kw[..., None]).sum(dim=2)
        m = m_next
    return torch.cat(hs, dim=2).to(q.dtype), (C, n, m)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------


def _conv_causal(x, w, b, history=None):
    K = w.shape[0]
    pad = (torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
           if history is None else history.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, xp.shape[1] - (K - 1):]


def _heads(x, H):
    B, S, dp = x.shape
    return x.reshape(B, S, H, dp // H).transpose(1, 2)  # [B,H,S,dh]


def mlstm_block(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                state: MLSTMState | None = None, chunk: int = 64):
    """x: [B,S,d]. Returns (out, new_state)."""
    out, new_state = _mlstm_mixer(cfg, p, x, state=state, chunk=chunk)
    return x + out, new_state


def _mlstm_mixer(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                 state: MLSTMState | None, chunk: int):
    """The mLSTM block's branch, without the residual: x [B,S,d] ->
    (out [B,S,d], new_state). Under tensor parallelism the branch runs on
    this rank's heads (module docstring)."""
    B, S, d = x.shape
    H = p["wq"].shape[-3]  # this rank's heads
    tp = H < cfg.n_heads
    dp = p["w_down"].shape[0]
    x = rms_norm(x, p["ln"], cfg.norm_eps)
    xp = copy_to_model(x) if tp else x
    u = xp @ p["w_up"]
    z, gate = u[..., :dp], u[..., dp:]
    c, conv_hist = _conv_causal(z, p["conv_w"], p["conv_b"], None if state is None else state.conv)
    c = silu(c)
    q = torch.einsum("bhsd,hde->bhse", _heads(c, H), p["wq"])
    k = torch.einsum("bhsd,hde->bhse", _heads(c, H), p["wk"])
    v = torch.einsum("bhsd,hde->bhse", _heads(z, H), p["wv"])
    n = cfg.n_heads
    ifg = torch.cat([c @ p["w_i"], c @ p["w_f"]], dim=-1)  # [B,S,2n]
    if tp:  # row-parallel partial sums; the replicated biases are added once, after
        ifg = reduce_from_model(ifg)
    ifg = ifg + torch.cat([p["b_i"], p["b_f"]])
    if tp:  # each rank's heads read their slice: the backward sums every rank's
        ifg = copy_to_model(ifg)
    lo, hi = local_range(n, H)
    li = ifg[..., lo:hi].transpose(1, 2).float()  # [B,H,S]
    lf = log_sigmoid(ifg[..., n + lo:n + hi].transpose(1, 2).float())
    cell_state = None if state is None else (state.C, state.n, state.m)
    if S == 1 and state is not None:
        h, new_cell = mlstm_sequential(q, k, v, li, lf, cell_state)
    else:
        h, new_cell = mlstm_chunkwise(q, k, v, li, lf, cell_state, chunk=chunk)
    h = h.transpose(1, 2).reshape(B, S, dp)
    # per-head group norm (bf16 times the fp32 rsqrt -> fp32, as jnp promotes)
    hg = h.reshape(B, S, H, dp // H)
    hg = hg * torch.rsqrt(torch.mean(hg.float() ** 2, dim=-1, keepdim=True) + cfg.norm_eps)
    h = hg.reshape(B, S, dp).to(x.dtype) * p["out_norm"]
    out = (h * silu(gate)) @ p["w_down"]
    # reference :290, the output on "embed_act": the heads' partial sums
    return (reduce_from_model(out) if tp else out), MLSTMState(*new_cell, conv_hist)


def slstm_block(cfg: ArchConfig, p: dict, x: torch.Tensor, *, state: SLSTMState | None = None):
    """Sequential sLSTM block + PF-4/3 gated FFN. x: [B,S,d]."""
    res = x
    out, new_state = _slstm_cell(cfg, p, x, state=state)
    # the FFN's norm reads the residual sum before its bf16 rounding, as the
    # reference's compiled block does (see ``transformer._block``)
    m_in = rms_norm(res.float() + out.float(), p["ln_ffn"], cfg.norm_eps).to(x.dtype)
    x = res + out
    # gated FFN: column-parallel up, row-parallel down under TP
    dff = p["ffn_down"].shape[0]
    tp = dff < _slstm_dff(cfg.d_model)
    if tp:
        m_in = copy_to_model(m_in)
    u = m_in @ p["ffn_up"]
    h2 = gelu(u[..., :dff]) * u[..., dff:]
    down = h2 @ p["ffn_down"]
    return x + (reduce_from_model(down) if tp else down), new_state


def _slstm_cell(cfg: ArchConfig, p: dict, x: torch.Tensor, *, state: SLSTMState | None):
    """The sLSTM block's recurrent branch, without the residual and the FFN:
    x [B,S,d] -> (out [B,S,d], new_state)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    tp = p["w_zifo"].shape[-1] < 4 * d  # this rank's columns of each gate
    if tp:
        xn = copy_to_model(xn)
    wx = xn @ p["w_zifo"] + p["b_zifo"]  # [B,S,4d]
    if tp:  # the four gates' columns from every rank: the recurrence runs whole
        wx = gather_from_model(wx.reshape(B, S, 4, -1), -1)
    wx = wx.reshape(B, S, 4, H, dh).float().permute(1, 0, 3, 2, 4)  # [S,B,H,4,dh]

    if state is None:
        zeros = torch.zeros((B, H, dh), dtype=torch.float32, device=x.device)
        state = SLSTMState(zeros, zeros + EPS, zeros - 10.0, zeros)
    c, n, m, h = state
    r = p["r_zifo"].float()  # [H, dh, 4dh]
    hs = []
    for t in range(S):
        wx_t = wx[t]
        rec = torch.einsum("bhd,hde->bhe", h, r).reshape(B, H, 4, dh)
        zt = torch.tanh(wx_t[:, :, 0] + rec[:, :, 0])
        it = wx_t[:, :, 1] + rec[:, :, 1]
        ft = wx_t[:, :, 2] + rec[:, :, 2]
        ot = sigmoid(wx_t[:, :, 3] + rec[:, :, 3])
        lf = log_sigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        f_w, i_w = torch.exp(lf + m - m_new), torch.exp(it - m_new)  # each once; same bits
        c = f_w * c + i_w * zt
        n = f_w * n + i_w
        m = m_new
        h = ot * c / (n + EPS)
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    return rms_norm(out, p["out_norm"], cfg.norm_eps), SLSTMState(c, n, m, h)


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------


def forward(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    *,
    working_table: Optional[torch.Tensor] = None,
    remat: bool = True,
    chunk: int = 64,
    attn_impl: str = "auto",  # attention-free arch: accepted for API parity
):
    """-> (logits [B, S, V] fp32, aux 0), every block from a zero state.
    ``remat``: each mLSTM block under ``torch.utils.checkpoint`` while
    autograd records (no value changes)."""
    h = embed_tokens(cfg, params, tokens, working_table)
    n_super, m_per = layout(cfg)
    mlstm = [unstack(sp, m_per) for sp in unstack(params["mlstm"], n_super)]
    slstm = unstack(params["slstm"], n_super) if cfg.slstm_every > 0 else None

    def m_block(h, lp):
        return mlstm_block(cfg, _cast(gather_weights(lp, "mlstm")), h, chunk=chunk)[0]

    for s in range(n_super):
        for j in range(m_per):
            h = remat_call(remat, m_block, h, mlstm[s][j])
        if slstm is not None:
            h, _ = slstm_block(cfg, _cast(gather_weights(slstm[s], "slstm")), h)
    return _logits(cfg, params, h), torch.zeros((), device=h.device)


def init_cache(cfg: ArchConfig, batch: int, device="cuda") -> XLSTMCache:
    n_super, m_per = layout(cfg)
    d = cfg.d_model
    dp = int(cfg.proj_factor * d)
    H = cfg.n_heads
    dh_m = dp // H
    dh_s = d // H
    f32 = dict(dtype=torch.float32, device=device)
    m = MLSTMState(
        torch.zeros((n_super, m_per, batch, H, dh_m, dh_m), **f32),
        torch.zeros((n_super, m_per, batch, H, dh_m), **f32),
        torch.full((n_super, m_per, batch, H), -torch.inf, **f32),
        torch.zeros((n_super, m_per, batch, CONV_K - 1, dp), **f32),
    )
    s = SLSTMState(
        torch.zeros((n_super, batch, H, dh_s), **f32),
        torch.zeros((n_super, batch, H, dh_s), **f32) + EPS,
        torch.zeros((n_super, batch, H, dh_s), **f32) - 10.0,
        torch.zeros((n_super, batch, H, dh_s), **f32),
    )
    return XLSTMCache(m, s)


def decode_step(
    cfg: ArchConfig,
    params,
    token: torch.Tensor,  # [B, 1]
    cache: XLSTMCache,
    pos=None,  # unused (stateful recurrence); kept for API uniformity
    *,
    working_table: Optional[torch.Tensor] = None,
):
    """One token through every block from its cached state -> (logits [B, 1,
    V], the cache, every state written in place)."""
    h = embed_tokens(cfg, params, token, working_table)
    n_super, m_per = layout(cfg)
    for s in range(n_super):
        for j in range(m_per):
            st = MLSTMState(*(a[s, j] for a in cache.mlstm))
            lp = gather_weights(take(take(params["mlstm"], s), j), "mlstm")
            h, new = mlstm_block(cfg, _cast(lp), h, state=st)
            for old, upd in zip(st, new):
                old.copy_(upd)
        if cfg.slstm_every > 0:
            st = SLSTMState(*(a[s] for a in cache.slstm))
            lp = gather_weights(take(params["slstm"], s), "slstm")
            h, new = slstm_block(cfg, _cast(lp), h, state=st)
            for old, upd in zip(st, new):
                old.copy_(upd)
    return _logits(cfg, params, h), cache
