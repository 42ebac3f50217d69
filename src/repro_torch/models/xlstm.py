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
rank's contiguous 1/M of the inner width's channels: its columns of
``w_up``'s two blocks, its channels of the conv and ``out_norm``, and the
output columns of ``wq``/``wk``/``wv`` that make those channels;
``w_i``/``w_f`` are row-parallel: their partial sums are reduced, the
replicated biases added once, and each rank reads the gates of the heads
its channels touch (``copy_to_model``, so the biases' gradient sums every
rank's); ``w_down`` is row-parallel, reduced on the way out. Where the
axis divides the heads the channels are whole heads and the block runs on
them as the world of one does. Where it does not (xlstm-1.3b's 4 heads at
8: half a head a rank; 3 heads at 2: one and a half), the channels cut
inside a head: c and z are gathered whole over ``model``, each rank
computes q, k and v on its own columns, q and k are gathered into the
whole heads its channels touch, and the cell runs on those heads' q and k
with v, C and h on the rank's columns (n and m whole for each touched
head, on every rank that touches it); the per-head group norm reduces its
sums of squares over ``model`` in fp32 (``_mlstm_inside``). Where the
rules leave ``wq``/``wk``/``wv`` whole (a head dim the axis does not
divide) each rank reads its columns of them (``copy_to_model``, so their
gradient sums every rank's). An sLSTM block computes its columns
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
    block_range,
    copy_to_model,
    gather_from_model,
    gather_over_model,
    gather_weights,
    gelu,
    head_columns,
    local_range,
    model_rank_and_size,
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
    C: torch.Tensor  # [B, H, dk, dv]; cut inside a head: [B, dk, this rank's channels]
    n: torch.Tensor  # [B, H, dk] (the heads this rank's channels touch)
    m: torch.Tensor  # [B, H]
    conv: torch.Tensor  # [B, K-1, dp] (this rank's channels)


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


def _zero_cell(q: torch.Tensor, v: torch.Tensor):
    B, H, _, dk = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    return (torch.zeros((B, H, dk, v.shape[-1]), **f32), torch.zeros((B, H, dk), **f32),
            torch.full((B, H), -torch.inf, **f32))


def mlstm_sequential(q, k, v, li, lf, state: tuple | None = None):
    """q,k: [B,H,S,dk]; v: [B,H,S,dv]; li,lf: [B,H,S]. Returns (h [B,H,S,dv],
    state)."""
    S, dh = q.shape[2], q.shape[3]
    C, n, m = _zero_cell(q, v) if state is None else state
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
    C, n, m = _zero_cell(q, v) if state is None else state
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


def _own_columns(w: torch.Tensor, lo: int, hi: int, dh: int) -> torch.Tensor:
    """A whole per-head projection [H, dh, dh] -> the part that makes
    channels [lo, hi) of the inner width: its heads where the range is
    whole heads, else its flattened (head, output column) index's [dh,
    hi - lo] (``launch/sharding.py``'s two cuts of ``HEAD_CUT``)."""
    if lo % dh == 0 and hi % dh == 0:
        return w[lo // dh:hi // dh]
    return head_columns(w, lo, hi)


def _mlstm_mixer(cfg: ArchConfig, p: dict, x: torch.Tensor, *,
                 state: MLSTMState | None, chunk: int):
    """The mLSTM block's branch, without the residual: x [B,S,d] ->
    (out [B,S,d], new_state). Under tensor parallelism the branch runs on
    this rank's channels (module docstring)."""
    B, S, d = x.shape
    n = cfg.n_heads
    dp = p["w_down"].shape[0]  # this rank's channels of the inner width
    dh = int(cfg.proj_factor * d) // n
    tp = dp < n * dh
    lo, hi = local_range(n * dh, dp)
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    if tp and wq.dim() == 3 and wq.shape[0] == n:  # whole on every rank: this rank's part
        wq, wk, wv = (_own_columns(copy_to_model(w), lo, hi, dh) for w in (wq, wk, wv))
    x = rms_norm(x, p["ln"], cfg.norm_eps)
    xp = copy_to_model(x) if tp else x
    u = xp @ p["w_up"]
    z, gate = u[..., :dp], u[..., dp:]
    c, conv_hist = _conv_causal(z, p["conv_w"], p["conv_b"], None if state is None else state.conv)
    c = silu(c)
    ifg = torch.cat([c @ p["w_i"], c @ p["w_f"]], dim=-1)  # [B,S,2n]
    if tp:  # row-parallel partial sums; the replicated biases are added once, after
        ifg = reduce_from_model(ifg)
    ifg = ifg + torch.cat([p["b_i"], p["b_f"]])
    if tp:  # each rank's heads read their slice: the backward sums every rank's
        ifg = copy_to_model(ifg)
    h_lo, h_hi = lo // dh, (hi - 1) // dh + 1  # the heads this rank's channels touch
    li = ifg[..., h_lo:h_hi].transpose(1, 2).float()  # [B,H,S]
    lf = log_sigmoid(ifg[..., n + h_lo:n + h_hi].transpose(1, 2).float())
    if wq.dim() == 2:  # the channels cut inside a head
        h, new_cell = _mlstm_inside(cfg, c, z, (wq, wk, wv), li, lf, lo, hi, state, chunk)
    else:
        H = wq.shape[0]
        q = torch.einsum("bhsd,hde->bhse", _heads(c, H), wq)
        k = torch.einsum("bhsd,hde->bhse", _heads(c, H), wk)
        v = torch.einsum("bhsd,hde->bhse", _heads(z, H), wv)
        cell_state = None if state is None else (state.C, state.n, state.m)
        if S == 1 and state is not None:
            h, new_cell = mlstm_sequential(q, k, v, li, lf, cell_state)
        else:
            h, new_cell = mlstm_chunkwise(q, k, v, li, lf, cell_state, chunk=chunk)
        h = h.transpose(1, 2).reshape(B, S, dp)
        # per-head group norm (bf16 times the fp32 rsqrt -> fp32, as jnp promotes)
        hg = h.reshape(B, S, H, dh)
        hg = hg * torch.rsqrt(torch.mean(hg.float() ** 2, dim=-1, keepdim=True) + cfg.norm_eps)
        h = hg.reshape(B, S, dp)
    h = h.to(x.dtype) * p["out_norm"]
    out = (h * silu(gate)) @ p["w_down"]
    # reference :290, the output on "embed_act": the channels' partial sums
    return (reduce_from_model(out) if tp else out), MLSTMState(*new_cell, conv_hist)


def _mlstm_inside(cfg: ArchConfig, c, z, w: tuple, li, lf, lo: int, hi: int,
                  state: MLSTMState | None, chunk: int):
    """The mLSTM cell and its group norm on channels [lo, hi) of the inner
    width where they cut inside a head: c, z [B,S,hi-lo] (this rank's);
    ``w``: this rank's output columns of ``wq``, ``wk``, ``wv`` [dh,
    hi-lo]; li, lf [B,T,S] of the T heads the channels touch -> (h
    [B,S,hi-lo] normed, fp32, (C [B,dh,hi-lo], n [B,T,dh], m [B,T])). c
    and z are gathered whole over ``model``, q and k computed on this
    rank's columns and gathered into the touched heads (each backward
    reduce-scatters: every rank reads its own part of the whole); the cell
    runs once a touched head on that head's q, k and this rank's columns
    of its v; the group norm's per-head sums of squares are reduced over
    ``model`` in fp32."""
    B, S, _ = c.shape
    n = cfg.n_heads
    dh = w[0].shape[0]
    h_lo = lo // dh
    segs = [(h, max(lo, h * dh) - lo, min(hi, (h + 1) * dh) - lo)  # (head, its local columns)
            for h in range(h_lo, (hi - 1) // dh + 1)]
    whole = gather_over_model(torch.stack([c, z], dim=2), -1)  # [B,S,2,n dh]
    heads = lambda t, h: t[..., h * dh:(h + 1) * dh]
    q, k, v = (torch.cat([heads(whole[:, :, src], h) @ wt[:, a:b] for h, a, b in segs], -1)
               for wt, src in zip(w, (0, 0, 1)))  # this rank's columns [B,S,hi-lo]
    qk = gather_over_model(torch.stack([q, k], dim=2), -1)[..., h_lo * dh:segs[-1][0] * dh + dh]
    q, k = (_heads(qk[:, :, i], len(segs)) for i in (0, 1))  # [B,T,S,dh]
    hs, Cs, ns, ms = [], [], [], []
    for t, (h, a, b) in enumerate(segs):
        one = lambda x: x[:, t:t + 1]
        cell = None if state is None else (state.C[..., None, :, a:b], one(state.n), one(state.m))
        args = (one(q), one(k), v[..., None, :, a:b], one(li), one(lf), cell)
        if S == 1 and state is not None:
            ht, (Ct, nt, mt) = mlstm_sequential(*args)
        else:
            ht, (Ct, nt, mt) = mlstm_chunkwise(*args, chunk=chunk)
        hs.append(ht[:, 0])  # [B,S,b-a]
        Cs.append(Ct[:, 0])
        ns.append(nt)
        ms.append(mt)
    # the per-head group norm: each head's sum of squares over its whole dh, in fp32
    ss = torch.stack([(ht.float() ** 2).sum(-1) for ht in hs], dim=-1)  # [B,S,T]
    ss = torch.nn.functional.pad(ss, (h_lo, n - h_lo - len(segs)))
    ss = copy_to_model(reduce_from_model(ss))[..., h_lo:h_lo + len(segs)]
    rs = torch.rsqrt(ss / dh + cfg.norm_eps)
    h = torch.cat([ht * rs[..., t:t + 1] for t, ht in enumerate(hs)], -1)
    return h, (torch.cat(Cs, -1), torch.cat(ns, 1), torch.cat(ms, 1))


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


def init_cache(cfg: ArchConfig, batch: int, device="cuda", *,
               model: tuple[int, int] | None = None) -> XLSTMCache:
    """Every block's zero state for ``batch`` sequences. ``model``: (rank,
    M) of the ``model`` axis whose shards the mLSTM's state matches
    (default the installed group's; with none, whole): the rank's channels
    of the inner width where M divides it, the heads they touch, and C on
    its heads, or where the channels cut inside a head on its columns
    [.., dh, channels] (``_mlstm_mixer``); the sLSTM's state is whole."""
    n_super, m_per = layout(cfg)
    d = cfg.d_model
    dp = int(cfg.proj_factor * d)
    H = cfg.n_heads
    dh_m = dp // H
    dh_s = d // H
    rank, M = model_rank_and_size() if model is None else model
    lo, hi = (0, dp) if dp % M else block_range(dp, rank, M)  # this rank's channels
    T = (hi - 1) // dh_m + 1 - lo // dh_m  # the heads they touch
    inside = lo % dh_m or hi % dh_m
    f32 = dict(dtype=torch.float32, device=device)
    lead = (n_super, m_per, batch)
    m = MLSTMState(
        torch.zeros(lead + ((dh_m, hi - lo) if inside else (T, dh_m, dh_m)), **f32),
        torch.zeros(lead + (T, dh_m), **f32),
        torch.full(lead + (T,), -torch.inf, **f32),
        torch.zeros(lead + (CONV_K - 1, hi - lo), **f32),
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
