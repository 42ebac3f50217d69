"""Mamba (S6) selective-SSM mixer — the hybrid heads of Hymba; the port of
the reference's ``models/mamba.py``.

Faithful Mamba-1 structure: in-proj -> causal depthwise conv + SiLU ->
selective scan (input-dependent dt, B, C; diagonal A) -> gate -> out-proj.

Scan strategies (plain PyTorch on either device, as the reference's are
plain jnp):
  * ``recurrent`` — a loop over time, state h [B, din, N]. Exact; O(1)
    state; used for decode and as the oracle.
  * ``chunked``  — a loop over chunks of size Q, each evaluated in parallel
    by a log-depth scan over (decay, value) pairs. Used for prefill.

Tensor parallelism over ``model`` (the launcher installs the group) is
channel-parallel over ``din``, read from the local weights' shapes: a rank
holds its channels of ``x`` and ``z`` (``in_proj``'s two blocks), of the
conv, ``w_dt_up``, ``dt_bias``, ``a_log`` and ``d_skip``, and so runs the
scan on a ``[B, din/M, N]`` state; ``w_bc`` and ``w_dt_down`` are
row-parallel, their partial sums reduced (one all-reduce for both) and
read whole by every channel (``copy_to_model`` on the sum); ``out_proj``
is row-parallel, reduced on the way out (the reference's ``embed_act``
constraint). With no group installed the weights are whole and the mixer
computes what it did.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.common import (
    ParamSpec,
    copy_to_model,
    reduce_from_model,
    silu,
    softplus,
)

EXPAND = 2  # din = EXPAND * d_model


class MambaState(NamedTuple):
    h: torch.Tensor  # [B, din, N] fp32
    conv: torch.Tensor  # [B, K-1, din] — last K-1 inputs for the depthwise conv


def mamba_schema(d_model: int, ssm_state: int, layers: int | None = None, expand: int = EXPAND,
                 conv_k: int = 4, dt_rank: int = 128) -> dict:
    din = expand * d_model
    L = layers
    stack = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    f = len(stack)
    return {
        "in_proj": ParamSpec(stack + (d_model, 2 * din), lax_ + ("embed", "ssm"), fan_axis=f),
        "conv_w": ParamSpec(stack + (conv_k, din), lax_ + (None, "ssm"), scale=0.5, fan_axis=f),
        "conv_b": ParamSpec(stack + (din,), lax_ + ("ssm",), init="zeros"),
        "w_bc": ParamSpec(stack + (din, 2 * ssm_state), lax_ + ("ssm", None), fan_axis=f),
        "w_dt_down": ParamSpec(stack + (din, dt_rank), lax_ + ("ssm", None), fan_axis=f),
        "w_dt_up": ParamSpec(stack + (dt_rank, din), lax_ + (None, "ssm"), fan_axis=f),
        "dt_bias": ParamSpec(stack + (din,), lax_ + ("ssm",), init="zeros"),
        "a_log": ParamSpec(stack + (din, ssm_state), lax_ + ("ssm", None), init="zeros"),
        "d_skip": ParamSpec(stack + (din,), lax_ + ("ssm",), init="ones"),
        "out_proj": ParamSpec(stack + (din, d_model), lax_ + ("ssm", "embed"), fan_axis=f),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None):
    """Depthwise causal conv. x: [B,S,din]; w: [K,din]. history: [B,K-1,din].
    The taps are summed in the reference's order, in x's dtype."""
    K = w.shape[0]
    if history is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = history.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+K-1, din]
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[i]
    out = out + b
    new_hist = xp[:, xp.shape[1] - (K - 1):]
    return out, new_hist


def _ssm_inputs(p: dict, x: torch.Tensor, tp: bool = False):
    """Common projections. x: [B,S,din] (post-conv). Returns dt, B_t, C_t, A.
    ``tp``: x holds this rank's channels, and the row-parallel ``w_bc`` and
    ``w_dt_down`` products are summed over ``model``."""
    N = p["a_log"].shape[-1]
    bc, dt_low = x @ p["w_bc"], x @ p["w_dt_down"]  # [B,S,2N], [B,S,dt_rank]
    if tp:  # every local channel reads the sums whole: the backward sums every rank's
        both = copy_to_model(reduce_from_model(torch.cat([bc, dt_low], dim=-1)))
        bc, dt_low = both[..., :2 * N], both[..., 2 * N:]
    B_t, C_t = bc[..., :N], bc[..., N:]
    dt = softplus(dt_low @ p["w_dt_up"] + p["dt_bias"])  # [B,S,din]
    A = -torch.exp(p["a_log"].float())  # [din, N], negative
    return dt, B_t, C_t, A


def mamba_mixer(p: dict, x: torch.Tensor, *, chunk: int = 256,
                state: MambaState | None = None,
                entered: bool = False) -> tuple[torch.Tensor, MambaState]:
    """Full mixer. With ``state`` (decode), S is typically 1. ``entered``:
    x has entered the model region (the caller's ``copy_to_model``)."""
    B, S, d = x.shape
    din = p["out_proj"].shape[0]  # this rank's channels
    tp = din < EXPAND * d
    if tp and not entered:
        x = copy_to_model(x)
    xz = x @ p["in_proj"]
    xin, z = xz[..., :din], xz[..., din:]
    xin, conv_hist = _conv_causal(xin, p["conv_w"], p["conv_b"],
                                  None if state is None else state.conv)
    xin = silu(xin)
    dt, B_t, C_t, A = _ssm_inputs(p, xin, tp)

    h0 = None if state is None else state.h
    if S == 1 and state is not None:  # decode: one recurrent step
        y, h = _scan_recurrent(xin, dt, B_t, C_t, A, h0)
    else:
        q = min(chunk, S)
        while S % q:  # largest power-of-two-ish divisor (meta tokens etc.)
            q //= 2
        y, h = _scan_chunked(xin, dt, B_t, C_t, A, h0, chunk=max(1, q))
    y = y + p["d_skip"] * xin
    out = (y * silu(z)) @ p["out_proj"]
    return (reduce_from_model(out) if tp else out), MambaState(h, conv_hist)


def _scan_recurrent(xin, dt, B_t, C_t, A, h0):
    """Exact per-step recurrence (oracle + decode). Shapes: xin/dt [B,S,din],
    B_t/C_t [B,S,N], A [din,N]."""
    B, S, din = xin.shape
    N = A.shape[-1]
    h = torch.zeros((B, din, N), dtype=torch.float32, device=xin.device) if h0 is None else h0
    xf, dtf, bf, cf = xin.float(), dt.float(), B_t.float(), C_t.float()
    ys = []
    for t in range(S):
        x_t, dt_t, b_t, c_t = xf[:, t], dtf[:, t], bf[:, t], cf[:, t]
        decay = torch.exp(dt_t[..., None] * A[None])  # [B,din,N]
        drive = (dt_t * x_t)[..., None] * b_t[:, None, :]  # [B,din,N]
        h = decay * h + drive
        ys.append(torch.einsum("bdn,bn->bd", h, c_t))
    return torch.stack(ys, dim=1).to(xin.dtype), h


def _linear_scan(decay: torch.Tensor, value: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (d, v) under the reference's
    ``combine((d1, v1), (d2, v2)) = (d1 d2, d2 v1 + v2)``: log-depth
    doubling steps, each over the whole chunk."""
    Q = decay.shape[1]
    off = 1
    while off < Q:
        value = torch.cat([value[:, :off], decay[:, off:] * value[:, :-off] + value[:, off:]], 1)
        decay = torch.cat([decay[:, :off], decay[:, off:] * decay[:, :-off]], 1)
        off *= 2
    return decay, value


def _scan_chunked(xin, dt, B_t, C_t, A, h0, *, chunk: int):
    """Chunkwise-parallel selective scan.

    Within a chunk (local steps 1..Q) the linear recurrence
    ``h_j = exp(l_j) h_{j-1} + u_j`` is evaluated with an *associative scan*
    over (decay, value) pairs — numerically safe (only products of decays
    <= 1 appear; a cumsum/exp(-cum) closed form overflows f32 for strong
    decays) and log-depth on device. Memory O(Q * din * N) per chunk; the
    outer loop carries the O(1) state between chunks.
    """
    B, S, din = xin.shape
    N = A.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"S={S} must tile by chunk={Q}")
    h = torch.zeros((B, din, N), dtype=torch.float32, device=xin.device) if h0 is None else h0
    ys = []
    for c0 in range(0, S, Q):
        x_q, dt_q = xin[:, c0:c0 + Q].float(), dt[:, c0:c0 + Q].float()
        b_q, c_q = B_t[:, c0:c0 + Q].float(), C_t[:, c0:c0 + Q].float()
        decay = torch.exp(dt_q[..., None] * A[None, None])  # [B,Q,din,N]
        u = (dt_q * x_q)[..., None] * b_q[:, :, None, :]  # [B,Q,din,N]
        D, V = _linear_scan(decay, u)
        h_all = D * h[:, None] + V  # [B,Q,din,N]
        ys.append(torch.einsum("bqdn,bqn->bqd", h_all, c_q))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1).to(xin.dtype), h


def init_mamba_state(p_one_layer: dict, batch: int, n_layers: int | None = None,
                     device="cuda") -> MambaState:
    """Zero state for ``batch`` sequences; ``p_one_layer`` holds one layer's
    leaves or their specs (only shapes are read)."""
    din, N = p_one_layer["a_log"].shape[-2:]
    K = p_one_layer["conv_w"].shape[-2]
    lead = (n_layers,) if n_layers else ()
    return MambaState(
        torch.zeros(lead + (batch, din, N), dtype=torch.float32, device=device),
        torch.zeros(lead + (batch, K - 1, din), dtype=torch.float32, device=device),
    )
