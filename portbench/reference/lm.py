"""Plain PyTorch reference of the decoder-only LM the benchmark's cells run:
Llama-style blocks (RMSNorm, rotate-half RoPE, grouped-query attention,
SwiGLU MLP), next-token cross entropy, AdamW on the backbone and row-wise
Adagrad on the token rows.

It follows the published architectures and the benchmark's configuration
files, and imports nothing of the program under test. Every matmul goes
through :func:`mm`, which computes in float32 (TF32 off; see
:func:`strict_fp32`) or, for the lower-precision control, rounds both
operands to float8 e4m3 with a per-tensor scale first.

The parameter tree is keyed as the benchmark's weight maker
(``harness/weights.py``) lays it out:

  layers: ln1 [L, d], ln2 [L, d],
          attn: wq [L, d, H*hd], wk [L, d, Hkv*hd], wv [L, d, Hkv*hd], wo [L, H*hd, d]
          mlp:  wi [L, d, ff], wg [L, d, ff], wo [L, ff, d]
  final_norm [d], lm_head [d, V]
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8 = torch.float8_e4m3fn
F8_MAX = 448.0


def strict_fp32() -> None:
    """Float32 matmuls and convolutions in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Model:
    """The sizes the reference needs, read from a configuration file."""

    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    layers: int
    rope_theta: float
    eps: float


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 under a per-tensor scale and back; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
        return (x / s).to(F8).to(torch.float32) * s

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """``a @ b`` in float32, or on float8-rounded operands (``prec="fp8"``)."""
    if prec == "fp8":
        a, b = _Fp8.apply(a), _Fp8.apply(b)
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE over x [B, H, S, hd] at positions 0..S-1."""
    S, hd = x.shape[2], x.shape[3]
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    c, s = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(q, k, v, prec: str = "fp32", block: int = 1024) -> torch.Tensor:
    """Softmax attention, causal, q [B, H, S, hd] over k, v [B, Hkv, S, hd]
    (query head h reads key head h // (H / Hkv)), in query blocks of
    ``block`` rows, each against the keys it may see."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = []
    for lo in range(0, S, block):
        hi = min(S, lo + block)
        s = mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2), prec) / math.sqrt(hd)
        mask = (torch.arange(hi, device=q.device)[None, :]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill(~mask, -torch.inf), dim=-1)
        out.append(mm(p, v[:, :, :hi], prec))
    return torch.cat(out, dim=2)


def attention(m: Model, x, p: dict, prec: str) -> torch.Tensor:
    B, S, _ = x.shape
    hd = m.head_dim
    q = mm(x, p["wq"], prec).reshape(B, S, m.heads, hd).transpose(1, 2)
    k = mm(x, p["wk"], prec).reshape(B, S, m.kv_heads, hd).transpose(1, 2)
    v = mm(x, p["wv"], prec).reshape(B, S, m.kv_heads, hd).transpose(1, 2)
    o = causal_attention(rope(q, m.rope_theta), rope(k, m.rope_theta), v, prec)
    return mm(o.transpose(1, 2).reshape(B, S, m.heads * hd), p["wo"], prec)


def swiglu(x, wi, wg, wo, prec: str) -> torch.Tensor:
    return mm(F.silu(mm(x, wg, prec)) * mm(x, wi, prec), wo, prec)


def layer(m: Model, h, lp: dict, prec: str) -> torch.Tensor:
    h = h + attention(m, rms_norm(h, lp["ln1"], m.eps), lp["attn"], prec)
    x = rms_norm(h, lp["ln2"], m.eps)
    return h + swiglu(x, lp["mlp"]["wi"], lp["mlp"]["wg"], lp["mlp"]["wo"], prec)


def take(tree, i: int):
    if isinstance(tree, dict):
        return {k: take(v, i) for k, v in tree.items()}
    return tree[i]


def hidden(m: Model, params: dict, x: torch.Tensor, prec: str = "fp32", *, remat: bool = False,
           cast=None):
    """The layer stack over input embeddings x [B, S, d] -> the final
    normed hidden states. ``cast(leaf)`` makes a layer's weights float32 as
    they are read (default: as they are); ``remat`` recomputes each layer
    in the backward."""
    cast = cast or (lambda t: t)
    h = x
    for i in range(m.layers):
        lp = _tree_map(cast, take(params["layers"], i))
        if remat and torch.is_grad_enabled():
            h = checkpoint(layer, m, h, lp, prec, use_reentrant=False)
        else:
            h = layer(m, h, lp, prec)
    return rms_norm(h, cast(params["final_norm"]), m.eps)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree, prefix: str = "") -> dict:
    """{"a/b/c": tensor} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


# --------------------------------------------------------------------------
# training: loss and gradients, AdamW, row Adagrad
# --------------------------------------------------------------------------


def loss_and_grads(m: Model, params: dict, rows: torch.Tensor, slots: torch.Tensor,
                   targets: torch.Tensor, microbatches: int, prec: str = "fp32"):
    """One training step's gradients over a batch of ``slots`` [B, S] (rows
    of the working table ``rows`` [n, d]) and their next tokens
    ``targets`` [B, S]: the batch in ``microbatches`` equal parts, each
    part's cross entropy differentiated, the gradients
    averaged over the parts. -> (mean CE over the parts, {leaf: grad},
    the rows' gradient)."""
    flat = leaves(params)
    names = list(flat)
    B = slots.shape[0]
    n = B // microbatches
    acc, ces = None, []
    for i in range(microbatches):
        ps = {k: v.detach().requires_grad_() for k, v in flat.items()}
        tree = unflatten(ps)
        table = rows.detach().requires_grad_()
        sl, tg = slots[i * n:(i + 1) * n].long(), targets[i * n:(i + 1) * n].long()
        h = hidden(m, tree, table[sl], prec, remat=True)
        logits = mm(h, tree["lm_head"], prec)
        ce = F.cross_entropy(logits.reshape(-1, m.vocab), tg.reshape(-1))
        gs = torch.autograd.grad(ce, [ps[k] for k in names] + [table])
        if acc is None:
            acc = [g.clone() for g in gs]
        else:
            for a, g in zip(acc, gs):
                a.add_(g)
        ces.append(ce.detach())
        del h, logits, gs, ps, tree, table
    acc = [a / microbatches for a in acc]
    return torch.stack(ces).mean(), dict(zip(names, acc[:-1])), acc[-1]


def unflatten(flat: dict) -> dict:
    """The nested dict of a flat {"a/b/c": tensor} one."""
    out: dict = {}
    for path, v in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


@dataclass(frozen=True)
class AdamW:
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def step(self, t: int, params: dict, grads: dict, m: dict, v: dict) -> dict:
        """AdamW step ``t`` (from 1) over flat dicts, in place; the gradients
        clipped to a global norm of ``clip_norm`` first. Returns the clipped
        gradients."""
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp_max(self.clip_norm / (gnorm + 1e-9), 1.0)
        bc1, bc2 = 1 - self.b1 ** t, 1 - self.b2 ** t
        clipped = {}
        for k, p in params.items():
            g = grads[k] * scale
            clipped[k] = g
            m[k].mul_(self.b1).add_((1 - self.b1) * g)
            v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.sub_(self.lr * u)
        return clipped


def adagrad(rows: torch.Tensor, acc: torch.Tensor, g: torch.Tensor, lr: float,
            eps: float = 1e-8) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise Adagrad: ``a += g^2``, ``p -= lr * g / (sqrt(a) + eps)``."""
    acc = acc + g * g
    return rows - lr * g / (torch.sqrt(acc) + eps), acc


# --------------------------------------------------------------------------
# serving: logits of a prompt
# --------------------------------------------------------------------------


@torch.no_grad()
def prompt_logits(m: Model, params: dict, x: torch.Tensor, prec: str = "fp32",
                  last_only: bool = True) -> torch.Tensor:
    """Logits [S or 1, V] of one prompt's input embeddings x [1, S, d], the
    weights made float32 a layer at a time as they are read."""
    h = hidden(m, params, x.float(), prec, cast=lambda t: t.float())
    if last_only:
        h = h[:, -1:]
    return mm(h[0], params["lm_head"].float(), prec)
