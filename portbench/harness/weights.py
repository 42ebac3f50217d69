"""The model's weights, made from the seed on the device: one large normal
draw per kind of leaf, from one ``torch.Generator`` on the device, in the
type the cell runs them in. Each normal leaf has the standard deviation
1 / sqrt(fan-in) (its input width), the norms' weights are ones.

The tree is keyed as the program and the reference both read it (see
``reference/lm.py``); :func:`layout` is the one place that says so.
"""

from __future__ import annotations

import math

import torch

from reference.lm import Model


def layout(m: Model) -> dict:
    """{path: (shape, fan-in or None for ones)} in a fixed order."""
    L, d, hd = m.layers, m.d, m.head_dim
    H, Hkv, ff, V = m.heads, m.kv_heads, m.ff, m.vocab
    out = {
        "layers/ln1": ((L, d), None),
        "layers/ln2": ((L, d), None),
        "layers/attn/wq": ((L, d, H * hd), d),
        "layers/attn/wk": ((L, d, Hkv * hd), d),
        "layers/attn/wv": ((L, d, Hkv * hd), d),
        "layers/attn/wo": ((L, H * hd, d), H * hd),
        "layers/mlp/wi": ((L, d, ff), d),
        "layers/mlp/wo": ((L, ff, d), ff),
        "layers/mlp/wg": ((L, d, ff), d),
        "final_norm": ((d,), None),
        "lm_head": ((d, V), d),
    }
    return out


def make(m: Model, seed: int, dtype: torch.dtype, device) -> dict:
    """The flat {path: tensor} of weights for ``seed``; ``final_norm`` stays
    float32, every other leaf is ``dtype``."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for path, (shape, fan) in layout(m).items():
        dt = torch.float32 if path == "final_norm" else dtype
        if fan is None:
            out[path] = torch.ones(shape, dtype=dt, device=device)
        else:
            t = torch.randn(shape, generator=g, dtype=dt, device=device)
            out[path] = t.mul_(1.0 / math.sqrt(fan))
    return out


def table_rows(vocab: int, d: int, seed: int, device) -> torch.Tensor:
    """A served token table: float32 [vocab, d], normal with standard
    deviation 1, from its own generator."""
    g = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    return torch.randn((vocab, d), generator=g, dtype=torch.float32, device=device)
