"""The rows a parameter-server table holds for a key it has never seen: a
frozen copy of the rule the PS applies on a first pull, so that the
reference can work out a step's starting rows itself.

Row of key ``k``, column ``j``: ``scale * (2u - 1)`` with ``u`` the top 53
bits of ``splitmix64(splitmix64(k ^ 3) * GOLDEN + j * MIX1)`` over 2^53, in
float32; the optimizer's slots of the row start at zero. Keys of the table
registered first carry no tag bits, so a token id is its own key.
"""

from __future__ import annotations

import numpy as np

GOLDEN = np.uint64(0x9E3779B97F4A7C15)
MIX1 = np.uint64(0xBF58476D1CE4E5B9)
MIX2 = np.uint64(0x94D049BB133111EB)
SEED = np.uint64(3)
# the training launcher's cluster makes rows of this scale
LAUNCHER_SCALE = 0.02


def splitmix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + GOLDEN
        z = (z ^ (z >> np.uint64(30))) * MIX1
        z = (z ^ (z >> np.uint64(27))) * MIX2
        return z ^ (z >> np.uint64(31))


def first_pull_rows(keys: np.ndarray, dim: int, scale: float, chunk: int = 256) -> np.ndarray:
    """float32 [len(keys), dim]: each key's row as a first pull makes it."""
    keys = np.asarray(keys, dtype=np.uint64)
    cols = np.arange(dim, dtype=np.uint64)
    out = np.empty((len(keys), dim), dtype=np.float32)
    for lo in range(0, len(keys), chunk):
        h = splitmix64(keys[lo:lo + chunk] ^ SEED)
        with np.errstate(over="ignore"):
            bits = splitmix64(h[:, None] * GOLDEN + cols[None, :] * MIX1)
        u = (bits >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
        out[lo:lo + chunk] = ((u * 2.0 - 1.0) * scale).astype(np.float32)
    return out
