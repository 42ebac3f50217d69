"""Token traffic from a mix's parameters and the run's seed.

A mix (``traffic/<name>.json``) names its ``mode`` (the runner that runs
it: ``train`` or ``prefill``) and the shape of its token rows:

  ``rows``, ``seq``: each draw is ``rows`` sequences of ``seq`` tokens
    (a training batch, or one request's prompts); a training draw holds one
    token more a row, the last position's target;
  ``dist``: ``zipf`` (ids ``(zipf(a) - 1) mod vocab``, ``zipf_a`` = a) or
    ``uniform`` (every id alike);
  ``repeat_prev``: each position after the first repeats its left
    neighbour with this probability (weak local structure, so a loss can
    fall);
  ``shape_seed``: the seed of the draws before relabelling.

Every seed gives the same work: the draws come from one stream fixed by
the mix (``shape_seed``), and the run's seed only relabels the vocabulary
by a permutation of its own. So each step or request holds as many
distinct ids, and as many ids it has not held before, whatever the seed;
only which ids they are differs.
"""

from __future__ import annotations

import numpy as np


class Tokens:
    """Draws of int32 [rows, seq (+1 when ``targets``)] ids from ``seed``."""

    def __init__(self, mix: dict, vocab: int, seed: int, *, targets: bool):
        self.rows, self.seq = int(mix["rows"]), int(mix["seq"])
        self.dist, self.rep = mix["dist"], float(mix["repeat_prev"])
        if self.dist not in ("zipf", "uniform"):
            raise ValueError(f"unknown token distribution {self.dist!r}")
        self.a = float(mix.get("zipf_a", 0.0))
        self.vocab = int(vocab)
        self.width = self.seq + (1 if targets else 0)
        self.rng = np.random.default_rng([int(mix["shape_seed"]), 0x70C5])
        self.label = np.random.default_rng([int(seed), 0x1ABE]).permutation(self.vocab)

    def draw(self) -> np.ndarray:
        shape = (self.rows, self.width)
        if self.dist == "zipf":
            toks = (self.rng.zipf(self.a, size=shape) - 1) % self.vocab
        else:
            toks = self.rng.integers(0, self.vocab, size=shape)
        rep = self.rng.random((self.rows, self.width)) < self.rep
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        return self.label[toks].astype(np.int32)
