"""Synthetic LM token streams (zipfian unigram mix with local structure)."""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch_size: int, seq_len: int, seed: int = 0, zipf_a: float = 1.1):
        self.vocab_size = vocab_size
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.zipf_a = zipf_a
        self.rng = np.random.default_rng(seed)

    def next_batch(self) -> np.ndarray:
        z = self.rng.zipf(self.zipf_a, size=(self.batch_size, self.seq_len + 1))
        toks = (z - 1) % self.vocab_size
        # add weak local structure (repeat-prev with p=0.2) so loss can drop
        rep = self.rng.random((self.batch_size, self.seq_len + 1)) < 0.2
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        return toks.astype(np.int32)

    def __iter__(self):
        while True:
            yield self.next_batch()
