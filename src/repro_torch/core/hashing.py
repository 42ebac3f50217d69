"""OP+OSRP: one permutation + one sign random projection (paper Section 2).

Reduces p-dimensional binary sparse features to 2k-dimensional binary
features:

  1. pseudo-randomly permute the p columns (realized as a keyed bijective
     mix — splitmix64 is a bijection on u64, so permuted position order is a
     true permutation of the key space);
  2. break the permuted columns into k bins (contiguous ranges of the
     permuted order == uniform hash binning);
  3. inside each bin compute z = sum_i x_i * r_i with r_i in {-1,+1};
  4. emit the sign of z expanded to 2 binary dims:
     [0 1] if z > 0, [1 0] if z < 0, [0 0] if z = 0.

Output stays binary so the (binary-optimized) training pipeline is unchanged —
that was the point of the design. Touches each nonzero exactly once.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.keys import hash_keys

_U64 = np.uint64


class OPOSRP:
    def __init__(self, k: int, seed: int = 0):
        if k <= 0:
            raise ValueError("k must be positive")
        self.k = k
        self.seed = seed

    def bin_of(self, cols: np.ndarray) -> np.ndarray:
        """Bin index in [0, k) for each column id (steps 1+2)."""
        return (hash_keys(cols, self.seed) % _U64(self.k)).astype(np.int64)

    def sign_of(self, cols: np.ndarray) -> np.ndarray:
        """Rademacher sign for each column id (step 3)."""
        bit = (hash_keys(cols, self.seed ^ 0x5EED) >> _U64(63)).astype(np.int64)
        return bit * 2 - 1

    def transform_row(self, nz_cols: np.ndarray) -> np.ndarray:
        """Hash one example's nonzero column ids -> nonzero output feature ids.

        Output feature ids live in [0, 2k): bin b maps to 2b (z<0) or 2b+1
        (z>0); z==0 emits nothing.
        """
        nz_cols = np.asarray(nz_cols, dtype=np.uint64)
        bins = self.bin_of(nz_cols)
        signs = self.sign_of(nz_cols)
        uniq, inv = np.unique(bins, return_inverse=True)
        z = np.zeros(len(uniq), dtype=np.int64)
        np.add.at(z, inv, signs)
        nz = uniq[z != 0]
        sign = (z[z != 0] > 0).astype(np.int64)
        return (nz * 2 + sign).astype(np.int64)

    def transform_batch(self, rows: list[np.ndarray]) -> list[np.ndarray]:
        return [self.transform_row(r) for r in rows]

    def transform_padded(self, cols: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized batch transform on padded [B, nnz] column-id matrices.

        cols: uint64 [B, nnz]; valid: bool [B, nnz]. Returns (out_cols,
        out_valid) with out feature ids in [0, 2k), padded with zeros.
        """
        B, nnz = cols.shape
        bins = self.bin_of(cols.reshape(-1)).reshape(B, nnz)
        signs = self.sign_of(cols.reshape(-1)).reshape(B, nnz) * valid
        # accumulate z per (row, bin) via a flat bincount
        flat = bins + np.arange(B)[:, None] * self.k
        z = np.bincount(flat.reshape(-1), weights=signs.reshape(-1), minlength=B * self.k)
        z = z.reshape(B, self.k)
        out_valid = z != 0
        out_cols = (np.arange(self.k)[None, :] * 2 + (z > 0)).astype(np.uint64)
        return out_cols, out_valid
