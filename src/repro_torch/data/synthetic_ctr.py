"""Synthetic CTR click logs with a planted ground-truth model.

Mirrors the paper's data shape: each example has ``nnz`` non-zero sparse
features drawn from a zipfian key popularity (real CTR key traffic is heavily
skewed — this is what makes the MEM-PS cache hit ~46%, Fig 4c). Labels come
from a planted sparse-logistic ground truth so AUC is a meaningful,
learnable signal (used by the OP+OSRP Tables-1/2 reproduction and the
lossless-training check).

Batches stream like the paper's HDFS reader: an iterator of CTRBatch.

Two feed modes (DESIGN.md §11):

* ``next_batch`` — the classic host feeder: hashing, slot bucketing and
  packing all happen in numpy on the feeder thread. Kept as the **bitwise
  parity oracle** for the device extraction path.
* ``raw_records`` — emits :class:`RawRecordBatch` of *unhashed* feature-id
  surrogates with variable per-example nnz (what a real log reader hands
  over before any feature extraction). The ingest subsystem
  (:mod:`repro_torch.ingest`) turns these into train-ready batches on device;
  :func:`extract_host` is the host-side numpy reference it must match
  bitwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.keys import hash_keys

KEY_SEED = 17  # raw surrogate -> key hash (the feeder's historical seeds)
SLOT_SEED = 31  # key -> feature slot hash


@dataclass
class CTRBatch:
    keys: np.ndarray  # uint64 [B, nnz] sparse feature keys
    slot_of: np.ndarray  # int32 [B, nnz] feature slot per nonzero
    valid: np.ndarray  # bool [B, nnz]
    labels: np.ndarray  # float32 [B]
    batch_id: int


@dataclass
class RawRecordBatch:
    """One batch of raw log records, pre-extraction.

    ``raw_ids`` are the unhashed string-surrogate feature ids (uint64); only
    the first ``lengths[i]`` entries of row i are real — the rest is reader
    padding with unspecified content. ``labels`` ride along from the log
    (production click logs carry the label; the synthetic generator plants
    it from its ground-truth model at generation time).
    """

    raw_ids: np.ndarray  # uint64 [B, L] unhashed feature-id surrogates
    lengths: np.ndarray  # int32 [B] real (ragged) nnz per example
    labels: np.ndarray  # float32 [B]
    batch_id: int

    @property
    def n_examples(self) -> int:
        return self.raw_ids.shape[0]


def extract_host(
    raw_ids: np.ndarray,
    lengths: np.ndarray | None,
    n_keys: int,
    n_slots: int,
    pack_width: int | None = None,
    key_seed: int = KEY_SEED,
    slot_seed: int = SLOT_SEED,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The host numpy feature extraction: raw ids -> (keys, slot_of, valid).

    THE semantic contract for the device extraction kernel
    (``kernels.ops.feature_extract``): key = ``hash(raw) % n_keys``, slot =
    ``hash(key) % n_slots`` (the feeder hashes the *finished* key), ragged
    rows packed to ``pack_width`` columns (longer rows truncate, shorter
    rows pad), and padded positions pinned to key 0 / slot 0 / invalid.
    ``lengths=None`` means every position is real (the classic fixed-nnz
    feed).
    """
    raw_ids = np.asarray(raw_ids, dtype=np.uint64)
    B, L = raw_ids.shape
    P = L if pack_width is None else pack_width
    raw = raw_ids[:, :P]
    if lengths is None:
        valid = np.ones((B, P), dtype=bool)
    else:
        valid = np.arange(P, dtype=np.int32)[None, :] < np.asarray(
            lengths, dtype=np.int32
        )[:, None]
    keys = hash_keys(raw, seed=key_seed) % np.uint64(n_keys)
    slot_of = (hash_keys(keys, seed=slot_seed) % np.uint64(n_slots)).astype(np.int32)
    keys = np.where(valid, keys, np.uint64(0))
    slot_of = np.where(valid, slot_of, np.int32(0))
    return keys, slot_of, valid


def to_ctr_batch(
    raw: RawRecordBatch, n_keys: int, n_slots: int, pack_width: int
) -> CTRBatch:
    """Host-feeder arm over raw records: numpy-extract one RawRecordBatch
    into a CTRBatch (the baseline the device ingest path is benched and
    parity-pinned against)."""
    keys, slot_of, valid = extract_host(
        raw.raw_ids, raw.lengths, n_keys, n_slots, pack_width=pack_width
    )
    return CTRBatch(keys, slot_of, valid, raw.labels, raw.batch_id)


class SyntheticCTRStream:
    def __init__(
        self,
        n_keys: int,
        nnz: int,
        n_slots: int,
        batch_size: int,
        seed: int = 0,
        zipf_a: float = 1.05,
        noise: float = 1.0,
    ):
        self.n_keys = n_keys
        self.nnz = nnz
        self.n_slots = n_slots
        self.batch_size = batch_size
        self.zipf_a = zipf_a
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self._batch_id = 0

    def _draw_raw(self, size) -> np.ndarray:
        """Unhashed feature-id surrogates via truncated zipf ranks."""
        z = self.rng.zipf(self.zipf_a, size=size)
        return ((z - 1) % self.n_keys).astype(np.uint64)

    def _draw_keys(self, size) -> np.ndarray:
        # raw surrogate -> key via hash so "popular" keys spread across shards
        return hash_keys(self._draw_raw(size), seed=KEY_SEED) % np.uint64(self.n_keys)

    def _ground_truth_logit(self, keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
        # planted weight per key: deterministic in the key, heavy-tailed
        h = hash_keys(keys, seed=23)
        w = ((h >> np.uint64(11)).astype(np.float64) / (1 << 53) - 0.5) * 2.0
        w = np.sign(w) * (np.abs(w) ** 3) * 4.0  # sparsify influence
        return (w * valid).sum(axis=1)

    def _labels_for(self, keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
        B = keys.shape[0]
        logit = self._ground_truth_logit(keys, valid)
        logit = (logit - logit.mean()) / (logit.std() + 1e-6) * 2.0
        p = 1.0 / (1.0 + np.exp(-(logit + self.rng.normal(0, self.noise, B))))
        return (self.rng.random(B) < p).astype(np.float32)

    def next_batch(self) -> CTRBatch:
        B, nnz = self.batch_size, self.nnz
        raw = self._draw_raw((B, nnz))
        keys, slot_of, valid = extract_host(raw, None, self.n_keys, self.n_slots)
        labels = self._labels_for(keys, valid)
        b = CTRBatch(keys, slot_of, valid, labels, self._batch_id)
        self._batch_id += 1
        return b

    def next_raw(self, min_nnz: int = 1, max_nnz: int | None = None) -> RawRecordBatch:
        """One batch of raw records with variable per-example nnz.

        Rows are ``max_nnz`` wide (default: the stream's pack width); row i
        carries ``lengths[i] ~ U[min_nnz, max_nnz]`` real ids. Labels are
        planted from the ground truth over the *packed* view (the first
        ``self.nnz`` columns — what a trainer at this pack width sees).
        """
        B = self.batch_size
        L = self.nnz if max_nnz is None else max_nnz
        raw = self._draw_raw((B, L))
        lengths = self.rng.integers(min_nnz, L + 1, B).astype(np.int32)
        keys, _, valid = extract_host(
            raw, lengths, self.n_keys, self.n_slots, pack_width=self.nnz
        )
        labels = self._labels_for(keys, valid)
        b = RawRecordBatch(raw, lengths, labels, self._batch_id)
        self._batch_id += 1
        return b

    def raw_records(self, min_nnz: int = 1, max_nnz: int | None = None):
        """Endless iterator of :class:`RawRecordBatch` (the ingest feed)."""
        while True:
            yield self.next_raw(min_nnz=min_nnz, max_nnz=max_nnz)

    def __iter__(self):
        while True:
            yield self.next_batch()
