"""Gradient compression + the training wire formats (DESIGN.md §13).

Three mechanisms:

1. **Row-sparse deltas** — inherent to the paper's design: only the rows
   referenced by the batch are communicated (keys + values), never the 10TB
   table. ``sparse_encode``/``sparse_decode`` implement the serving-read
   wire format with optional int8 quantization.
2. **Quantized gradient push with error feedback** — the training push wire
   (arxiv 2201.05500 lineage): per-row symmetric absmax int8 quantization of
   the *delta* against the receiver's current row, float16 scales, keys by
   reference to the batch's already-transmitted pinned set. The quantization
   residual is carried per key in an :class:`ErrorFeedbackStore` and folded
   into the next push of the same row, so the accumulated applied update is
   unbiased over time.
3. **Conflict-class dedup** — :class:`KeyedRowStore` retains the rows pushed
   within a bounded window of recent batches; a repeat-key pull inside that
   window is served from the retained copy (bitwise what the cluster holds,
   single-writer-per-table) for the cost of a pin message instead of a full
   row transfer.

Exact mode is the default everywhere: :class:`WireConfig()` disables both
the lossy push and the dedup window, and the bitwise serial/pipelined parity
contract is untouched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.hash_index import U64Index

# float16 scale ceiling: absmax above 127 * f16_max would quantize through
# an inf scale; clamp mode folds non-finite values to this magnitude so the
# scale stays representable (error feedback absorbs the clipping)
F16_MAX = 65504.0
CLAMP_MAG = np.float32(127.0 * F16_MAX)
# push packet header: magic/version u32, n_rows u32, width u16, emb_dim u16,
# flags u16 (delta bitmap present? keys by reference?), key-set seq u16
PUSH_HEADER_BYTES = 16


def _guard_nonfinite(x: np.ndarray, nonfinite: str) -> tuple[np.ndarray, int]:
    """Handle inf/nan rows before absmax scaling (they poison the scale and
    dequantize to garbage). ``raise`` (default) rejects; ``clamp`` replaces
    nan with 0 and ±inf with ±CLAMP_MAG. Returns (safe x, n bad rows)."""
    finite = np.isfinite(x)
    if finite.all():
        return x, 0
    if nonfinite == "raise":
        bad = int((~finite.all(axis=-1)).sum()) if x.ndim > 1 else 1
        raise ValueError(
            f"quantize_int8: {bad} row(s) contain non-finite values; pass "
            "nonfinite='clamp' to fold them into the finite range"
        )
    if nonfinite != "clamp":
        raise ValueError(f"nonfinite must be 'raise' or 'clamp', got {nonfinite!r}")
    n_bad = int((~finite.all(axis=-1)).sum()) if x.ndim > 1 else 1
    return np.nan_to_num(x, nan=0.0, posinf=CLAMP_MAG, neginf=-CLAMP_MAG), n_bad


def quantize_int8(
    x: np.ndarray, nonfinite: str = "raise"
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric absmax int8 quantization. x: [n, d] float32."""
    x = np.asarray(x).astype(np.float32, copy=False)
    x, _ = _guard_nonfinite(x, nonfinite)
    scale = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    scale = np.where(scale == 0.0, 1.0, scale).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * scale


def quantize_rows_f16(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Absmax int8 with a *float16* per-row scale (2 wire bytes per scale).

    The scale is rounded to f16 BEFORE quantizing, so encode and decode use
    bitwise the same scale. Rows whose absmax/127 underflows f16 get the
    smallest f16 subnormal (values then clip to ±127 and error feedback
    carries the remainder); overflow clamps to f16 max. Caller has already
    guarded non-finite input."""
    x = np.asarray(x, dtype=np.float32)
    absmax = np.abs(x).max(axis=-1, keepdims=True)
    with np.errstate(over="ignore"):  # overflow -> inf, substituted below
        s16 = (absmax / 127.0).astype(np.float16)
    s16 = np.where((s16 == 0) & (absmax > 0), np.float16(6e-8), s16)
    s16 = np.where(np.isinf(s16), np.float16(F16_MAX), s16)
    s32 = s16.astype(np.float32)
    q = np.clip(np.rint(x / np.where(s32 == 0.0, 1.0, s32)), -127, 127).astype(np.int8)
    return q, s16


def dequantize_rows_f16(q: np.ndarray, s16: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * s16.astype(np.float32)


@dataclass
class SparsePacket:
    """Wire format for a row-sparse serving read."""

    keys: np.ndarray  # uint64 [n]
    q: np.ndarray  # int8 [n, d] (or float32 when quantize=False)
    scale: np.ndarray | None  # float32 [n, 1]

    @property
    def nbytes(self) -> int:
        n = self.keys.nbytes + self.q.nbytes
        if self.scale is not None:
            n += self.scale.nbytes
        return n

    @property
    def payload_nbytes(self) -> int:
        """Bytes of the value payload alone (a pull *reply* does not resend
        the keys — they crossed the wire in the request; metering them twice
        over-charges the NIC model)."""
        n = self.q.nbytes
        if self.scale is not None:
            n += self.scale.nbytes
        return n


def sparse_encode(keys: np.ndarray, values: np.ndarray, quantize: bool = True) -> SparsePacket:
    keys = np.asarray(keys, dtype=np.uint64)
    if quantize:
        q, scale = quantize_int8(values)
        return SparsePacket(keys, q, scale)
    return SparsePacket(keys, np.asarray(values, dtype=np.float32), None)


def sparse_decode(pkt: SparsePacket) -> tuple[np.ndarray, np.ndarray]:
    if pkt.scale is None:
        return pkt.keys, pkt.q
    return pkt.keys, dequantize_int8(pkt.q, pkt.scale)


# --------------------------------------------------------------------------
# training push wire (DESIGN.md §13)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WireConfig:
    """Training-wire options carried per table engine.

    * ``quantize_push`` — int8 delta push with error feedback (lossy; the
      exact-mode default ``False`` keeps the bitwise parity contract).
    * ``dedup_window`` — batches of pushed rows retained for repeat-key pull
      dedup (0 = off). Lossless: a dedup-served row is bitwise the cluster
      value (single writer per table; the engine drops the cache whenever
      the cluster reports a degraded heal).
    * ``nonfinite`` — ``'raise'`` (default) or ``'clamp'`` handling of
      non-finite gradient rows at quantization time.
    """

    quantize_push: bool = False
    dedup_window: int = 0
    nonfinite: str = "raise"

    @property
    def enabled(self) -> bool:
        return self.quantize_push or self.dedup_window > 0


@dataclass
class PushPacket:
    """Training push wire format.

    Header (16 B): magic/version, n_rows, width, emb_dim, flags, key-set ref.
    Payload: int8 ``q [n, width]``, f16 scales (one per field group: emb and
    optimizer slots quantize separately so their magnitudes don't share an
    absmax), a 1-bit-per-row delta/absolute bitmap, and — only when the
    receiver has no record of the batch's pinned key set — explicit u64 keys.
    The engine's pushes always reference the key set already shipped by the
    batch's pull request + pin messages, so ``keys_by_ref=True`` and the key
    bytes are zero.
    """

    q: np.ndarray  # int8 [n, width]
    scale_emb: np.ndarray  # f16 [n, 1]
    scale_opt: np.ndarray | None  # f16 [n, 1] when opt slots exist
    is_delta: np.ndarray  # bool [n]: row adds to the receiver's base
    emb_dim: int
    keys: np.ndarray | None = None  # u64 [n] when not by reference

    @property
    def n_rows(self) -> int:
        return self.q.shape[0]

    @property
    def width(self) -> int:
        return self.q.shape[1]

    def row_bytes(self) -> float:
        """Average encoded bytes per row (payload only)."""
        return self.segment_nbytes(self.n_rows) / max(1, self.n_rows)

    def segment_nbytes(self, n_rows: int) -> int:
        """On-wire bytes for a contiguous ``n_rows``-row slice of this packet
        (the cluster meters each remote owner segment separately)."""
        per_row = self.width + 2  # int8 payload + f16 emb scale
        if self.scale_opt is not None:
            per_row += 2
        if self.keys is not None:
            per_row += 8
        return PUSH_HEADER_BYTES + n_rows * per_row + (n_rows + 7) // 8

    @property
    def nbytes(self) -> int:
        return self.segment_nbytes(self.n_rows)


def raw_push_row_bytes(dim: int) -> int:
    """Bytes per row of the exact push wire: u64 key + f32 row."""
    return 8 + 4 * dim


def encode_push(
    new_rows: np.ndarray,
    base_rows: np.ndarray,
    residual: np.ndarray,
    emb_dim: int,
    has_base: np.ndarray | None = None,
    nonfinite: str = "raise",
    keys: np.ndarray | None = None,
) -> tuple[PushPacket, np.ndarray, np.ndarray, int]:
    """Encode one batch's push as a quantized delta packet.

    ``new_rows``/``base_rows``: [n, width] (bf16/f16 inputs are widened to
    f32). Rows where ``has_base`` is False encode absolute values (the
    receiver replaces instead of adds — used when no base is known).
    ``residual`` [n, width] is each row's carried error-feedback state.

    Returns ``(packet, applied, new_residual, n_nonfinite)`` where
    ``applied`` is bitwise the rows the receiver reconstructs (the caller
    pushes exactly these, so wire decode and cluster state cannot diverge)
    and ``new_residual`` is the residual to store back per key.
    """
    new_rows = np.asarray(new_rows).astype(np.float32, copy=False)
    base_rows = np.asarray(base_rows).astype(np.float32, copy=False)
    residual = np.asarray(residual, dtype=np.float32)
    n, width = new_rows.shape
    if has_base is None:
        has_base = np.ones(n, dtype=bool)
    base_eff = np.where(has_base[:, None], base_rows, 0.0).astype(np.float32)
    target = new_rows - base_eff
    g = target + residual
    g, n_bad = _guard_nonfinite(g, nonfinite)
    opt_dim = width - emb_dim
    q = np.empty((n, width), dtype=np.int8)
    qe, se = quantize_rows_f16(g[:, :emb_dim])
    q[:, :emb_dim] = qe
    if opt_dim > 0:
        qo, so = quantize_rows_f16(g[:, emb_dim:])
        q[:, emb_dim:] = qo
    else:
        so = None
    pkt = PushPacket(
        q=q, scale_emb=se, scale_opt=so, is_delta=has_base.copy(),
        emb_dim=emb_dim, keys=None if keys is None else np.asarray(keys, np.uint64),
    )
    deq = decode_push_payload(pkt)
    applied = base_eff + deq
    new_residual = g - deq
    return pkt, applied, new_residual, n_bad


def decode_push_payload(pkt: PushPacket) -> np.ndarray:
    """Dequantize the packet payload (the delta for ``is_delta`` rows, the
    absolute row otherwise) — the receiver adds its base to delta rows."""
    out = np.empty(pkt.q.shape, dtype=np.float32)
    out[:, : pkt.emb_dim] = dequantize_rows_f16(pkt.q[:, : pkt.emb_dim], pkt.scale_emb)
    if pkt.scale_opt is not None:
        out[:, pkt.emb_dim :] = dequantize_rows_f16(pkt.q[:, pkt.emb_dim :], pkt.scale_opt)
    return out


def decode_push(pkt: PushPacket, base_rows: np.ndarray) -> np.ndarray:
    """Receiver-side reconstruction: ``base + delta`` for delta rows, the
    absolute payload otherwise."""
    deq = decode_push_payload(pkt)
    base = np.asarray(base_rows, dtype=np.float32)
    return np.where(pkt.is_delta[:, None], base + deq, deq).astype(np.float32)


# --------------------------------------------------------------------------
# per-key row stores: error-feedback residuals + the dedup/base window
# --------------------------------------------------------------------------


class KeyedRowStore:
    """Vectorized uint64-key -> f32-row store (U64Index over a grown arena).

    Used twice by the wire path: as the **error-feedback store** (one
    residual row per pushed key, unbounded — residuals decay toward the
    quantization step so dropping them is never required for correctness)
    and as the **pushed-row window** (``window > 0``: rows whose last
    writing batch is more than ``window`` batches old are evicted, bounding
    the dedup/base cache to the coalescing window).
    """

    def __init__(self, width: int, window: int = 0, expected: int = 1024):
        self.width = int(width)
        self.window = int(window)
        self.index = U64Index(expected)
        cap = max(16, int(expected))
        self._rows = np.zeros((cap, self.width), dtype=np.float32)
        self._keys = np.zeros(cap, dtype=np.uint64)
        self._seq = np.full(cap, -1, dtype=np.int64)  # last writing batch
        self._n = 0
        self._free: list[int] = []

    def __len__(self) -> int:
        return len(self.index)

    def contains(self, keys: np.ndarray) -> np.ndarray:
        return self.index.contains(keys)

    def get(self, keys: np.ndarray, default: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
        """(rows [n, width], found mask). Absent keys read ``default``."""
        keys = np.asarray(keys, dtype=np.uint64)
        slots = self.index.lookup(keys)
        found = slots >= 0
        out = np.full((len(keys), self.width), default, dtype=np.float32)
        out[found] = self._rows[slots[found]]
        return out, found

    def put(self, keys: np.ndarray, rows: np.ndarray, seq: int = 0) -> None:
        """Upsert unique keys; ``seq`` stamps the writing batch (window
        eviction removes rows with stamp <= seq - window)."""
        keys = np.asarray(keys, dtype=np.uint64)
        rows = np.asarray(rows, dtype=np.float32)
        if len(keys):
            slots = self.index.lookup(keys)
            found = slots >= 0
            fslots = slots[found]
            self._rows[fslots] = rows[found]
            self._seq[fslots] = seq
            miss = ~found
            n_new = int(miss.sum())
            if n_new:
                new_slots = self._alloc(n_new)
                self._rows[new_slots] = rows[miss]
                self._keys[new_slots] = keys[miss]
                self._seq[new_slots] = seq
                self.index.insert(keys[miss], new_slots)
        if self.window > 0:
            self._evict_older_than(seq - self.window)

    def _alloc(self, n: int) -> np.ndarray:
        take = min(n, len(self._free))
        out = [self._free.pop() for _ in range(take)]
        n -= take
        if n:
            if self._n + n > len(self._rows):
                cap = max(2 * len(self._rows), self._n + n)
                for name in ("_rows", "_keys", "_seq"):
                    old = getattr(self, name)
                    new = np.zeros((cap,) + old.shape[1:], dtype=old.dtype)
                    new[: len(old)] = old
                    setattr(self, name, new)
                self._seq[self._n + n :] = -1
            out.extend(range(self._n, self._n + n))
            self._n += n
        return np.asarray(out, dtype=np.int64)

    def _evict_older_than(self, floor_seq: int) -> None:
        live = self._seq[: self._n] >= 0
        stale = live & (self._seq[: self._n] <= floor_seq)
        idx = np.nonzero(stale)[0]
        if idx.size:
            self.index.delete(self._keys[idx])
            self._seq[idx] = -1
            self._free.extend(idx.tolist())

    def clear(self) -> None:
        self.index.clear()
        self._seq[: self._n] = -1
        self._free = []
        self._n = 0

    # --------------------------------------------------- checkpoint support
    def state(self) -> dict[str, np.ndarray]:
        """All live (keys, rows) plus their batch stamps, checkpoint-ready."""
        live = np.nonzero(self._seq[: self._n] >= 0)[0]
        return {
            "keys": self._keys[live].copy(),
            "rows": self._rows[live].copy(),
            "seq": self._seq[live].copy(),
        }

    def load(self, state: dict[str, np.ndarray]) -> None:
        self.clear()
        keys = np.asarray(state["keys"], dtype=np.uint64)
        if len(keys):
            rows = np.asarray(state["rows"], dtype=np.float32)
            seqs = np.asarray(state["seq"], dtype=np.int64)
            slots = self._alloc(len(keys))
            self._rows[slots] = rows
            self._keys[slots] = keys
            self._seq[slots] = seqs
            self.index.insert(keys, slots)


class ErrorFeedbackCompressor:
    """Int8 compression with a dense error-feedback residual buffer.

    compress(g) returns (q, scale); the residual (g + e) - dequant(q) is
    stored and added to the next gradient, so the *accumulated* applied
    update is unbiased over time. (The sparse, per-key variant used by the
    training push wire is :class:`KeyedRowStore` + :func:`encode_push`.)
    """

    def __init__(self, shape: tuple[int, ...]):
        self.residual = np.zeros(shape, dtype=np.float32)

    def compress(self, grad: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        g = grad.astype(np.float32) + self.residual
        flat = g.reshape(g.shape[0], -1) if g.ndim > 1 else g.reshape(1, -1)
        q, scale = quantize_int8(flat)
        deq = dequantize_int8(q, scale).reshape(g.shape)
        self.residual = g - deq
        return q, scale

    def ratio(self) -> float:
        """Compression ratio vs float32 (≈4x minus the per-row scale)."""
        return 4.0 * self.residual.size / (self.residual.size + 4 * self.residual.shape[0])
