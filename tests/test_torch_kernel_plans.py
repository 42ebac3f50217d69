"""The host-side arithmetic of two CUDA kernels, on the CPU (no card).

* ``feature_extract``'s recip kernel takes ``n % d`` as a multiply by the
  reciprocal ``umod_magic`` computes; ``umod_model`` is that arithmetic in
  Python integers, held here to Python's ``%`` over the moduli the port
  meets (key spaces up to 2^63, slot counts up to 2^31 - 1) at the dividends
  where a round-up reciprocal could go wrong, and, with ``splitmix64``
  spelled the same way, to ``extract_host`` on whole batches, through the
  kernel's four-position groups and their ragged tail.
* ``embedding_lookup``'s launch plan (``lookup_plan``): an emulation of each
  kernel's thread -> (row, chunk) map, in the source's index arithmetic,
  covers every output chunk exactly once and no chunk past a row, for the
  widths and batch sizes of the port's paths and edge cases, fp32 and bf16,
  16-byte aligned and not.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.keys import splitmix64  # noqa: E402
from repro_torch.data.synthetic_ctr import extract_host  # noqa: E402
from repro_torch.kernels.embedding_lookup import (  # noqa: E402
    CHUNKS_PER_LANE,
    UNROLL,
    lookup_plan,
)
from repro_torch.kernels.feature_extract import umod_magic, umod_model  # noqa: E402

U64 = (1 << 64) - 1
MODULI = [1, 2, 3, 7, 125, 128, 600_000, 2**20, 2**31 - 1, 2**32 - 5, 6 * 10**10,
          2 * 10**11, 2**63 - 25, 2**63]
N_SMS = 132  # an H100's


def _dividends(d: int, rng: random.Random) -> list[int]:
    top = (U64 // d) * d  # the multiple of d nearest 2^64 from below, and the one above
    near = [m + e for m in (top, top + d) for e in (-1, 0, 1)]
    fixed = [0, 1, d - 1, d, d + 1, 2**32 - 1, 2**32 + 1, 2**63 - 1, 2**63, U64, *near]
    return [n for n in fixed if 0 <= n <= U64] + [rng.getrandbits(64) for _ in range(3000)]


@pytest.mark.parametrize("d", MODULI)
def test_reciprocal_modulo_equals_python_modulo(d):
    m, s = umod_magic(d)
    assert 0 <= m < 2**64 and 0 <= s < 64
    assert (m == 0) == (d & (d - 1) == 0)  # powers of two (and 1) take the mask
    rng = random.Random(d)
    for n in _dividends(d, rng):
        assert umod_model(n, d, m, s) == n % d, (d, n)


def test_reciprocal_refuses_moduli_outside_u64():
    for d in (0, -3, 2**64):
        with pytest.raises(ValueError, match="modulus"):
            umod_magic(d)


def _recip_kernel_emulated(raw: np.ndarray, valid: np.ndarray, n_keys: int, n_slots: int,
                           key_seed: int, slot_seed: int):
    """csrc/feature_extract.cu's feature_extract_kernel_recip in Python
    integers: groups of four positions, the last one ragged, a raw id read
    only where its position is valid."""
    flat_raw, flat_valid = raw.reshape(-1), valid.reshape(-1)
    n = flat_raw.size
    keys, slots = np.zeros(n, dtype=np.uint64), np.zeros(n, dtype=np.int32)
    (km, ks), (sm, ss) = umod_magic(n_keys), umod_magic(n_slots)
    seen = np.zeros(n, dtype=np.int64)
    for g in range((n + 3) // 4):
        i0 = 4 * g
        for j in range(min(4, n - i0)):
            seen[i0 + j] += 1
            if flat_valid[i0 + j]:
                h = int(splitmix64(np.uint64(int(flat_raw[i0 + j]) ^ key_seed)))
                key = umod_model(h, n_keys, km, ks)
                keys[i0 + j] = key
                h = int(splitmix64(np.uint64(key ^ slot_seed)))
                slots[i0 + j] = umod_model(h, n_slots, sm, ss)
    assert (seen == 1).all()  # every position in exactly one group, none past the end
    return keys.reshape(raw.shape), slots.reshape(raw.shape)


@pytest.mark.parametrize("shape,n_keys,n_slots", [
    ((16, 50), 600_000, 125), ((7, 33), 6 * 10**10, 125), ((5, 9), 2**63 - 25, 2**31 - 1),
    ((3, 5), 2**63, 128), ((1, 3), 2**32 - 5, 7), ((2, 11), 2 * 10**11, 1),
])
def test_recip_kernel_arithmetic_equals_host_extraction(shape, n_keys, n_slots):
    rng = np.random.default_rng(shape[1])
    raw = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    edge = np.array([0, 2**63, U64, 0xFFFFFFFF], dtype=np.uint64)
    raw.reshape(-1)[:4] = edge[:raw.size]
    lengths = rng.integers(0, shape[1] + 1, shape[0]).astype(np.int32)
    want_k, want_s, want_v = extract_host(raw, lengths, n_keys, n_slots, key_seed=17,
                                          slot_seed=31)
    got_k, got_s = _recip_kernel_emulated(raw, want_v, n_keys, n_slots, 17, 31)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_s, want_s)


# ------------------------------------------------------------ lookup plans

LOOKUP_DIMS = [1, 7, 8, 64, 192, 256, 320, 384, 1024, 2048, 4096, 4099]
LOOKUP_BATCHES = [1, 4, 333, 896, 1536, 8192, 256_000]
LOOKUP_CASES = [(D, dt, aligned) for D in LOOKUP_DIMS for dt in (4, 2)
                for aligned in (True, False) if not aligned or D * dt % 16 == 0]


def _once(values: np.ndarray, n: int) -> bool:
    """``values`` holds each of 0 .. n-1 exactly once."""
    return values.size == n and (np.bincount(values, minlength=n) == 1).all()


def _subwarp_covers(plan, B: int) -> None:
    C, L, rb, k, P, T = (plan.chunks, plan.lanes, plan.row_batches, plan.per_lane,
                         plan.pieces, plan.tasks)
    R = 32 // L
    assert L * R == 32 and (rb == 1 or k == 1) and rb * k <= UNROLL
    assert (k == 1 or L == 32) and (rb == 1 or P == 1)  # the kernels the source instantiates
    assert rb * k & (rb * k - 1) == 0  # the kernel's ITEMS: 1, 2, 4 or 8
    assert plan.block % 32 == 0 and 32 <= plan.block <= 256 and 1 <= plan.grid < 2**31
    n_blocks = -(-B // (R * rb))
    assert T == n_blocks * P  # task t = (row block t // P, piece t % P)
    # grid-stride: warp w takes tasks w, w + W, w + 2W, ...
    W = plan.grid * plan.block // 32
    if T <= 1 << 20:
        t = (np.arange(W)[None, :] + W * np.arange(-(-T // W))[:, None]).reshape(-1)
        assert _once(t[t < T], T)
    # rows: base + j R + g over row blocks, j < rb, g < R; chunks: piece L k +
    # kk L + l over pieces, kk < k, l < L; a task's items are their product
    rows = (np.arange(n_blocks)[:, None, None] * R * rb + np.arange(rb)[None, :, None] * R
            + np.arange(R)[None, None, :]).reshape(-1)
    assert _once(rows[rows < B], B)
    chunks = (np.arange(P)[:, None, None] * L * k + np.arange(k)[None, :, None] * L
              + np.arange(L)[None, None, :]).reshape(-1)
    assert _once(chunks[chunks < C], C)
    # the id shuffle: row j R + g of a task is lane (j R + g) % 32 of id register j R / 32
    j, g = np.meshgrid(np.arange(rb), np.arange(R), indexing="ij")
    reg, lane = (j * R) >> 5, (j * R + g) & 31
    assert (reg * 32 + lane == j * R + g).all() and reg.max() < -(-(R * UNROLL) // 32)
    if T * 32 * rb * k <= 1 << 15:  # every thread's items, one by one
        count = np.zeros((B, C), dtype=np.int64)
        for task in range(T):
            blk, piece = divmod(task, P)
            for ln in range(32):
                gg, ll = divmod(ln, L)
                for i in range(rb * k):
                    jj, kk = (i, 0) if rb > 1 else (0, i)
                    r, c = blk * R * rb + jj * R + gg, piece * L * k + kk * L + ll
                    if r < B and c < C:
                        count[r, c] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("D,elem,aligned", LOOKUP_CASES)
def test_lookup_plans_cover_every_chunk_once(D, elem, aligned):
    for B in LOOKUP_BATCHES:
        row_bytes = D * elem
        plan = lookup_plan(B, D, elem, aligned, N_SMS)
        assert plan.unit == (16 if aligned else elem) and plan.chunks * plan.unit == row_bytes
        assert plan.variant == "subwarp"
        _subwarp_covers(lookup_plan(B, D, elem, aligned, N_SMS, variant="subwarp"), B)
        warp = lookup_plan(B, D, elem, aligned, N_SMS, variant="warp")
        assert warp.grid * warp.block // 32 >= B > (warp.grid - 1) * warp.block // 32


def test_lookup_plan_shapes_of_the_paths():
    """The plans the card's paths get: D = 8 fp32 packs 16 rows a warp and
    8 rows a lane; whisper's prefill holds a whole row of 96 chunks in a
    warp's registers; a decode step's 4 rows are cut into pieces until there
    are as many tasks as SMs; Yi-9B's prefill runs a task a warp, 4 chunks a
    lane."""
    p = lookup_plan(256_000, 8, 4, True, N_SMS)
    assert (p.variant, p.lanes, p.row_batches, p.per_lane) == ("subwarp", 2, UNROLL, 1)
    p = lookup_plan(896, 384, 4, True, N_SMS)
    assert (p.lanes, p.per_lane, p.pieces) == (32, 4, 1)
    p = lookup_plan(4, 4096, 4, True, N_SMS)
    assert (p.per_lane, p.pieces, p.tasks) == (1, 32, 128)
    p = lookup_plan(8192, 4096, 4, True, N_SMS)
    assert (p.variant, p.lanes, p.per_lane, p.pieces) == ("subwarp", 32, CHUNKS_PER_LANE, 8)
    p = lookup_plan(448, 96, 4, True, N_SMS)  # whisper-tiny's d-slice at model = 4: a row a warp
    assert (p.lanes, p.row_batches, p.tasks) == (32, 1, 448)
    assert p.grid * p.block // 32 == p.tasks
    for B, D in ((0, 8), (8, 0)):
        with pytest.raises(ValueError, match="no launch"):
            lookup_plan(B, D, 4, True, N_SMS)
    with pytest.raises(ValueError, match="unknown"):
        lookup_plan(8, 8, 4, True, N_SMS, variant="rows")
