"""The port's kernel modules against the JAX reference.

On the CPU the port's plain PyTorch versions run; they are held against
``repro.kernels.ref`` and the reference's Pallas kernels in interpret mode
on shared numpy inputs. Dyadic-grid inputs must match bitwise (every sum is
exact in fp32); random normal inputs within ``rtol=1e-6`` for fp32, one
bf16 ulp (2**-7 relative) for bf16 tables. ``scatter_add`` and Adagrad are
bitwise on random normal data too, as their oracles fix the order and the
rounding of every operation; ``embedding_lookup`` moves bits, so it is
bitwise on any data. Attention is fp32 math summed in other orders than the
reference's: within the reference's own 2e-5. The CUDA kernels are held against the plain
versions on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.core.hbm_ps import WorkingTable as JWorkingTable  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag_pallas  # noqa: E402
from repro.kernels.embedding_lookup import embedding_lookup_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.topk_mips import topk_mips_pallas  # noqa: E402
from repro_torch.core.hbm_ps import WorkingTable  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels.embedding_lookup import (  # noqa: E402
    embedding_lookup_cuda,
    embedding_lookup_plain,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HOPPER_HEAD_DIMS,
    NEG_INF,
    attention_mask,
    flash_attention_cuda,
    flash_attention_plain,
    flash_variant,
)
from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_plain  # noqa: E402
from repro_torch.kernels.moe_gmm import gmm_cuda  # noqa: E402
from repro_torch.kernels.scatter_add import scatter_add_cuda_, scatter_add_plain_  # noqa: E402
from repro_torch.kernels.topk_mips import (  # noqa: E402
    THRESHOLD_NT,
    capacity_corpus,
    group_ids,
    split_count,
    topk_mips_cuda,
    topk_mips_plain,
    topk_plan,
)

BF16_RTOL = 2.0**-7


def _dyadic(rng, shape, scale=64.0):
    return (rng.integers(-128, 128, size=shape) / scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- topk_mips


def _topk_all_agree(q, c, k, n_valid=None):
    """Port plain == port oracle == JAX oracle == Pallas kernel (interpret),
    bitwise, on the same numpy inputs."""
    pv, pi = topk_mips_plain(_t(q), _t(c), k, n_valid=n_valid)
    ov, oi = tref.topk_mips_ref(_t(q), _t(c), k, n_valid=n_valid)
    jv, ji = jref.topk_mips_ref(jnp.asarray(q), jnp.asarray(c), k, n_valid=n_valid)
    kv, ki = topk_mips_pallas(
        jnp.asarray(q), jnp.asarray(c), k, n_valid=n_valid,
        block_q=8, block_n=32, interpret=True,
    )
    assert pi.dtype == torch.int32 and pv.dtype == torch.float32
    for v, i in ((ov, oi), (torch.from_numpy(np.asarray(jv)), torch.from_numpy(np.asarray(ji))),
                 (torch.from_numpy(np.asarray(kv)), torch.from_numpy(np.asarray(ki)))):
        np.testing.assert_array_equal(pv.numpy(), v.numpy())
        np.testing.assert_array_equal(pi.numpy(), i.numpy())
    return pv.numpy(), pi.numpy()


@pytest.mark.parametrize("qn,n,d,k", [(5, 200, 8, 10), (1, 64, 16, 1), (17, 130, 4, 7),
                                      (8, 64, 8, 64)])
def test_topk_plain_matches_reference_sweep(qn, n, d, k):
    rng = np.random.default_rng(qn * 1000 + n)
    _topk_all_agree(_dyadic(rng, (qn, d)), _dyadic(rng, (n, d)), k)


def test_topk_plain_ties_break_by_smaller_index():
    rng = np.random.default_rng(1)
    c = np.tile(_dyadic(rng, (40, 8)), (4, 1))  # every row 4x: ties everywhere
    v, i = _topk_all_agree(_dyadic(rng, (6, 8)), c, 8)
    tie = v[:, :-1] == v[:, 1:]
    assert tie.any() and (i[:, :-1][tie] < i[:, 1:][tie]).all()


def test_topk_plain_k_exceeds_corpus_pads_with_sentinels():
    rng = np.random.default_rng(2)
    v, i = _topk_all_agree(_dyadic(rng, (3, 8)), _dyadic(rng, (10, 8)), 16)
    assert np.isneginf(v[:, 10:]).all() and (i[:, 10:] == -1).all()
    assert (i[:, :10] >= 0).all()


@pytest.mark.parametrize("n_valid", [50, 0, 96])
def test_topk_plain_n_valid_masks_corpus_tail(n_valid):
    rng = np.random.default_rng(3)
    v, i = _topk_all_agree(_dyadic(rng, (4, 8)), _dyadic(rng, (96, 8)), 12, n_valid=n_valid)
    assert (i < max(n_valid, 1)).all()
    assert (i[:, min(n_valid, 12):] == -1).all()


@pytest.mark.parametrize("qn", [1, 7, 9])
def test_topk_plain_ragged_query_batches(qn):
    rng = np.random.default_rng(4 + qn)
    _topk_all_agree(_dyadic(rng, (qn, 8)), _dyadic(rng, (64, 8)), 5)


def test_topk_plain_random_normal_within_rtol():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(7, 12)).astype(np.float32)
    c = rng.normal(size=(500, 12)).astype(np.float32)
    pv, pi = topk_mips_plain(_t(q), _t(c), 20)
    jv, ji = jref.topk_mips_ref(jnp.asarray(q), jnp.asarray(c), 20)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [0, -3])
def test_topk_rejects_k_below_one(k):
    q, c = torch.zeros(2, 8), torch.zeros(8, 8)
    with pytest.raises(ValueError):
        topk_mips_plain(q, c, k)
    with pytest.raises(ValueError):
        ops.topk_mips(q, c, k)


def test_topk_split_count_fills_card_within_merge_limit():
    # the main path: 256 queries (32 tiles) over 600k rows on 132 SMs
    assert split_count(32, 600_000, 16, 132) == 32
    assert split_count(32, 600_000, 128, 132) == 32
    assert split_count(32, 600_000, 512, 132) == 16  # capped by splits * K <= 8192
    assert split_count(1, 1500, 16, 132) == 1  # splits keep >= 1024 rows
    for tiles, n, K in ((1, 10**6, 1), (64, 10**5, 256), (3, 4096, 32)):
        S = split_count(tiles, n, K, 132)
        assert S & (S - 1) == 0 and S * K <= 8192


def test_topk_plan_takes_threshold_on_the_main_path():
    # the serving path: 256 queries over 600k rows of width 8 on 132 SMs
    for k, C in ((10, 9 * 74 + 1), (100, 99 * 74 + 1)):
        p = topk_plan(256, 600_000, k, 132)
        assert (p.variant, p.S, p.rows_per_split) == ("threshold", 32, 18750)
        assert (p.G, p.max_group_rows, p.C) == (32 * 256, 74, C)
        assert p.sel_keys >= p.C and p.cap >= (k - 1) * 8 + 1
        assert max(p.smem.values()) <= 232_448
    # k = 512 at 32 splits needs 511 * 74 + 1 candidates (65,536 keys do not fit
    # a block); at 128 splits 511 * 19 + 1, and the compaction 16,384 + 1,024 keys
    p = topk_plan(256, 600_000, 512, 132)
    assert (p.variant, p.S, p.G, p.max_group_rows, p.C) == ("threshold", 128, 32768, 19, 9710)
    assert (p.cap, p.sel_keys) == (16384, 16384) and max(p.smem.values()) <= 232_448
    # past ~1M rows no split count fits k = 512: the rule takes stream
    p = topk_plan(256, 2_000_000, 512, 132)
    assert (p.variant, p.S, p.K) == ("stream", split_count(32, 2_000_000, 512, 132), 512)
    with pytest.raises(ValueError, match="does not fit"):
        topk_plan(256, 2_000_000, 512, 132, variant="threshold")
    assert topk_plan(256, 600_000, 100, 132, variant="stream").variant == "stream"
    with pytest.raises(ValueError, match="unknown"):
        topk_plan(4, 100, 3, 132, variant="tiles")


@pytest.mark.parametrize("Q,n,k", [(256, 600_000, 7), (13, 4001, 7), (40, 70_001, 7), (3, 5, 7),
                                   (256, 600_000, 512)])
def test_topk_group_layout_is_a_partition_within_its_bound(Q, n, k):
    p = topk_plan(Q, n, k, 132)
    nt = THRESHOLD_NT
    gid = group_ids(p)
    sizes = torch.bincount(gid, minlength=p.G)
    assert gid.shape == (n,) and int(gid.max()) < p.G and sizes.shape == (p.G,)
    assert int(sizes.max()) == p.max_group_rows and p.S * p.rows_per_split >= n
    r = torch.arange(n)  # a group's rows are its thread's, strided by nt within one split
    assert torch.equal(gid % nt, (r % p.rows_per_split) % nt)


_EMPTY = np.uint64(2**64 - 1)


def _desc_bits(scores):
    """csrc/topk_mips.cu's desc_bits: uint32 whose ascending order is
    descending score, -0 tied with +0, NaN just after -inf."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = s.view(np.uint32)
    asc = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(scores), np.uint32(0xFF800001), ~asc).astype(np.uint32)


def _kth(keys, k):
    """The k-th smallest of each row, EMPTY where fewer than k are keys."""
    s = np.sort(keys, axis=1)
    return np.where(s.shape[1] >= k, s[:, min(k, s.shape[1]) - 1], _EMPTY)


def _emulate_threshold(q, c, k, n_valid=None, plan=None):
    """The threshold variant's steps on the plan's group layout, in numpy:
    -> (scores, indices, candidates per query). Checks each bound of the
    source's header on the way."""
    Q, n = q.shape[0], c.shape[0] if n_valid is None else min(n_valid, c.shape[0])
    plan = plan or topk_plan(Q, n, k, 132, D=q.shape[1])
    assert plan.variant == "threshold"
    scores = (_t(q) @ _t(c[:n]).T).numpy()
    keys = (_desc_bits(scores).astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    gid = group_ids(plan).numpy()
    # mips_group_min: per group, the smallest key
    gmin = np.full((Q, plan.G), _EMPTY)
    for j in range(Q):
        np.minimum.at(gmin[j], gid, keys[j])
    # mips_threshold: the k-th smallest group minimum, through two levels
    m = -(-plan.G // 1024)
    padded = np.full((Q, m * 1024), _EMPTY)
    padded[:, : plan.G] = gmin
    t2 = _kth(padded.reshape(Q, m, 1024).min(axis=1), k)
    comp = (gmin <= t2[:, None]) & (gmin != _EMPTY)
    assert (comp.sum(axis=1) <= (k - 1) * m + 1).all() and (comp.sum(axis=1) <= plan.cap).all()
    thr = _kth(np.where(comp, gmin, _EMPTY), k)
    assert np.array_equal(thr, _kth(gmin, k))
    # mips_filter: only the winning groups' rows are scored again
    win = (gmin <= thr[:, None]) & (gmin != _EMPTY)
    assert (win.sum(axis=1) <= k).all()
    passed = np.take_along_axis(win, np.broadcast_to(gid, (Q, n)), axis=1) & (keys <= thr[:, None])
    assert np.array_equal(passed, keys <= thr[:, None])  # no row outside them passes
    counts = passed.sum(axis=1)
    assert (counts <= plan.C).all()
    # mips_select: sort the kept keys, write k
    vals = np.full((Q, k), -np.inf, np.float32)
    idx = np.full((Q, k), -1, np.int32)
    for j in range(Q):
        top = np.sort(keys[j][passed[j]])[:k]
        rows = (top & np.uint64(0xFFFFFFFF)).astype(np.int64)
        vals[j, : len(top)] = scores[j, rows]
        idx[j, : len(top)] = np.where(np.isneginf(scores[j, rows]), -1, rows)
    return vals, idx, counts


def _topk_corpus(kind, rng, Q, n, D=8):
    """Adversarial corpora for the threshold variant (dyadic queries and rows)."""
    q = _dyadic(rng, (Q, D))
    if kind == "random":
        return q, _dyadic(rng, (n, D))
    if kind == "all_equal":  # every score ties: ranks by index alone
        return q, np.tile(_dyadic(rng, (1, D)), (n, 1))
    q[:, 0] = np.abs(q[:, 0]) + 0.5
    q[:, 1:] = 0.0
    c = _dyadic(rng, (n, D))
    if kind == "sorted_desc":  # the best rows crowd the first split
        c[:, 0] = -np.sort(-c[:, 0])
    elif kind == "neg_inf":  # -inf rows, and NaN ones where a query's weight on them is 0
        c[rng.random(n) < 0.3, 0] = -np.inf
        q[::3, 0] = 0.0
    return q, c


@pytest.mark.parametrize("kind,Q,n,k,n_valid", [
    ("random", 9, 20_000, 10, None), ("random", 5, 3000, 64, None),
    ("all_equal", 7, 12_000, 33, None), ("sorted_desc", 6, 20_000, 100, None),
    ("neg_inf", 6, 9000, 40, None), ("neg_inf", 4, 600, 500, None),
    ("random", 4, 20_000, 17, 13_001),
    ("random", 3, 700, 64, 50), ("random", 2, 100, 5, 0),
])
def test_topk_threshold_emulation_matches_plain_and_reference(kind, Q, n, k, n_valid):
    rng = np.random.default_rng(n + k)
    q, c = _topk_corpus(kind, rng, Q, n)
    v, i, counts = _emulate_threshold(q, c, k, n_valid)
    pv, pi = topk_mips_plain(_t(q), _t(c), k, n_valid=n_valid)
    jv, ji = jref.topk_mips_ref(jnp.asarray(q), jnp.asarray(c), k, n_valid=n_valid)
    for rv, ri in ((pv.numpy(), pi.numpy()), (np.asarray(jv), np.asarray(ji))):
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(i, ri)
    live = min(n, n if n_valid is None else n_valid)
    assert (counts >= min(k, live)).all()  # every top-k row passed the filter


@pytest.mark.parametrize("Q,n,k", [(5, 20_000, 10), (3, 9001, 33), (2, 3000, 1),
                                   (2, 600_000, 512)])
def test_topk_threshold_emulation_reaches_capacity(Q, n, k):
    """The constructed corpus makes every query's count exactly C, and the
    result is still the plain version's."""
    plan = topk_plan(Q, n, k, 132)
    q, c = capacity_corpus(plan)
    v, i, counts = _emulate_threshold(q.numpy(), c.numpy(), k, plan=plan)
    assert (counts == plan.C).all()
    pv, pi = topk_mips_plain(q, c, k)
    np.testing.assert_array_equal(v, pv.numpy())
    np.testing.assert_array_equal(i, pi.numpy())


# --------------------------------------------------------- embedding_bag


def _bag_inputs(seed, B, nnz, n_slots, n_rows=40, d=8, slot_lo=0, slot_hi=None):
    rng = np.random.default_rng(seed)
    table = _dyadic(rng, (n_rows, d), scale=16.0)
    ids = rng.integers(0, n_rows, size=(B, nnz)).astype(np.int32)
    slot_of = rng.integers(slot_lo, n_slots if slot_hi is None else slot_hi,
                           size=(B, nnz)).astype(np.int32)
    valid = rng.random((B, nnz)) < 0.75
    return table, ids, slot_of, valid


def _bag_pallas(table, ids, slot_of, valid, n_slots):
    return np.asarray(embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(slot_of), jnp.asarray(valid),
        n_slots=n_slots, block_d=128, interpret=True,
    ).astype(jnp.float32))


def _bag_jref(table, ids, slot_of, valid, n_slots):
    return np.asarray(jref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(slot_of), jnp.asarray(valid),
        n_slots,
    ).astype(jnp.float32))


@pytest.mark.parametrize("B,nnz,n_slots", [(3, 10, 4), (2, 16, 5), (1, 5, 7)])
def test_bag_plain_matches_reference_bitwise(B, nnz, n_slots):
    table, ids, slot_of, valid = _bag_inputs(B * 100 + nnz, B, nnz, n_slots)
    got = embedding_bag_plain(_t(table), _t(ids), _t(slot_of), _t(valid), n_slots)
    assert got.shape == (B, n_slots, 8) and got.dtype == torch.float32
    oracle = tref.embedding_bag_ref(_t(table), _t(ids), _t(slot_of), _t(valid), n_slots)
    np.testing.assert_array_equal(got.numpy(), oracle.numpy())
    np.testing.assert_array_equal(got.numpy(), _bag_jref(table, ids, slot_of, valid, n_slots))
    np.testing.assert_array_equal(got.numpy(), _bag_pallas(table, ids, slot_of, valid, n_slots))


def test_bag_plain_drops_out_of_range_slots_like_the_tpu_kernel():
    table, ids, slot_of, valid = _bag_inputs(7, 3, 12, 4, slot_lo=-2, slot_hi=7)
    assert ((slot_of < 0) | (slot_of >= 4))[valid].any()
    got = embedding_bag_plain(_t(table), _t(ids), _t(slot_of), _t(valid), 4).numpy()
    np.testing.assert_array_equal(got, _bag_pallas(table, ids, slot_of, valid, 4))
    np.testing.assert_array_equal(got, _bag_jref(table, ids, slot_of, valid, 4))
    oracle = tref.embedding_bag_ref(_t(table), _t(ids), _t(slot_of), _t(valid), 4)
    np.testing.assert_array_equal(got, oracle.numpy())


def test_bag_float_mask_is_a_mask_not_weights():
    table, ids, slot_of, valid = _bag_inputs(8, 4, 8, 4)
    fmask = np.where(valid, np.float32(0.5), np.float32(0.0))
    got = ops.embedding_bag(_t(table), _t(ids), _t(slot_of), _t(fmask), 4).numpy()
    np.testing.assert_array_equal(got, _bag_pallas(table, ids, slot_of, fmask, 4))
    np.testing.assert_array_equal(got, _bag_jref(table, ids, slot_of, valid, 4))


def test_bag_bf16_accumulates_in_f32_and_casts_once():
    rng = np.random.default_rng(9)
    B, nnz, n_slots = 2, 24, 3
    _, ids, slot_of, valid = _bag_inputs(9, B, nnz, n_slots)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got = embedding_bag_plain(tb, _t(ids), _t(slot_of), _t(valid), n_slots)
    assert got.dtype == torch.bfloat16
    want = _bag_pallas(np.asarray(jnp.asarray(table, jnp.bfloat16)), ids, slot_of, valid, n_slots)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_RTOL)
    # on a dyadic table both sum exactly in f32 and round once: equal bits
    dy = _dyadic(rng, (40, 8), scale=16.0)
    got = embedding_bag_plain(torch.from_numpy(dy).to(torch.bfloat16), _t(ids), _t(slot_of),
                              _t(valid), n_slots)
    want = _bag_pallas(np.asarray(jnp.asarray(dy, jnp.bfloat16)), ids, slot_of, valid, n_slots)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_bag_random_normal_within_rtol():
    rng = np.random.default_rng(10)
    _, ids, slot_of, valid = _bag_inputs(10, 4, 30, 6)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    got = embedding_bag_plain(_t(table), _t(ids), _t(slot_of), _t(valid), 6).numpy()
    np.testing.assert_allclose(got, _bag_jref(table, ids, slot_of, valid, 6), rtol=1e-6,
                               atol=1e-6)


def _bag_in_slot_order(table, ids, slot_of, valid, n_slots):
    """The CUDA kernel's order, emulated: per example a stable sort of the
    kept nonzeros by slot, each slot's rows added in that order (ascending
    n) into fp32 from 0, cast once."""
    B = ids.shape[0]
    out = torch.zeros(B, n_slots, table.shape[1])
    for b in range(B):
        s = slot_of[b].long()
        idx = ((valid[b] != 0) & (s >= 0) & (s < n_slots)).nonzero().squeeze(1)
        lst = idx[torch.sort(s[idx], stable=True).indices]  # grouped by slot, ascending n
        sl = s[lst]
        start = torch.searchsorted(sl, sl)  # each entry's slot list begins here
        rank = torch.arange(len(lst)) - start
        for r in range(int(rank.max()) + 1 if len(lst) else 0):
            at = rank == r  # at most one entry of each slot
            out[b, sl[at]] += table[ids[b, lst[at]].long()].float()
    return out.to(table.dtype)


@pytest.mark.parametrize("B,nnz,n_slots,d,dtype,slot_lo,slot_hi", [
    (3, 40, 5, 8, torch.float32, 0, None),
    (2, 300, 1, 1, torch.float32, 0, None),  # one slot holds every nonzero, width 1
    (4, 2500, 40, 4, torch.bfloat16, -3, 43),  # past one chunk; slots out of range
    (2, 64, 7, 12, torch.float32, 0, None),
])
def test_bag_stable_slot_order_matches_plain_bitwise(B, nnz, n_slots, d, dtype, slot_lo, slot_hi):
    """The order the CUDA kernel keeps, a stable per-example sort by slot,
    sums dyadic data to the plain version's bits."""
    table, ids, slot_of, valid = _bag_inputs(B + nnz, B, nnz, n_slots, n_rows=500, d=d,
                                             slot_lo=slot_lo, slot_hi=slot_hi)
    args = (_t(table).to(dtype), _t(ids), _t(slot_of), _t(valid), n_slots)
    got = _bag_in_slot_order(*args)
    assert got.dtype == dtype and got.shape == (B, n_slots, d)
    assert torch.equal(got, embedding_bag_plain(*args))


# ----------------------------------------------------- dispatch, no fallback


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(12)
    q, c = _t(_dyadic(rng, (3, 8))), _t(_dyadic(rng, (50, 8)))
    v, i = ops.topk_mips(q, c, 5, n_valid=40)
    pv, pi = topk_mips_plain(q, c, 5, n_valid=40)
    assert torch.equal(v, pv) and torch.equal(i, pi)
    table, ids, slot_of, valid = _bag_inputs(12, 2, 6, 3)
    out = ops.embedding_bag(_t(table), _t(ids).long(), _t(slot_of), _t(valid), 3)
    assert torch.equal(out, embedding_bag_plain(_t(table), _t(ids), _t(slot_of), _t(valid), 3))
    t = _t(table).requires_grad_()
    ops.embedding_bag(t, _t(ids), _t(slot_of), _t(valid), 3).sum().backward()
    assert t.grad is not None and t.grad.shape == t.shape
    ops.scatter_add(_t(table), _t(ids[0]), _t(table[:6]))
    ops.adagrad_update(_t(table), _t(np.abs(table)), _t(table), 0.1)
    ops.feature_extract(_t(ids).long(), _t(valid), n_keys=1000, n_slots=8)
    ops.embedding_lookup(_t(table), _t(ids[0]))
    qkv = _t(rng.normal(size=(1, 2, 4, 8)).astype(np.float32))
    ops.attention(qkv, qkv, qkv, impl="flash")
    x, w = _t(table[:5]), _t(rng.normal(size=(2, 8, 3)).astype(np.float32))
    got = ops.gmm(x, w, torch.tensor([2, 3]))
    assert torch.equal(got, torch.cat([x[:2] @ w[0], x[2:] @ w[1]]))
    assert ops.launch_counts() == {"topk_mips": 0, "embedding_bag": 0, "scatter_add": 0,
                                   "fused_adagrad": 0, "feature_extract": 0,
                                   "embedding_lookup": 0, "flash_attention": 0, "moe_gmm": 0}


def test_reset_launch_counts_zeroes_every_count():
    """The counts a run reads after ``reset_launch_counts``: each wrapper's
    total, the variant counts and flash_attention's counts by mask mode."""
    for fn in ops.KERNEL_WRAPPERS.values():
        fn.launches = 3
    topk_mips_cuda.launches_by_variant["threshold"] = 2
    flash_attention_cuda.launches_by_mode[(2176, 2176, True, 1024)] = 29
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    for fn in ops.KERNEL_WRAPPERS.values():
        assert set(getattr(fn, "launches_by_variant", {}).values()) <= {0}
    assert flash_attention_cuda.launches_by_mode == {}


def test_kernel_wrappers_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        topk_mips_cuda(torch.zeros(2, 8), torch.zeros(9, 8), 3)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_bag_cuda(torch.zeros(9, 8), torch.zeros(2, 3, dtype=torch.int32),
                           torch.zeros(2, 3, dtype=torch.int32),
                           torch.ones(2, 3, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="CUDA"):
        scatter_add_cuda_(torch.zeros(9, 8), torch.zeros(3, dtype=torch.int32), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        adagrad_cuda(torch.zeros(9, 8), torch.zeros(9, 8), torch.zeros(9, 8), 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        embedding_lookup_cuda(torch.zeros(9, 8), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        x = torch.zeros(1, 2, 4, 8)
        flash_attention_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        gmm_cuda(torch.zeros(4, 8), torch.zeros(2, 8, 3), torch.tensor([2, 2]))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc means no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        build.library("topk_mips")


# ----------------------------------------------------------- scatter_add


def _scatter_inputs(seed, N=40, B=48, D=8, hot=None):
    """Random normal table and grads; ids drawn from a few rows so runs of
    equal ids are long, plus one ``hot`` run if asked."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(N, D)).astype(np.float32)
    grads = rng.normal(size=(B, D)).astype(np.float32)
    ids = rng.integers(0, N // 4, size=B).astype(np.int32)
    if hot is not None:
        ids[: B // 2] = hot
    return table, ids, grads


@pytest.mark.parametrize("N,B,D,hot", [(40, 48, 8, None), (12, 64, 4, 3), (64, 33, 12, None),
                                       (40, 1, 8, None)])
def test_scatter_plain_matches_reference_and_pallas_bitwise(N, B, D, hot):
    """Sorted ids, random normal data, a nonzero starting table: the port's
    plain version, the port's oracle, the JAX oracle and the Pallas kernel
    (interpret) agree bit for bit — every run adds in position order."""
    from repro.kernels.scatter_add import scatter_add_pallas

    table, ids, grads = _scatter_inputs(N * B + D, N, B, D, hot)
    order = np.argsort(ids, kind="stable")
    ids, grads = ids[order], grads[order]
    assert (ids[1:] == ids[:-1]).any() or B == 1
    got = scatter_add_plain_(_t(table).clone(), _t(ids), _t(grads)).numpy()
    np.testing.assert_array_equal(got, tref.scatter_add_ref(_t(table), _t(ids), _t(grads)).numpy())
    want = np.asarray(jref.scatter_add_ref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads)))
    np.testing.assert_array_equal(got, want)
    pallas = scatter_add_pallas(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads),
                                interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    untouched = np.setdiff1d(np.arange(N), ids)
    np.testing.assert_array_equal(got[untouched], table[untouched])


@pytest.mark.parametrize("assume_sorted", [False, True])
def test_scatter_dispatcher_sorts_unsorted_ids_stably(assume_sorted):
    """``ops.scatter_add`` on unsorted ids sorts them stably, so each row
    still sums in position order: equal to the JAX oracle on the same
    unsorted ids (which scatters in position order), and functional."""
    table, ids, grads = _scatter_inputs(5, B=60)
    if assume_sorted:
        order = np.argsort(ids, kind="stable")
        ids, grads = ids[order], grads[order]
    t = _t(table)
    got = ops.scatter_add(t, _t(ids), _t(grads), assume_sorted=assume_sorted)
    assert got is not t and np.array_equal(t.numpy(), table)  # the input is untouched
    want = np.asarray(jref.scatter_add_ref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_drops_ids_outside_the_table():
    """Ids >= N are dropped, as the reference drops them. A negative id is
    dropped too, where ``jnp`` would wrap it to row N + id (a deliberate
    difference: the kernel needs equal rows adjacent in the sorted ids)."""
    table, ids, grads = _scatter_inputs(6, N=20, B=30)
    ids[[7, 29]] = [20, 1000]
    got = tref.scatter_add_ref(_t(table), _t(ids), _t(grads)).numpy()
    want = np.asarray(jref.scatter_add_ref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(grads)))
    np.testing.assert_array_equal(got, want)
    neg = ids.copy()
    neg[0] = -1
    got = tref.scatter_add_ref(_t(table), _t(neg), _t(grads)).numpy()
    want = tref.scatter_add_ref(_t(table), _t(neg[1:]), _t(grads[1:])).numpy()
    np.testing.assert_array_equal(got, want)


def test_scatter_empty_batch_leaves_the_table():
    table = _t(_scatter_inputs(7)[0])
    got = ops.scatter_add(table, torch.zeros(0, dtype=torch.int32), torch.zeros(0, 8))
    assert torch.equal(got, table)


# ------------------------------------------------------------- adagrad


def _adagrad_inputs(seed, shape):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=shape).astype(np.float32)
    a = np.abs(rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return p, a, g


@pytest.mark.parametrize("shape", [(256, 8), (37, 4), (5, 12), (0, 8), (3, 3)])
def test_adagrad_plain_matches_reference_bitwise(shape):
    """Random normal data: the plain version equals the JAX oracle bit for
    bit. It takes its fp32 square root through float64 (correctly rounded,
    where PyTorch's vectorised fp32 sqrt on the CPU is not always); without
    that, a few hundred of 32k elements differ by an ulp."""
    p, a, g = _adagrad_inputs(shape[0] + shape[1], shape)
    pn, an = adagrad_plain(_t(p), _t(a), _t(g), 0.05)
    assert pn.shape == shape and pn.dtype == an.dtype == torch.float32
    jp, ja = jref.adagrad_ref(jnp.asarray(p), jnp.asarray(a), jnp.asarray(g), 0.05)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(an.numpy(), np.asarray(ja))
    op, oa = ops.adagrad_update(_t(p), _t(a), _t(g), 0.05)
    assert torch.equal(op, pn) and torch.equal(oa, an)


def test_adagrad_plain_is_correctly_rounded_on_many_elements():
    p, a, g = _adagrad_inputs(11, (4096, 8))
    pn, an = adagrad_plain(_t(p), _t(a), _t(g), 0.05, eps=1e-8)
    jp, ja = jref.adagrad_ref(jnp.asarray(p), jnp.asarray(a), jnp.asarray(g), 0.05, 1e-8)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(an.numpy(), np.asarray(ja))


@pytest.mark.parametrize("shape", [(16, 8), (37, 4)])
def test_adagrad_plain_tracks_the_pallas_kernel(shape):
    """The Pallas kernel in interpret mode contracts ``a + g*g`` into an
    FMA, so it differs from the oracle (and the port) in the last bit of
    some elements: within rtol 1e-6, atol 1e-7."""
    from repro.kernels import ops as jops

    p, a, g = _adagrad_inputs(12, shape)
    pn, an = adagrad_plain(_t(p), _t(a), _t(g), 0.05)
    kp, ka = jops.adagrad_update(jnp.asarray(p), jnp.asarray(a), jnp.asarray(g), 0.05,
                                 use_pallas=True, interpret=True)
    np.testing.assert_allclose(pn.numpy(), np.asarray(kp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(an.numpy(), np.asarray(ka), rtol=1e-6, atol=1e-7)


def test_adagrad_zero_grads_leave_params_bitwise():
    p, a, _ = _adagrad_inputs(13, (9, 8))
    pn, an = adagrad_plain(_t(p), _t(a), torch.zeros(9, 8), 0.05)
    assert torch.equal(pn, _t(p)) and torch.equal(an, _t(a))


# ------------------------------------------------------ the bag's backward


def _jax_bag_grad(table, ids, slot_of, valid, n_slots, cot, **kw):
    import jax

    from repro.kernels import ops as jops

    f = lambda t: jops.embedding_bag(t, jnp.asarray(ids), jnp.asarray(slot_of),
                                     jnp.asarray(valid), n_slots, **kw)
    _, vjp = jax.vjp(f, jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _port_bag_grad(table, ids, slot_of, valid, n_slots, cot):
    t = _t(table).requires_grad_()
    out = ops.embedding_bag(t, _t(ids), _t(slot_of), _t(valid), n_slots)
    (g,) = torch.autograd.grad(out, t, _t(cot))
    return g.numpy()


@pytest.mark.parametrize("jax_kw", [{"use_pallas": False},
                                    {"use_pallas": True, "interpret": True}],
                         ids=["segment", "pallas_interpret"])
@pytest.mark.parametrize("B,nnz,n_slots", [(3, 10, 4), (4, 16, 5)])
def test_bag_backward_matches_jax_vjp_bitwise_on_dyadic_data(jax_kw, B, nnz, n_slots):
    table, ids, slot_of, valid = _bag_inputs(B * 7 + nnz, B, nnz, n_slots, n_rows=12)
    cot = _dyadic(np.random.default_rng(B), (B, n_slots, 8), scale=16.0)
    got = _port_bag_grad(table, ids, slot_of, valid, n_slots, cot)
    np.testing.assert_array_equal(got, _jax_bag_grad(table, ids, slot_of, valid, n_slots, cot,
                                                     **jax_kw))


def test_bag_backward_random_normal_within_tolerance():
    rng = np.random.default_rng(21)
    _, ids, slot_of, valid = _bag_inputs(21, 6, 40, 5, n_rows=10)
    table = rng.normal(size=(10, 8)).astype(np.float32)
    cot = rng.normal(size=(6, 5, 8)).astype(np.float32)
    got = _port_bag_grad(table, ids, slot_of, valid, 5, cot)
    want = _jax_bag_grad(table, ids, slot_of, valid, 5, cot, use_pallas=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bag_backward_drops_the_gradient_of_dropped_nonzeros():
    """A nonzero whose slot lies outside [0, n_slots) is dropped by the
    forward and gets no gradient (the reference clamps the slot there: a
    deliberate difference); the kept nonzeros match the reference."""
    table, ids, slot_of, valid = _bag_inputs(22, 3, 12, 4, n_rows=9)
    cot = _dyadic(np.random.default_rng(22), (3, 4, 8), scale=16.0)
    out_of_range = slot_of.copy()
    out_of_range[:, ::3] = 9
    got = _port_bag_grad(table, ids, out_of_range, valid, 4, cot)
    kept = valid & (out_of_range < 4)
    want = _jax_bag_grad(table, ids, slot_of, kept, 4, cot, use_pallas=False)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ embedding_lookup


@pytest.mark.parametrize("N,D,B", [(16, 128, 8), (64, 256, 32), (128, 512, 7), (32, 2048, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_lookup_plain_matches_pallas_bitwise(N, D, B, dtype):
    rng = np.random.default_rng(N + D + B)
    table = rng.normal(size=(N, D)).astype(np.float32)
    ids = rng.integers(0, N, size=B).astype(np.int32)
    jt = jnp.asarray(table, getattr(jnp, dtype))  # f32 -> bf16 rounds the same on both sides
    tt = _t(table).to(getattr(torch, dtype))
    want = np.asarray(embedding_lookup_pallas(jt, jnp.asarray(ids), interpret=True), np.float32)
    np.testing.assert_array_equal(embedding_lookup_plain(tt, _t(ids)).float().numpy(), want)
    np.testing.assert_array_equal(ops.embedding_lookup(tt, _t(ids)).float().numpy(), want)
    np.testing.assert_array_equal(np.asarray(jref.embedding_lookup_ref(jt, jnp.asarray(ids)),
                                             np.float32), want)


def test_working_table_matches_reference():
    rng = np.random.default_rng(21)
    table = rng.normal(size=(12, 8)).astype(np.float32)
    slots = np.array([1, 3, 3, 7, 0], dtype=np.int32)
    vals = rng.normal(size=(5, 8)).astype(np.float32)
    np.testing.assert_array_equal(WorkingTable.get(_t(table), _t(slots)).numpy(),
                                  np.asarray(JWorkingTable.get(jnp.asarray(table),
                                                               jnp.asarray(slots))))
    np.testing.assert_allclose(
        WorkingTable.accumulate(_t(table), _t(slots), _t(vals)).numpy(),
        np.asarray(JWorkingTable.accumulate(jnp.asarray(table), jnp.asarray(slots),
                                            jnp.asarray(vals))), rtol=1e-6, atol=1e-6)
    distinct = np.array([2, 5, 11], dtype=np.int32)
    got = WorkingTable.insert(_t(table), _t(distinct), _t(vals[:3]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JWorkingTable.insert(
        jnp.asarray(table), jnp.asarray(distinct), jnp.asarray(vals[:3]))))
    assert not np.array_equal(got.numpy(), table)  # functional: a new table


# ------------------------------------------------------------- attention

ATTN_CASES = [
    # B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset (the reference's CASES)
    (2, 4, 2, 128, 128, 32, True, 0, 0),
    (1, 4, 1, 256, 256, 16, True, 0, 0),
    (1, 2, 2, 128, 256, 32, False, 0, 0),
    (2, 4, 2, 128, 256, 64, True, 64, 128),
    (1, 1, 1, 1, 128, 32, True, 0, 127),
    (1, 8, 4, 128, 128, 128, True, 32, 0),
]


def _qkv(case, seed=0):
    B, H, Hkv, Sq, Skv, Dh = case[:6]
    rng = np.random.default_rng(seed + sum(case[:6]))
    return (rng.normal(size=(B, H, Sq, Dh)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, Dh)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, Dh)).astype(np.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_plain_matches_pallas(case):
    causal, window, qoff = case[6:]
    q, k, v = _qkv(case)
    want = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window, q_offset=qoff,
                                             interpret=True))
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal, window=window,
                                q_offset=qoff)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    flash = ops.attention(_t(q), _t(k), _t(v), causal=causal, window=window, q_offset=qoff,
                          impl="flash")
    assert torch.equal(flash, got)


def test_flash_attention_plain_zeroes_rows_that_keep_no_key():
    """A window that leaves a row no key (q_offset past the keys): the row
    is 0, as the reference kernel's ``l == 0`` guard makes it."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(1, 2, 4, 8)).astype(np.float32)
    k = rng.normal(size=(1, 1, 16, 8)).astype(np.float32)
    got = flash_attention_plain(_t(q), _t(k), _t(k), causal=True, window=4, q_offset=30)
    assert torch.equal(got, torch.zeros_like(got))
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), causal=True,
                                  window=4, q_offset=30, block_q=4, block_k=16, interpret=True)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _packed_kv(Dh=64):
    kv = _bf16(2, 300, 2, 2, Dh)  # [B, S, (k, v), Hkv, Dh]: strides over s of 4 * Dh
    return kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)


FLASH_VARIANT_CASES = {
    # name: a maker of (q, k, v), the kernel the rule picks
    **{f"bf16_Dh{d}": (lambda d=d: (_bf16(1, 4, 64, d), _bf16(1, 2, 64, d),
                                    _bf16(1, 2, 64, d)), "hopper") for d in HOPPER_HEAD_DIMS},
    "model_views": (lambda: (_bf16(2, 300, 8, 64).transpose(1, 2), *_packed_kv()), "hopper"),
    "size_1_dims_any_stride": (lambda: (_bf16(64 * 128).as_strided((1, 1, 64, 128),
                                                                   (7, 3, 128, 1)),
                                        _bf16(1, 1, 64, 128), _bf16(1, 1, 64, 128)), "hopper"),
    "fp32": (lambda: (torch.zeros(1, 4, 64, 128), torch.zeros(1, 2, 64, 128),
                      torch.zeros(1, 2, 64, 128)), "simt"),
    "Dh80": (lambda: (_bf16(1, 4, 64, 80), _bf16(1, 2, 64, 80), _bf16(1, 2, 64, 80)), "simt"),
    "Dh16": (lambda: (_bf16(1, 4, 64, 16), _bf16(1, 2, 64, 16), _bf16(1, 2, 64, 16)), "simt"),
    "row_stride_not_8": (lambda: (_bf16(1, 4, 64, 129)[..., :128], _bf16(1, 2, 64, 128),
                                  _bf16(1, 2, 64, 128)), "simt"),
    "unaligned_data": (lambda: (_bf16(1, 4, 64, 136)[..., 4:132], _bf16(1, 2, 64, 128),
                                _bf16(1, 2, 64, 128)), "simt"),
    "no_keys": (lambda: (_bf16(1, 4, 64, 128), _bf16(1, 2, 0, 128), _bf16(1, 2, 0, 128)),
                "simt"),
    "kv_expanded_over_heads": (lambda: (_bf16(1, 4, 64, 128),
                                        *[_bf16(1, 1, 64, 128).expand(1, 4, 64, 128)] * 2),
                               "simt"),
}


@pytest.mark.parametrize("name", list(FLASH_VARIANT_CASES))
def test_flash_variant_rule(name):
    """The dispatch rule between the two CUDA kernels: the wgmma + TMA kernel
    for bf16 at the head dims it is built for, where a TMA descriptor can
    describe q, k and v (16-byte aligned data, (b, h, s) strides in
    multiples of 8 elements, a dim of length 1 exempt, at least one key);
    the SIMT kernel for everything else."""
    build_qkv, want = FLASH_VARIANT_CASES[name]
    assert flash_variant(*build_qkv()) == want


def _hopper_rounding(q, k, v, *, causal, split):
    """The Hopper kernel's arithmetic as one KV block: bf16 operands, fp32
    scores and softmax in the log2 domain, p rounded to bf16 (``split``:
    plus the bf16 rounding of its remainder) before an fp32-exact product
    with v, and l summed from the unrounded p."""
    B, H, Sq, Dh = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()).float()
    s = s * (1.0 / Dh**0.5 * 1.4426950408889634)
    mask = attention_mask(Sq, k.shape[2], causal=causal, window=0, q_offset=0, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp2(s - s.amax(-1, keepdim=True)), 0.0)
    hi = p.bfloat16().float()
    pp = hi.double() + ((p - hi).bfloat16().double() if split else 0.0)
    acc = torch.einsum("bhqk,bhkd->bhqd", pp, v.double()).float()
    return (acc / p.sum(-1, keepdim=True)).bfloat16()


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_hopper_rounding_holds_the_card_tolerance(dh):
    """Why the Hopper kernel multiplies p into v as bf16 hi + lo: with hi
    alone (the TPU's default-precision dot) a few percent of the outputs
    fall outside the tolerance the card's tests hold the kernel to against
    the fp32 plain version (rtol 2^-6, atol 2e-5); with hi + lo none do."""
    g = torch.Generator().manual_seed(dh)
    q, k, v = (torch.randn(1, 4, 512, dh, generator=g).bfloat16() for _ in range(3))
    want = flash_attention_plain(q, k, v).float()
    bad = {split: float((~torch.isclose(_hopper_rounding(q, k, v, causal=True, split=split)
                                        .float(), want, rtol=2**-6, atol=2e-5)).float().mean())
           for split in (False, True)}
    assert bad[True] == 0.0 and bad[False] > 0.01, bad


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_paths_match_reference(impl, case):
    causal, window, qoff = case[6:]
    q, k, v = _qkv(case, seed=1)
    kw = dict(causal=causal, window=window, q_offset=qoff)
    if impl == "naive":
        want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        got = tref.attention_ref(_t(q), _t(k), _t(v), **kw)
    else:
        want = jops.attention_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                        block_k=64, **kw)
        got = ops.attention_blockwise(_t(q), _t(k), _t(v), block_k=64, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kv_len", [1, 37, 64])
def test_attention_kv_len_masks_the_cache_tail(kv_len):
    rng = np.random.default_rng(kv_len)
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 64, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 64, 16)).astype(np.float32)
    kw = dict(causal=False, q_offset=kv_len - 1, kv_len=kv_len)
    want = np.asarray(jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    for impl in ("naive", "blockwise"):
        got = ops.attention(_t(q), _t(k), _t(v), impl=impl, block_k=24, **kw)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    trunc = tref.attention_ref(_t(q), _t(k[:, :, :kv_len]), _t(v[:, :, :kv_len]), causal=False)
    np.testing.assert_allclose(trunc.numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("S,W", [(64, 16), (50, 16), (96, 32)])
def test_attention_banded_matches_reference(S, W):
    rng = np.random.default_rng(S + W)
    q = rng.normal(size=(2, 4, S, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, S, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, S, 16)).astype(np.float32)
    want = np.asarray(jops.attention_banded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            window=W))
    got = ops.attention_banded(_t(q), _t(k), _t(v), window=W)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    # the dispatcher takes the banded path for causal window self-attention
    via_ops = ops.attention(_t(q), _t(k), _t(v), causal=True, window=W, impl="naive")
    assert torch.equal(via_ops, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, window=W)),
        atol=2e-5, rtol=2e-5)


def test_attention_auto_dispatch_follows_the_reference():
    """On CPU tensors ``auto`` is the reference's off-TPU choice: blockwise
    above 2048^2 scores, naive below; ``flash`` needs static bounds."""
    q = torch.zeros(1, 1, 1, 8)
    k = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError, match="flash"):
        ops.attention(q, k, k, impl="flash", kv_len=3)
    with pytest.raises(ValueError, match="impl"):
        ops.attention(q, k, k, impl="ring")
    calls = []
    orig = ops.attention_blockwise
    try:
        ops.attention_blockwise = lambda *a, **kw: calls.append("blockwise") or orig(*a, **kw)
        ops.attention(torch.zeros(1, 1, 2049, 4), torch.zeros(1, 1, 2049, 4),
                      torch.zeros(1, 1, 2049, 4), block_k=1024)
        ops.attention(q, k, k, causal=False)
    finally:
        ops.attention_blockwise = orig
    assert calls == ["blockwise"]
