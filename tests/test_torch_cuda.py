"""The port's CUDA kernels against their plain versions, on the card.

Every case here needs a CUDA card (marker ``cuda``) and skips without one.
The file imports neither JAX nor the reference package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest -q --noconftest tests/test_torch_cuda.py

Dyadic-grid inputs must match bitwise; random normal inputs match within
the tolerance each case states.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.ctr_models import CTRConfig, table_specs  # noqa: E402
from repro_torch.convert import publish_arrays  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTRStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_plain  # noqa: E402
from repro_torch.kernels.scatter_add import scatter_add_cuda_, scatter_add_plain_  # noqa: E402
from repro_torch.kernels.topk_mips import (  # noqa: E402
    MAX_K,
    capacity_corpus,
    topk_mips_cuda,
    topk_mips_plain,
    topk_plan,
)
from repro_torch.retrieval import RetrievalEngine  # noqa: E402
from repro_torch.serve import ServingCluster, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels are built with nvcc at first use")
    return torch.device("cuda")


def _dyadic(rng, shape, scale=64.0):
    return (rng.integers(-128, 128, size=shape) / scale).astype(np.float32)


@pytest.mark.parametrize("qn,n,d,k,n_valid", [
    (256, 50_000, 8, 10, None), (13, 4000, 16, 100, 3001), (5, 50, 8, 64, None),
    (3, 7000, 4, 1, None), (20, 30_000, 8, MAX_K, None), (4, 100, 8, 5, 0),
])
def test_topk_kernel_matches_plain_bitwise(cuda, qn, n, d, k, n_valid):
    rng = np.random.default_rng(qn + n)
    q = torch.from_numpy(_dyadic(rng, (qn, d))).to(cuda)
    half = _dyadic(rng, (max(1, n // 2), d))
    c = torch.from_numpy(np.tile(half, (2, 1))[:n].copy()).to(cuda)  # ties everywhere
    before = topk_mips_cuda.launches
    by_variant = dict(topk_mips_cuda.launches_by_variant)
    kv, ki = ops.topk_mips(q, c, k, n_valid=n_valid)
    assert topk_mips_cuda.launches == before + 1
    assert topk_mips_cuda.launches_by_variant == {**by_variant,
                                                  "threshold": by_variant["threshold"] + 1}
    pv, pi = topk_mips_plain(q, c, k, n_valid=n_valid)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


def _n_sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _equal_nan(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])


def _threshold_matches_plain(q, c, k, n_valid=None):
    """The threshold variant, forced: equal to the plain version (NaN to
    NaN), one launch of that variant; returns the candidate counts."""
    counts = torch.full((q.shape[0],), -1, dtype=torch.int32, device=q.device)
    before = topk_mips_cuda.launches_by_variant["threshold"]
    kv, ki = topk_mips_cuda(q, c, k, n_valid=n_valid, variant="threshold", counts=counts)
    assert topk_mips_cuda.launches_by_variant["threshold"] == before + 1
    pv, pi = topk_mips_plain(q, c, k, n_valid=n_valid)
    assert _equal_nan(kv, pv) and torch.equal(ki, pi)
    return counts


@pytest.mark.parametrize("kind", ["all_equal", "sorted_desc", "neg_inf_nan", "n_valid_tail"])
def test_topk_threshold_on_adversarial_corpora(cuda, kind):
    rng = np.random.default_rng(7)
    q = _dyadic(rng, (40, 8))
    q[:, 0] = np.abs(q[:, 0]) + 0.5
    q[:, 1:] = 0.0
    c = _dyadic(rng, (200_000, 8))
    k, n_valid = 100, None
    if kind == "all_equal":  # every score ties: ranks by index alone
        c[:] = c[0]
    elif kind == "sorted_desc":  # the best rows crowd the first split
        c[:, 0] = -np.sort(-c[:, 0])
    elif kind == "neg_inf_nan":  # -inf rows; NaN ones where the query's weight is 0
        c = c[:600]
        c[rng.random(600) < 0.3, 0] = -np.inf
        q[::3, 0] = 0.0
        k = 500
    else:
        q, n_valid = _dyadic(rng, (40, 8)), 123_457
    counts = _threshold_matches_plain(torch.from_numpy(q).to(cuda), torch.from_numpy(c).to(cuda),
                                      k, n_valid)
    assert bool((counts >= k).all()) or kind == "neg_inf_nan"


@pytest.mark.parametrize("Q,n,k", [(64, 600_000, 100), (256, 600_000, 10), (13, 40_000, 33),
                                   (64, 600_000, MAX_K)])
def test_topk_threshold_count_reaches_capacity(cuda, Q, n, k):
    """The corpus built from the host's group layout makes every query's
    candidate count exactly C, the proven bound; the result stays exact."""
    plan = topk_plan(Q, n, k, _n_sms(cuda))
    q, c = capacity_corpus(plan)
    counts = _threshold_matches_plain(q.to(cuda), c.to(cuda), k)
    assert bool((counts == plan.C).all()), (counts.unique().tolist(), plan.C)


@pytest.mark.parametrize("k", [10, 100])
def test_topk_threshold_main_shape_is_exact_and_the_same_on_every_launch(cuda, k):
    rng = np.random.default_rng(k)
    rows = torch.from_numpy(_dyadic(rng, (600_000, 8), scale=16.0)).to(cuda)
    users = torch.from_numpy(rng.integers(0, 600_000, (256, 500))).to(cuda)
    q = rows[users].sum(dim=1)  # serving's user vectors: sums of 500 rows
    assert topk_plan(256, 600_000, k, _n_sms(cuda)).variant == "threshold"
    _threshold_matches_plain(q, rows, k)
    g = torch.Generator().manual_seed(k)
    qn = torch.randn(256, 8, generator=g).to(cuda)
    cn = torch.randn(600_000, 8, generator=g).to(cuda)
    first = topk_mips_cuda(qn, cn, k)
    for again in (topk_mips_cuda(qn, cn, k), topk_mips_cuda(qn, cn, k, variant="stream")):
        # the atomics append in another order each launch; the sort makes it the same bits,
        # and both variants score with the same fmaf sequence
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


def test_topk_stream_variant_forced_matches_plain(cuda):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_dyadic(rng, (37, 8))).to(cuda)
    c = torch.from_numpy(_dyadic(rng, (100_000, 8))).to(cuda)
    before = dict(topk_mips_cuda.launches_by_variant)
    kv, ki = topk_mips_cuda(q, c, 100, n_valid=99_001, variant="stream")
    assert topk_mips_cuda.launches_by_variant == {**before, "stream": before["stream"] + 1}
    pv, pi = topk_mips_plain(q, c, 100, n_valid=99_001)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)
    # k = 512 over 2M rows fits the threshold variant at no split count: the rule takes stream
    assert topk_plan(256, 2_000_000, MAX_K, _n_sms(cuda)).variant == "stream"


def test_topk_kernel_random_normal_within_tolerance(cuda):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(64, 8, generator=g).to(cuda)
    c = torch.randn(200_000, 8, generator=g).to(cuda)
    kv, ki = topk_mips_cuda(q, c, 50)
    pv, pi = topk_mips_plain(q, c, 50)
    # one fp32 dot of 8 terms, summed in another order: a few ulps
    torch.testing.assert_close(kv, pv, rtol=1e-5, atol=1e-5)
    assert float((ki == pi).float().mean()) >= 0.99


def test_topk_kernel_rejects_what_it_does_not_take(cuda):
    q, c = torch.zeros(2, 8, device=cuda), torch.zeros(10, 8, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        topk_mips_cuda(q, c, MAX_K + 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        topk_mips_cuda(q[:, :6].contiguous(), c[:, :6].contiguous(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        topk_mips_cuda(q, c.T.contiguous().T, 3)
    with pytest.raises(ValueError, match="float32"):
        topk_mips_cuda(q.double(), c.double(), 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bag_kernel_matches_plain_bitwise_and_is_deterministic(cuda, dtype):
    rng = np.random.default_rng(13)
    B, nnz, n_slots = 33, 2500, 40  # nnz spans three of the kernel's chunks
    table = torch.from_numpy(_dyadic(rng, (3000, 8), scale=16.0)).to(cuda, getattr(torch, dtype))
    ids = torch.from_numpy(rng.integers(0, 3000, (B, nnz)).astype(np.int32)).to(cuda)
    slot_of = torch.from_numpy(rng.integers(-3, n_slots + 3, (B, nnz)).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random((B, nnz)) < 0.7).to(cuda)
    before = embedding_bag_cuda.launches
    got = ops.embedding_bag(table, ids, slot_of, valid, n_slots)
    again = ops.embedding_bag(table, ids, slot_of, valid.float() * 2.0, n_slots)
    assert embedding_bag_cuda.launches == before + 2
    assert got.dtype == table.dtype and got.shape == (B, n_slots, 8)
    assert torch.equal(got, again)  # no float atomics; a float mask is a mask
    assert torch.equal(got, embedding_bag_plain(table, ids, slot_of, valid, n_slots))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,nnz,n_slots,d,n_distinct", [
    (4, 3000, 1, 8, 1),  # one slot holds every nonzero: the longest list
    (5, 700, 700, 12, 700),  # more slots than one CTA's threads: several CTAs
    (3, 900, 9, 1200, 9),  # rows wider than one CTA's threads
    (6, 4500, 30, 3, 30),  # three chunks; width 3 loads one element at a time
])
def test_bag_kernel_long_lists_and_wide_grids(cuda, dtype, B, nnz, n_slots, d, n_distinct):
    """The sort-based kernel on shapes that stretch its plan, dyadic: equal
    to the plain version bitwise and the same bits on two launches."""
    rng = np.random.default_rng(B * nnz + d)
    table = torch.from_numpy(_dyadic(rng, (500, d), scale=16.0)).to(cuda, dtype)
    ids = torch.from_numpy(rng.integers(0, 500, (B, nnz)).astype(np.int32)).to(cuda)
    slot_of = torch.from_numpy(rng.integers(0, n_distinct, (B, nnz)).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random((B, nnz)) < 0.9).to(cuda)
    got = embedding_bag_cuda(table, ids, slot_of, valid, n_slots)
    assert torch.equal(got, embedding_bag_cuda(table, ids, slot_of, valid, n_slots))
    assert torch.equal(got, embedding_bag_plain(table, ids, slot_of, valid, n_slots))


def test_bag_kernel_random_normal_within_tolerance(cuda):
    g = torch.Generator().manual_seed(1)
    table = torch.randn(5000, 12, generator=g).to(cuda)
    ids = torch.randint(0, 5000, (64, 300), generator=g, dtype=torch.int32).to(cuda)
    slot_of = torch.randint(0, 20, (64, 300), generator=g, dtype=torch.int32).to(cuda)
    valid = (torch.rand(64, 300, generator=g) < 0.9).to(cuda)
    got = embedding_bag_cuda(table, ids, slot_of, valid, 20)
    # the plain version's index_add_ sums in another order on the card
    torch.testing.assert_close(got, embedding_bag_plain(table, ids, slot_of, valid, 20),
                               rtol=1e-5, atol=1e-5)


def test_serving_slice_on_the_card_equals_the_cpu_run(cuda, tmp_path):
    cfg = CTRConfig("ctr-small", 20_000, 50, 8, 12, (8,), 64, 1)
    spec = table_specs(cfg)[0]
    rng = np.random.default_rng(2)
    rows = (rng.integers(-8, 8, size=(cfg.n_sparse_keys, 16)) / 16.0).astype(np.float32)
    publish_arrays(str(tmp_path), n_nodes=2, dim=16, init_cols=8,
                   tables={spec.name: (spec, np.arange(cfg.n_sparse_keys, dtype=np.uint64),
                                       rows)})
    batch = SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots,
                               cfg.batch_size, seed=4).next_batch()
    out = {}
    for device in ("cuda", "cpu"):
        ops.reset_launch_counts()
        eng = ServingEngine(ServingCluster(str(tmp_path)), device_hot_rows=512, device=device)
        retr = RetrievalEngine(eng, spec.name, device=device)
        q = np.einsum("bn,bnd->bd", batch.valid.astype(np.float32),
                      eng.lookup(spec.name, batch.keys))
        res = retr.search(q, 100)
        rr = retr.rerank(retr.search(q, 10), batch.keys, batch.slot_of, batch.valid,
                         n_slots=cfg.n_slots)
        slots, tbl = eng.lookup_device(spec.name, batch.keys[:8])
        assert tbl.device.type == device
        out[device] = (res.scores, res.indices, rr.scores, rr.indices,
                       tbl.cpu().numpy()[slots], ops.launch_counts())
    launches = out["cuda"][-1]
    assert launches["topk_mips"] == 2 and launches["embedding_bag"] == 1
    assert set(out["cpu"][-1].values()) == {0}
    for a, b in zip(out["cuda"][:-1], out["cpu"][:-1]):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------- scatter_add


def _sorted_scatter(rng, N, B, D, hot_run=0, scale=16.0, dyadic=True):
    ids = np.sort(rng.integers(0, N, size=B)).astype(np.int32)
    if hot_run:
        ids[:hot_run] = ids[0]
        ids = np.sort(ids)
    grads = (_dyadic(rng, (B, D), scale) if dyadic
             else rng.normal(size=(B, D)).astype(np.float32))
    return ids, grads


@pytest.mark.parametrize("N,B,D,hot", [
    (269_400, 256_000, 8, 13_386),  # a ctr-C-scaled mini-batch's bag backward
    (5000, 20_000, 4, 0), (5000, 20_000, 12, 3000), (100, 1, 8, 0), (50, 4096, 8, 4096),
])
def test_scatter_kernel_matches_plain_bitwise_on_dyadic_data(cuda, N, B, D, hot):
    rng = np.random.default_rng(N + B + D)
    ids, grads = _sorted_scatter(rng, N, B, D, hot)
    table = torch.from_numpy(_dyadic(rng, (N, D), 4.0)).to(cuda)  # a nonzero start
    t_ids, t_g = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    before = scatter_add_cuda_.launches
    got = ops.scatter_add(table, t_ids, t_g, assume_sorted=True)
    assert scatter_add_cuda_.launches == before + 1
    assert torch.equal(got, scatter_add_plain_(table.clone(), t_ids, t_g))
    untouched = torch.ones(N, dtype=torch.bool, device=cuda)
    untouched[t_ids.long()] = False
    assert torch.equal(got[untouched], table[untouched])


def test_scatter_kernel_random_normal_is_deterministic(cuda):
    rng = np.random.default_rng(1)
    ids, grads = _sorted_scatter(rng, 20_000, 100_000, 8, hot_run=5000, dyadic=False)
    t_ids, t_g = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    zeros = torch.zeros(20_000, 8, device=cuda)
    a = ops.scatter_add(zeros, t_ids, t_g, assume_sorted=True)
    b = ops.scatter_add(zeros, t_ids, t_g, assume_sorted=True)
    assert torch.equal(a, b)  # no float atomics: the same bits every launch
    # on the CPU the plain version adds in position order, as the kernel does
    cpu = scatter_add_plain_(torch.zeros(20_000, 8), torch.from_numpy(ids), torch.from_numpy(grads))
    assert torch.equal(a.cpu(), cpu)
    # the plain version on the card (index_add_, atomics) reorders: 1e-5
    torch.testing.assert_close(a, scatter_add_plain_(zeros.clone(), t_ids, t_g),
                               rtol=1e-5, atol=1e-5)


def test_scatter_kernel_edge_cases_and_unsorted_ids(cuda):
    rng = np.random.default_rng(2)
    table = torch.from_numpy(_dyadic(rng, (300, 8))).to(cuda)
    empty = ops.scatter_add(table, torch.zeros(0, dtype=torch.int32, device=cuda),
                            torch.zeros(0, 8, device=cuda))
    assert torch.equal(empty, table)
    distinct = torch.randperm(300, device=cuda)[:200].sort().values.int()
    g = torch.from_numpy(_dyadic(rng, (200, 8))).to(cuda)
    assert torch.equal(ops.scatter_add(table, distinct, g, assume_sorted=True),
                       scatter_add_plain_(table.clone(), distinct, g))
    ids = torch.from_numpy(rng.integers(0, 300, 5000).astype(np.int32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(5000, 8)).astype(np.float32)).to(cuda)
    got = ops.scatter_add(table, ids, g)  # sorted stably by the dispatcher
    want = scatter_add_plain_(table.cpu(), ids.cpu(), g.cpu())  # position order
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError, match="float32"):
        scatter_add_cuda_(table.double(), ids.sort().values, g.double())


def _runs(*runs):
    """Sorted int32 ids from (id, length) runs."""
    return np.concatenate([np.full(n, i, np.int32) for i, n in runs])


@pytest.mark.parametrize("name,ids,N,D", [
    # one run across many staged segments and chunks, short runs around it
    ("run_over_many_segments", _runs((0, 5), (3, 15_000), (7, 4000), (9, 1)), 20, 8),
    # the last run ends at the last position, across a segment's end
    ("run_ends_at_the_last_position", _runs((1, 3000), (2, 1), (4, 9000)), 10, 12),
    # a single id repeated B times
    ("one_id_B_times", _runs((5, 50_000)), 6, 8),
    # columns past one block's slice; a run over segments of other lengths
    ("wide_rows_D_40", _runs((0, 2), (1, 3000), (2, 1000)), 3, 40),
    # ids outside [0, N) dropped, one of them a run over segments
    ("out_of_range_runs", _runs((-3, 2500), (0, 10), (8, 3000), (99, 4100)), 9, 4),
    # odd D: the 4-byte staging path
    ("odd_D_3", _runs((0, 7), (2, 6000), (3, 3)), 4, 3),
])
def test_scatter_kernel_long_runs_match_the_cpu_bitwise(cuda, name, ids, N, D):
    """Runs that span many staged segments, end at the last position or fill
    the whole batch: the kernel's sums equal the CPU plain version's
    position-order sums bitwise, on random normal data, the same bits every
    launch."""
    rng = np.random.default_rng(len(ids) + D)
    grads = rng.normal(size=(len(ids), D)).astype(np.float32)
    table = rng.normal(size=(N, D)).astype(np.float32)
    t_ids, t_g = torch.from_numpy(ids).to(cuda), torch.from_numpy(grads).to(cuda)
    start = torch.from_numpy(table).to(cuda)
    got = ops.scatter_add(start, t_ids, t_g, assume_sorted=True)
    assert torch.equal(got, ops.scatter_add(start, t_ids, t_g, assume_sorted=True))
    want = scatter_add_plain_(torch.from_numpy(table), torch.from_numpy(ids),
                              torch.from_numpy(grads))
    assert torch.equal(got.cpu(), want)


# ------------------------------------------------------------- adagrad


def _assert_adagrad_bitwise(what, got, want, p, a, g, lr=0.05, eps=1e-8):
    """Bitwise, and on a mismatch the evidence: the first differing element,
    its inputs, both results and numpy's (every fp32 op rounded once, the
    root through float64) as values and fp32 bits."""
    gp, ga = (t.cpu().reshape(-1) for t in got)
    wp, wa = (t.cpu().reshape(-1) for t in want)
    bad = ((gp.view(torch.int32) != wp.view(torch.int32))
           | (ga.view(torch.int32) != wa.view(torch.int32))).nonzero()
    if len(bad):
        i = int(bad[0])
        p_, a_, g_ = (np.float32(t.cpu().reshape(-1)[i]) for t in (p, a, g))
        a2 = np.float32(a_ + np.float32(g_ * g_))
        den = np.float32(np.float32(np.sqrt(np.float64(a2))) + np.float32(eps))
        p2 = np.float32(p_ - np.float32(np.float32(np.float32(lr) * g_) / den))
        bits = lambda x: f"{float(x)!r} (0x{np.float32(x).view(np.uint32):08x})"
        raise AssertionError(
            f"{what}: {len(bad)} of {gp.numel()} elements differ; first at flat index {i}: "
            f"p={bits(p_)} a={bits(a_)} g={bits(g_)} -> params {bits(gp[i])} vs "
            f"{bits(wp[i])} (numpy {bits(p2)}), accum {bits(ga[i])} vs {bits(wa[i])} "
            f"(numpy {bits(a2)}); torch {torch.__version__}, "
            f"cpu capability {torch.backends.cpu.get_cpu_capability()}")


@pytest.mark.parametrize("shape", [(269_400, 8), (1001, 3), (7, 12), (0, 8), (1, 1)])
def test_adagrad_kernel_matches_plain_bitwise(cuda, shape):
    g = torch.Generator().manual_seed(shape[0])
    p = torch.randn(shape, generator=g).to(cuda)
    a = torch.randn(shape, generator=g).abs().to(cuda)
    gr = torch.randn(shape, generator=g).to(cuda)
    before = adagrad_cuda.launches
    kp, ka = ops.adagrad_update(p, a, gr, 0.05)
    assert adagrad_cuda.launches == before + (1 if p.numel() else 0)
    _assert_adagrad_bitwise("kernel vs plain on the card", (kp, ka),
                            adagrad_plain(p, a, gr, 0.05), p, a, gr)
    cpu = adagrad_plain(p.cpu(), a.cpu(), gr.cpu(), 0.05)  # the CPU gives the same bits
    _assert_adagrad_bitwise("kernel vs plain on the CPU", (kp, ka), cpu, p, a, gr)


def test_adagrad_kernel_unaligned_views_and_zero_grads(cuda):
    g = torch.Generator().manual_seed(3)
    base = torch.randn(3, 1001, generator=g).to(cuda)
    p, a = base[0, 1:], base[1, 1:].abs()  # offset by one float: no 16-byte loads
    kp, ka = adagrad_cuda(p, a, base[2, 1:], 0.1)
    pp, pa = adagrad_plain(p, a, base[2, 1:], 0.1)
    assert torch.equal(kp, pp) and torch.equal(ka, pa)
    zp, za = adagrad_cuda(p, a, torch.zeros_like(p), 0.1)
    assert torch.equal(zp, p) and torch.equal(za, a)


# ------------------------------------------------------ the bag's backward


def test_bag_backward_kernel_matches_plain_autograd_bitwise(cuda):
    rng = np.random.default_rng(4)
    B, nnz, n_slots, N = 64, 500, 125, 20_000
    table = torch.from_numpy(_dyadic(rng, (N, 8), 16.0)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, N, (B, nnz)).astype(np.int32)).to(cuda)
    slot_of = torch.from_numpy(rng.integers(0, n_slots, (B, nnz)).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random((B, nnz)) < 0.9).to(cuda)
    cot = torch.from_numpy(_dyadic(rng, (B, n_slots, 8), 16.0)).to(cuda)
    t = table.clone().requires_grad_()
    before = (embedding_bag_cuda.launches, scatter_add_cuda_.launches)
    (ops.embedding_bag(t, ids, slot_of, valid, n_slots) * cot).sum().backward()
    assert (embedding_bag_cuda.launches, scatter_add_cuda_.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    p = table.clone().requires_grad_()
    (embedding_bag_plain(p, ids, slot_of, valid, n_slots) * cot).sum().backward()
    assert torch.equal(t.grad, p.grad)


# ------------------------------------------------------------ the trainer


def test_training_slice_on_the_card_is_lossless_and_tracks_the_cpu(cuda, tmp_path):
    from repro_torch.configs.ctr_models import TINY
    from repro_torch.core.node import Cluster
    from repro_torch.train.trainer import CTRTrainer, TrainerConfig

    keys = np.arange(TINY.n_sparse_keys, dtype=np.uint64)
    out = {}
    for tag, device, pipelined in (("pipe", "cuda", True), ("serial", "cuda", False),
                                   ("cpu", "cpu", True)):
        ops.reset_launch_counts()
        cl = Cluster(2, str(tmp_path / tag), dim=2 * TINY.emb_dim, cache_capacity=2048,
                     file_capacity=128, init_cols=TINY.emb_dim)
        tr = CTRTrainer(TINY, cl, TrainerConfig(), seed=0, device=device)
        stream = SyntheticCTRStream(TINY.n_sparse_keys, TINY.nnz_per_example, TINY.n_slots,
                                    TINY.batch_size, seed=5)
        losses = [r["loss"] for r in tr.run(stream, 6, pipelined=pipelined)]
        cl.flush_all()
        out[tag] = losses, cl.pull(keys, pin=False), ops.launch_counts()
    k = TINY.minibatches_per_batch
    for name in ("embedding_bag", "scatter_add", "fused_adagrad"):
        assert out["pipe"][2][name] == out["serial"][2][name] == 6 * k
    assert set(out["cpu"][2].values()) == {0}
    np.testing.assert_array_equal(out["pipe"][0], out["serial"][0])
    np.testing.assert_array_equal(out["pipe"][1], out["serial"][1])
    # the card's matmuls and index_add_-free reductions sum in other orders
    np.testing.assert_allclose(out["pipe"][0], out["cpu"][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out["pipe"][1], out["cpu"][1], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- feature_extract


def _raw_u64(rng, shape):
    raw = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    edge = np.array([0, 1, 2**63, 2**64 - 1, 0xFFFFFFFF, 2**32], dtype=np.uint64)
    raw.reshape(-1)[: min(raw.size, len(edge))] = edge[: raw.size]
    return raw


@pytest.mark.parametrize("shape,n_keys,n_slots", [
    ((2048, 500), 600_000, 125),  # the ctr-C-scaled ingest batch
    ((2048, 500), 6 * 10**10, 125), ((512, 500), 2 * 10**11, 125),  # paper models C and E
    ((64, 100), 2**20, 128),  # powers of two
    ((64, 100), 2**32 - 5, 2**31 - 1), ((13, 37), 2**63 - 25, 7), ((5, 3), 2**63, 3),
    ((0, 500), 600_000, 125),
])
def test_feature_extract_kernel_matches_plain_and_host_bitwise(cuda, shape, n_keys, n_slots):
    from repro_torch.data.synthetic_ctr import extract_host
    from repro_torch.kernels.feature_extract import feature_extract_cuda, feature_extract_plain

    rng = np.random.default_rng(shape[0] + n_slots)
    raw = _raw_u64(rng, shape)
    lengths = rng.integers(0, shape[1] + 1, shape[0]).astype(np.int32)
    lengths[:2] = 0  # all-invalid rows
    want_k, want_s, want_v = extract_host(raw, lengths, n_keys, n_slots)
    t_raw = torch.from_numpy(raw.view(np.int64)).to(cuda)
    t_valid = torch.from_numpy(want_v).to(cuda)
    before = feature_extract_cuda.launches
    k, s = ops.feature_extract(t_raw, t_valid, n_keys=n_keys, n_slots=n_slots)
    assert feature_extract_cuda.launches == before + (1 if raw.size else 0)
    pk, ps = feature_extract_plain(t_raw, t_valid, n_keys=n_keys, n_slots=n_slots,
                                   key_seed=17, slot_seed=31)
    assert torch.equal(k, pk) and torch.equal(s, ps)
    np.testing.assert_array_equal(k.cpu().numpy().view(np.uint64), want_k)
    np.testing.assert_array_equal(s.cpu().numpy(), want_s)
    if n_keys > 2**32 and raw.size:
        assert (want_k >> np.uint64(32)).any()


def test_feature_extract_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.feature_extract import feature_extract_cuda

    raw = torch.zeros(4, 6, dtype=torch.int64, device=cuda)
    valid = torch.ones(4, 6, dtype=torch.bool, device=cuda)
    kw = dict(n_keys=1000, n_slots=8, key_seed=17, slot_seed=31)
    for bad, match in ((dict(n_slots=2**31), "n_slots"), (dict(n_keys=0), "n_keys"),
                       (dict(n_keys=2**63 + 1), "n_keys"), (dict(key_seed=2**64), "key_seed")):
        with pytest.raises(ValueError, match=match):
            feature_extract_cuda(raw, valid, **{**kw, **bad})
    with pytest.raises(ValueError, match="bool"):
        feature_extract_cuda(raw, valid.int(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        feature_extract_cuda(raw.T, valid.T, **kw)
    with pytest.raises(ValueError, match="valid"):
        feature_extract_cuda(raw, valid.cpu(), **kw)
    with pytest.raises(ValueError, match="int64"):
        feature_extract_cuda(raw.int(), valid, **kw)


def test_ingest_training_on_the_card_equals_the_host_feeder(cuda, tmp_path):
    from repro_torch.configs.ctr_models import TINY
    from repro_torch.core.node import Cluster
    from repro_torch.data.synthetic_ctr import to_ctr_batch
    from repro_torch.train.trainer import CTRTrainer, TrainerConfig

    keys = np.arange(TINY.n_sparse_keys, dtype=np.uint64)
    raw = lambda: SyntheticCTRStream(TINY.n_sparse_keys, TINY.nnz_per_example, TINY.n_slots,
                                     TINY.batch_size, seed=3).raw_records()
    out = {}
    for tag, ingest, pipelined in (("ingest", True, True), ("serial", True, False),
                                   ("host", False, True)):
        ops.reset_launch_counts()
        cl = Cluster(2, str(tmp_path / tag), dim=2 * TINY.emb_dim, cache_capacity=2048,
                     file_capacity=128, init_cols=TINY.emb_dim)
        tr = CTRTrainer(TINY, cl, TrainerConfig(ingest=ingest), seed=0, device="cuda")
        src = raw() if ingest else (to_ctr_batch(r, TINY.n_sparse_keys, TINY.n_slots,
                                                 TINY.nnz_per_example) for r in raw())
        losses = [r["loss"] for r in tr.run(src, 6, pipelined=pipelined)]
        cl.flush_all()
        out[tag] = losses, cl.pull(keys, pin=False), ops.launch_counts()
        if ingest:
            assert tr.ingestor.ring.live_slots == 0
            assert tr.ingestor.counters["ingest_batches"] == 6
    assert out["ingest"][2]["feature_extract"] == out["serial"][2]["feature_extract"] == 6
    assert out["host"][2]["feature_extract"] == 0
    for tag in ("ingest", "serial"):
        assert out[tag][0] == out["host"][0]
        np.testing.assert_array_equal(out[tag][1], out["host"][1])


# ------------------------------------------------------ the bag at D = 1


def test_bag_kernel_at_width_one_and_the_lr_baseline(cuda):
    from repro_torch.models import ctr as ctr_model

    rng = np.random.default_rng(5)
    B, nnz, N = 64, 300, 4000
    table = torch.from_numpy(_dyadic(rng, (N, 1), 16.0)).to(cuda)
    ids = torch.from_numpy(rng.integers(0, N, (B, nnz)).astype(np.int32)).to(cuda)
    slot_of = torch.from_numpy(rng.integers(0, 3, (B, nnz)).astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.random((B, nnz)) < 0.8).to(cuda)
    before = embedding_bag_cuda.launches
    got = ops.embedding_bag(table, ids, slot_of, valid, 3)
    assert embedding_bag_cuda.launches == before + 1 and got.shape == (B, 3, 1)
    assert torch.equal(got, embedding_bag_plain(table, ids, slot_of, valid, 3))
    labels = torch.from_numpy((rng.random(B) < 0.4).astype(np.float32)).to(cuda)
    bias = torch.tensor(0.25, device=cuda)
    t = table.clone().requires_grad_()
    ctr_model.lr_loss_fn(t, ids, valid, labels, bias).backward()
    before = (embedding_bag_cuda.launches, scatter_add_cuda_.launches)
    t2 = table.clone().requires_grad_()
    ctr_model.lr_loss_fn(t2, ids, valid, labels, bias).backward()
    assert (embedding_bag_cuda.launches, scatter_add_cuda_.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    assert torch.equal(t.grad, t2.grad)  # no float atomics
    p = table.cpu().clone().requires_grad_()
    ctr_model.lr_loss_fn(p, ids.cpu(), valid.cpu(), labels.cpu(), bias.cpu()).backward()
    torch.testing.assert_close(t.grad.cpu(), p.grad, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ embedding_lookup


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,b", [(5000, 4096, 8192), (300, 4096, 4), (1000, 7, 333),
                                   (64, 1, 9), (10, 8, 0)])
def test_embedding_lookup_kernel_matches_plain_bitwise(cuda, dtype, n, d, b):
    from repro_torch.kernels.embedding_lookup import embedding_lookup_cuda, embedding_lookup_plain

    g = torch.Generator().manual_seed(n + d)
    table = torch.randn(n, d, generator=g).to(cuda, dtype)
    ids = torch.randint(0, n, (b,), generator=g).to(cuda)  # int64: the dispatcher casts
    before = embedding_lookup_cuda.launches
    got = ops.embedding_lookup(table, ids)
    assert embedding_lookup_cuda.launches == before + (1 if b and d else 0)
    assert got.dtype == dtype and got.shape == (b, d)
    assert torch.equal(got, embedding_lookup_plain(table, ids))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_lookup_kernel_unaligned_views(cuda, dtype):
    """Rows of a view that starts one element in (no 16-byte copies) and of
    a view whose row stride is not its width."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(700, 4099, generator=g).to(cuda, dtype)
    ids = torch.randint(0, 699, (257,), generator=g, dtype=torch.int32).to(cuda)
    for table in (base[:, 1:], base[:, 3:4099 - 8], base[1:, :64]):
        got = ops.embedding_lookup(table, ids)
        assert got.is_contiguous() and torch.equal(got, table[ids.long()])
    with pytest.raises(ValueError, match="column stride"):
        ops.embedding_lookup(base.T, ids)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.embedding_lookup(base.double(), ids)


# ------------------------------------------------------- flash_attention

FLASH_CASES = [
    # B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset
    (1, 8, 1, 200, 200, 16, True, 0, 0),  # MQA, tails
    (2, 4, 4, 130, 300, 96, True, 0, 170),  # rep 1, Dh 96, q_offset > 0, Sq < Skv
    (1, 32, 4, 1, 777, 128, True, 0, 776),  # Sq = 1, rep 8
    (2, 8, 1, 257, 257, 64, True, 100, 0),  # window, tails
    (1, 4, 2, 64, 300, 256, False, 0, 0),  # Dh 256, not causal
    (1, 2, 1, 70, 90, 8, True, 32, 20),  # Dh 8, window + q_offset
    (1, 3, 1, 33, 65, 9, True, 0, 32),  # odd Dh
    (1, 2, 1, 128, 128, 128, True, 1, 0),  # window 1: the diagonal only
    (1, 2, 1, 4, 16, 8, True, 4, 30),  # every row keeps no key -> 0
]


def _flash_inputs(case, dtype, cuda):
    B, H, Hkv, Sq, Skv, Dh = case[:6]
    g = torch.Generator().manual_seed(sum(case[:6]))
    mk = lambda *shape: torch.randn(shape, generator=g).to(cuda, dtype)
    return mk(B, H, Sq, Dh), mk(B, Hkv, Skv, Dh), mk(B, Hkv, Skv, Dh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, case, dtype):
    """fp32 inputs within 2e-5, the reference's own tolerance. bf16 inputs:
    both read the same bf16 values and do fp32 math, summed in other
    orders, and each rounds its output to bf16 once, so they sit at most one
    bf16 ulp apart (2^-7 relative at most): rtol 2^-6, with atol 2e-5 for
    outputs near 0 whose fp32 sums differ by more than their own ulp."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    causal, window, q_offset = case[6:]
    q, k, v = _flash_inputs(case, dtype, cuda)
    before = flash_attention_cuda.launches
    got = ops.attention(q, k, v, causal=causal, window=window, q_offset=q_offset, impl="flash")
    assert flash_attention_cuda.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert got.dtype == dtype and got.shape == q.shape and got.is_contiguous()
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32 else dict(rtol=2**-6, atol=2e-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if case == FLASH_CASES[-1]:
        assert torch.equal(got, torch.zeros_like(got))


def test_flash_attention_kernel_takes_strided_views(cuda):
    """q as the model makes it: [B, S, H, Dh] transposed to [B, H, S, Dh]."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 300, 8, 32, generator=g).to(cuda, torch.bfloat16)
    kv = torch.randn(2, 300, 2, 32, generator=g).to(cuda, torch.bfloat16)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, k)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), k.contiguous())
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-6, atol=2e-5)
    torch.testing.assert_close(got, ops.flash_attention(q.contiguous(), k.contiguous(),
                                                        k.contiguous()), rtol=0, atol=0)


HOPPER_MASKS = {  # causal, window, Sq, Skv, q_offset: tails in every case
    "causal": (True, 0, 200, 237, 37),
    "windowed": (True, 70, 300, 341, 41),
    "non_causal": (False, 0, 150, 333, 5),
}


@pytest.mark.parametrize("rep", [1, 5, 8])
@pytest.mark.parametrize("mask", list(HOPPER_MASKS))
@pytest.mark.parametrize("dh", [64, 96, 128, 192, 256])
def test_flash_attention_hopper_kernel_matches_plain(cuda, dh, mask, rep):
    """The wgmma + TMA kernel (bf16, the head dims it is built for) against
    the plain version, within the bf16 tolerance of the test above: rtol
    2^-6, atol 2e-5."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_variant,
    )

    causal, window, Sq, Skv, q_offset = HOPPER_MASKS[mask]
    g = torch.Generator().manual_seed(dh + rep)
    mk = lambda *shape: torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    q, k, v = mk(2, 2 * rep, Sq, dh), mk(2, 2, Skv, dh), mk(2, 2, Skv, dh)
    assert flash_variant(q, k, v) == "hopper"
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = dict(flash_attention_cuda.launches_by_variant)
    got = ops.attention(q, k, v, impl="flash", **kw)
    assert flash_attention_cuda.launches_by_variant["hopper"] == before["hopper"] + 1
    assert flash_attention_cuda.launches_by_variant["simt"] == before["simt"]
    want = flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape and got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-6, atol=2e-5)


def test_flash_attention_hopper_kernel_rows_that_keep_nothing_and_strided_views(cuda):
    """Rows whose window lies past the keys write 0; q as the model makes it
    ([B, S, H, Dh] transposed) and k, v as views of one packed tensor take
    the Hopper kernel with their real strides."""
    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_variant

    g = torch.Generator().manual_seed(3)
    mk = lambda *shape: torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    q, k = mk(1, 4, 130, 128), mk(1, 2, 100, 128)
    got = ops.flash_attention(q, k, k, causal=True, window=8, q_offset=200)
    assert torch.equal(got, torch.zeros_like(got))
    x = mk(2, 300, 8, 64).transpose(1, 2)
    kv = mk(2, 300, 2, 2, 64)  # [B, S, (k, v), Hkv, Dh]
    kk, vv = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    assert not x.is_contiguous() and flash_variant(x, kk, vv) == "hopper"
    got = ops.flash_attention(x, kk, vv, causal=True)
    want = flash_attention_plain(x, kk, vv, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-6, atol=2e-5)


SLICE6_FLASH = {  # B, H, Hkv, Sq, Skv, Dh, causal, window: prefill shapes of slice 6
    "hymba_swa": (4, 25, 5, 2176, 2176, 64, True, 1024),  # 2,048 tokens + 128 meta
    "hymba_global": (4, 25, 5, 2176, 2176, 64, True, 0),
    "whisper_encoder": (4, 6, 6, 1500, 1500, 64, False, 0),
    "whisper_decoder_self": (4, 6, 6, 224, 224, 64, True, 0),
    "whisper_cross": (4, 6, 6, 224, 1500, 64, False, 0),  # Sq != Skv, q_offset 0
}


@pytest.mark.parametrize("name", list(SLICE6_FLASH))
def test_flash_attention_at_hybrid_and_audio_prefill_shapes(cuda, name):
    """hymba-1.5b's and whisper-tiny's prefill attention at their real
    shapes, none a multiple of the kernel's tiles: the wgmma + TMA kernel
    against the plain version, within the bf16 tolerance above."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_variant,
    )

    B, H, Hkv, Sq, Skv, Dh, causal, window = SLICE6_FLASH[name]
    g = torch.Generator().manual_seed(Sq + Skv + window)
    mk = lambda *shape: torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    q, k, v = mk(B, H, Sq, Dh), mk(B, Hkv, Skv, Dh), mk(B, Hkv, Skv, Dh)
    assert flash_variant(q, k, v) == "hopper"
    before = dict(flash_attention_cuda.launches_by_variant)
    by_mode, mode = dict(flash_attention_cuda.launches_by_mode), (Sq, Skv, causal, window)
    got = ops.attention(q, k, v, causal=causal, window=window)  # "auto" takes flash here
    assert flash_attention_cuda.launches_by_variant == {**before,
                                                        "hopper": before["hopper"] + 1}
    assert flash_attention_cuda.launches_by_mode == {**by_mode, mode: by_mode.get(mode, 0) + 1}
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-6, atol=2e-5)


OFFSET_FLASH = {  # H, Hkv, this rank's q heads [lo, hi), Sq, Dh, causal, window, group
    "hymba_rank1_of_2_global": (25, 5, (12, 25), 2176, 64, True, 0),  # off 2 of group 2
    "hymba_rank1_of_2_swa": (25, 5, (12, 25), 2176, 64, True, 1024),
    "nemotron_rank1_of_3": (24, 2, (8, 16), 300, 128, True, 0),  # 96 / 8 scaled: off 8 of 12
    "inside_one_group": (10, 2, (2, 5), 200, 96, False, 0),
}


@pytest.mark.parametrize("variant", ["hopper", "simt"])
@pytest.mark.parametrize("name", list(OFFSET_FLASH))
def test_flash_attention_with_a_head_offset_matches_plain(cuda, name, variant):
    """A tensor-parallel rank's heads that start inside a kv group: query
    head h reads kv head (h + head_offset) // group. Each kernel (hopper in
    bf16, simt in fp32) against the plain version with the same offset,
    which is the whole heads' plain attention sliced (bitwise: the plain
    version pads q to the groups); bf16 within rtol 2^-6, atol 2e-5, fp32
    within 2e-5."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda,
        flash_attention_plain,
        flash_variant,
    )
    from repro_torch.models.common import kv_heads_read

    H, Hkv, (lo, hi), S, Dh, causal, window = OFFSET_FLASH[name]
    dtype = torch.bfloat16 if variant == "hopper" else torch.float32
    g = torch.Generator().manual_seed(S + Dh + lo)
    mk = lambda *shape: torch.randn(shape, generator=g).to(cuda, dtype)
    q, k, v = mk(2, H, S, Dh), mk(2, Hkv, S, Dh), mk(2, Hkv, S, Dh)
    kv_lo, kv_hi, off = kv_heads_read(lo, hi, H // Hkv)
    ql, kl, vl = q[:, lo:hi], k[:, kv_lo:kv_hi], v[:, kv_lo:kv_hi]
    kw = dict(causal=causal, window=window, group=H // Hkv, head_offset=off)
    assert flash_variant(ql, kl, vl) == ("hopper" if variant == "hopper" else "simt")
    before = dict(flash_attention_cuda.launches_by_variant)
    got = flash_attention_cuda(ql, kl, vl, variant=variant, **kw)
    assert flash_attention_cuda.launches_by_variant[variant] == before[variant] + 1
    want = flash_attention_plain(ql, kl, vl, **kw)
    whole = flash_attention_plain(q, k, v, causal=causal, window=window)[:, lo:hi]
    tol = dict(rtol=2**-6, atol=2e-5) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(want.float(), whole.float(), **tol)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    torch.testing.assert_close(ops.attention(ql, kl, vl, impl="flash", **kw), got, rtol=0,
                               atol=0)


def test_kernel_wrappers_without_backward_raise_under_grad(cuda):
    """The raw wrappers of flash_attention, moe_gmm and embedding_lookup have
    no backward (``ops``' autograd Functions carry them): with an input that
    requires grad under grad mode they raise instead of returning an output
    without a grad_fn; under no_grad they launch."""
    from repro_torch.kernels.embedding_lookup import embedding_lookup_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_cuda

    q = torch.randn(1, 2, 128, 64, device=cuda, dtype=torch.bfloat16)
    x, w = torch.randn(8, 16, device=cuda), torch.randn(2, 16, 8, device=cuda)
    gs = torch.tensor([4, 4], device=cuda)
    table, ids = torch.randn(10, 16, device=cuda), torch.arange(5, dtype=torch.int32,
                                                                device=cuda)
    xb, wb = x.bfloat16(), w.bfloat16()  # the Hopper gmm kernel
    calls = [
        lambda r: flash_attention_cuda(q.clone().requires_grad_(r), q, q),
        lambda r: gmm_cuda(x, w.clone().requires_grad_(r), gs),
        lambda r: gmm_cuda(xb.clone().requires_grad_(r), wb, gs),
        lambda r: embedding_lookup_cuda(table.clone().requires_grad_(r), ids),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call(True)
        with torch.no_grad():
            call(True)
        call(False)


@pytest.mark.parametrize("n_ids,N,D", [(8192, 3000, 4096), (5000, 700, 8), (300, 50, 130)])
def test_embedding_lookup_backward_through_scatter_add_matches_plain_bitwise(cuda, n_ids, N, D):
    """``ops.embedding_lookup`` on the card: forward through the lookup
    kernel, backward through one scatter_add launch; zipf-like duplicate ids
    and dyadic values (every sum exact), so equal to autograd of the plain
    gather bitwise. A bf16 gradient raises (scatter_add takes fp32)."""
    from repro_torch.kernels.embedding_lookup import embedding_lookup_cuda

    rng = np.random.default_rng(n_ids + D)
    ids = torch.from_numpy((rng.zipf(1.3, n_ids) % N).astype(np.int32)).to(cuda)
    table = torch.from_numpy(_dyadic(rng, (N, D))).to(cuda)
    g = torch.from_numpy(_dyadic(rng, (n_ids, D))).to(cuda)
    tk, tp = table.clone().requires_grad_(), table.clone().requires_grad_()
    lookups, scatters = embedding_lookup_cuda.launches, scatter_add_cuda_.launches
    out = ops.embedding_lookup(tk, ids)
    (dk,) = torch.autograd.grad(out, tk, g)
    assert embedding_lookup_cuda.launches == lookups + 1
    assert scatter_add_cuda_.launches == scatters + 1
    (dp,) = torch.autograd.grad(tp[ids.long()], tp, g)
    assert torch.equal(out, table[ids.long()]) and torch.equal(dk, dp)
    with pytest.raises(TypeError, match="fp32"):
        ops.embedding_lookup(table.bfloat16().requires_grad_(), ids).sum().backward()


@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,Dh,causal,window,q_offset", [
    (2, 8, 2, 256, 256, 128, True, 0, 0),  # Yi-like GQA
    (1, 5, 1, 300, 300, 64, True, 100, 0),  # hymba-like window
    (2, 6, 6, 200, 200, 64, False, 0, 0),  # whisper encoder
    (2, 6, 6, 40, 300, 64, False, 0, 0),  # cross attention
    (1, 4, 2, 128, 384, 128, True, 0, 256),  # a chunk at q_offset
    (1, 2, 1, 130, 64, 64, True, 0, -40),  # rows that keep no key
])
def test_flash_attention_backward_matches_plain(cuda, B, H, Hkv, Sq, Skv, Dh, causal, window,
                                                q_offset):
    """``ops.flash_attention`` on the card: the forward on the wgmma + TMA
    kernel (bf16), the backward recomputing ``attention_blockwise``; dq, dk,
    dv within 1e-2 of the largest of autograd of the naive attention in fp32
    on the same bf16 values, and finite everywhere."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import attention_ref

    g = torch.Generator().manual_seed(Sq + Skv + window)
    mk = lambda *shape: torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (mk(B, H, Sq, Dh), mk(B, Hkv, Skv, Dh),
                                               mk(B, Hkv, Skv, Dh)))
    do = mk(B, H, Sq, Dh)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention_cuda.launches_by_variant["hopper"]
    got = torch.autograd.grad(ops.flash_attention(q, k, v, **kw), (q, k, v), do)
    assert flash_attention_cuda.launches_by_variant["hopper"] == before + 1
    ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_in, **kw), ref_in, do.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and bool(torch.isfinite(a).all())
        assert float((a.float() - b).abs().max()) <= 1e-2 * float(b.abs().max())


@pytest.mark.parametrize("dtype,sizes,variant", [
    (torch.bfloat16, [100, 0, 300, 56], "hopper"),
    (torch.bfloat16, [7, 250, 1, 0, 130], "hopper"),
    (torch.float32, [33, 0, 64], "f32"),
])
def test_gmm_backward_matches_plain_with_every_launch_on_its_kernel(cuda, dtype, sizes,
                                                                    variant):
    """``ops.gmm`` on the card: the forward and dx (over w transposed, made
    contiguous) both on the layout's kernel (bf16: the wgmma + TMA one),
    counted by mode, one tile plan for both; dx and dw (one
    ``torch._grouped_mm``) against autograd of ``gmm_plain``: fp32 within
    2e-4, bf16 within 2^-6 and 1e-4 of the largest; an empty group's dw is
    0."""
    from repro_torch.kernels.moe_gmm import TILE_ROWS, gmm_cuda, gmm_plain, gmm_tiles

    g = torch.Generator().manual_seed(len(sizes))
    E, K, N, T = len(sizes), 128, 256, sum(sizes)
    x = torch.randn(T, K, generator=g).to(cuda, dtype)
    w = (torch.randn(E, K, N, generator=g) / 8).to(cuda, dtype)
    dy = torch.randn(T, N, generator=g).to(cuda, dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    tiles = gmm_tiles(gs, T, TILE_ROWS[dtype])
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    before, by_mode = dict(gmm_cuda.launches_by_variant), dict(gmm_cuda.launches_by_mode)
    got = torch.autograd.grad(ops.gmm(xk, wk, gs, tiles=tiles), (xk, wk), dy)
    assert gmm_cuda.launches_by_variant == {**before, variant: before[variant] + 2}
    assert gmm_cuda.launches_by_mode == {**by_mode, **{m: by_mode.get(m, 0) + 1
                                                        for m in ("forward", "dx")}}
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gmm_plain(xp, wp, gs), (xp, wp), dy)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and a.shape == b.shape
        tol = (dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32
               else dict(rtol=2**-6, atol=1e-4 * float(b.float().abs().max())))
        torch.testing.assert_close(a.float(), b.float(), **tol)
    assert not got[1][sizes.index(0)].any()


@pytest.mark.parametrize("arch,compute,tol", [("yi-9b", "bfloat16", 5e-2),
                                               ("olmoe-1b-7b", "float32", 1e-3)])
def test_lm_train_step_on_the_card_matches_the_plain_path(cuda, monkeypatch, arch, compute,
                                                          tol):
    """One hier_ps train step of the smoke config on the card (2
    microbatches, remat, ``attn_impl="flash"``): every kernel of the path
    launched as its code says (per microbatch one embedding_lookup and one
    scatter_add, per layer and microbatch two flash_attention and for MoE
    nine moe_gmm, three of them dx; one fused_adagrad); loss and gradients against the same
    step on the plain versions (plain attention) within ``tol`` of each
    leaf's largest. The MoE step computes in fp32: in bf16 at smoke widths
    (256 tokens a microbatch over 8 experts) a router near-tie that rounds
    the other way on one path moves a token to another expert, a few
    percent of that expert's gradient, and which ties flip varies from run
    to run; its hopper kernels in bf16 are held by
    ``test_gmm_backward_matches_plain_with_every_launch_on_its_kernel`` and
    chip_smoke's ``moe_train`` at full width."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain
    from repro_torch.models import get_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import tree_leaves
    from repro_torch.train.train_step import TrainSettings, make_lm_grads, make_lm_train_step_hier

    dtype = getattr(torch, compute)
    monkeypatch.setattr(T, "COMPUTE_DTYPE", dtype)
    monkeypatch.setattr(moe_mod, "DISPATCH_DTYPE", dtype)
    cfg = get_smoke_config(arch)
    params = get_model(cfg).init(cfg, torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(1)
    n_working, B, S = 100, 4, 128
    batch = {"tokens": torch.from_numpy(rng.integers(0, n_working, (B, S))).to(cuda),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(cuda)}
    wt = torch.randn(n_working, cfg.d_model, device=cuda) * 0.02
    settings = TrainSettings(microbatches=2, attn_impl="flash")
    ops.reset_launch_counts()
    out = make_lm_train_step_hier(cfg, settings)(params, settings.optimizer.init(params), batch,
                                                 wt, torch.zeros_like(wt))
    L = cfg.n_layers
    want = {"embedding_lookup": 2, "scatter_add": 2, "fused_adagrad": 1,
            "flash_attention": 4 * L, "moe_gmm": 18 * L if cfg.is_moe else 0}
    assert ops.launch_counts() == {n: want.get(n, 0) for n in ops.launch_counts()}
    # the smoke configs' head dims (8, 16) take the SIMT flash kernel
    assert flash_attention_cuda.launches_by_variant == {"hopper": 0, "simt": 4 * L}
    gmm_variant = "hopper" if dtype == torch.bfloat16 else "f32"
    assert gmm_cuda.launches_by_variant == {**dict.fromkeys(("hopper", "wmma", "f32"), 0),
                                            gmm_variant: want["moe_gmm"]}
    assert gmm_cuda.launches_by_mode == ({"forward": 12 * L, "dx": 6 * L} if cfg.is_moe else {})
    assert bool(torch.isfinite(out[2]["loss"])) and not torch.equal(out[3], wt)
    kg, kt, km = make_lm_grads(cfg, settings, hier=True)(params, batch, wt)
    plain = dataclasses.replace(settings, attn_impl="naive")
    saved = ops.embedding_lookup_cuda, ops.scatter_add_cuda_, ops.gmm_cuda
    ops.embedding_lookup_cuda = lambda t, ids: embedding_lookup_plain(t, ids)
    ops.scatter_add_cuda_ = scatter_add_plain_
    ops.gmm_cuda = lambda x, w, gs, tiles=None, mode=None: gmm_plain(x, w, gs)
    try:
        pg, pt, pm = make_lm_grads(cfg, plain, hier=True)(params, batch, wt)
    finally:
        ops.embedding_lookup_cuda, ops.scatter_add_cuda_, ops.gmm_cuda = saved
    assert abs(float(km["loss"]) - float(pm["loss"])) <= 1e-2 * abs(float(pm["loss"]))
    for a, b in zip(tree_leaves(kg) + [kt], tree_leaves(pg) + [pt]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    q = torch.zeros(1, 4, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_cuda(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(1, 1, 4, 300, device=cuda)
        flash_attention_cuda(z, z, z)
    with pytest.raises(ValueError, match="group"):
        kv = torch.zeros(1, 3, 8, 16, device=cuda)
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros(1, 4, 16, 8, device=cuda).transpose(2, 3)
        flash_attention_cuda(t, t, t)


# ------------------------------------------------------------- the LM


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _serve_on_card_and_cpu(arch, tmp_path, S=192, steps=4):
    """publish -> lookup_device -> prefill (S >= 128: the flash kernel) ->
    ``steps`` greedy decode steps at ``arch``'s smoke widths in hier_ps mode,
    on the card and on the CPU's plain versions, the CPU run fed the card's
    tokens. Returns ({device: (logits per call, launch counts per call)},
    cfg)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.tables import RowSchema, TableSpec
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    cfg = get_smoke_config(arch)
    d, V = cfg.d_model, cfg.vocab_size
    spec = TableSpec("tok_emb", RowSchema.embedding(d))
    rows = np.random.default_rng(0).normal(size=(V, d)).astype(np.float32)
    publish_arrays(str(tmp_path), n_nodes=2, dim=d,
                   tables={"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)})
    prompts = np.random.default_rng(1).integers(0, V, (2, S)).astype(np.uint64)
    img = (torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, cfg.n_image_tokens, d)).astype(np.float32)) if cfg.family == "vlm" else None)
    params = T.init(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(ServingCluster(str(tmp_path)), device_hot_rows=128, device=device)
        p = _tree_to(params, device)
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        ops.reset_launch_counts()
        slots, wt = eng.lookup_device("tok_emb", prompts)
        batch = {"tokens": torch.from_numpy(slots).to(device), "working_table": wt}
        if img is not None:
            batch["image_embeds"] = img.to(device)
        logits, cache = prefill(p, batch)
        counts = [ops.launch_counts()]
        ctx = cache.k.shape[3]
        cache = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, steps)) for a in cache))
        out = [logits.cpu()]
        tok = greedy_sample(runs["cuda"][0][0] if device == "cpu" else logits).cpu()
        for i in range(steps):
            ops.reset_launch_counts()
            slots, wt = eng.lookup_device("tok_emb", tok.numpy().astype(np.uint64))
            logits, cache = decode(p, {"token": torch.from_numpy(slots).to(device),
                                       "working_table": wt}, cache, ctx + i)
            counts.append(ops.launch_counts())
            out.append(logits.cpu())
            # the CPU run is fed the card's tokens: both decode the same sequence
            tok = greedy_sample(runs["cuda"][0][i + 1] if device == "cpu" else logits).cpu()
        runs[device] = out, counts
    return runs, cfg


def test_lm_serving_on_the_card_tracks_the_cpu(cuda, tmp_path):
    """Yi-9B's smoke widths in hier_ps mode: publish -> lookup_device ->
    prefill (S = 192 >= 128: the flash kernel, once per layer, and one
    embedding_lookup) -> 4 greedy decode steps (one embedding_lookup each,
    no flash). The same on the CPU's plain versions agrees within 2e-2 of
    the logits' largest magnitude (bf16 roundings in other orders)."""
    runs, cfg = _serve_on_card_and_cpu("yi-9b", tmp_path)
    out, counts = runs["cuda"]
    assert counts[0]["flash_attention"] == cfg.n_layers and counts[0]["embedding_lookup"] == 1
    assert all(c["embedding_lookup"] == 1 and c["flash_attention"] == 0 for c in counts[1:])
    assert set(runs["cpu"][1][0].values()) == {0}
    for got, want in zip(out, runs["cpu"][0]):
        assert torch.isfinite(got).all()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 2e-2 * scale, (err, scale)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "pixtral-12b"])
def test_moe_and_vlm_serving_on_the_card_track_the_cpu(cuda, tmp_path, arch):
    """The same path at olmoe-1b-7b's smoke widths (three moe_gmm launches
    per layer in the prefill and in each decode step) and pixtral-12b's
    (image embeddings first; no kernel of its own), within the same 2e-2."""
    runs, cfg = _serve_on_card_and_cpu(arch, tmp_path)
    out, counts = runs["cuda"]
    gmm = 3 * cfg.n_layers if cfg.is_moe else 0
    assert counts[0] == {**{n: 0 for n in counts[0]}, "embedding_lookup": 1,
                         "flash_attention": cfg.n_layers, "moe_gmm": gmm}
    assert all(c == {**{n: 0 for n in c}, "embedding_lookup": 1, "moe_gmm": gmm}
               for c in counts[1:])
    assert set(runs["cpu"][1][0].values()) == {0}
    for got, want in zip(out, runs["cpu"][0]):
        assert torch.isfinite(got).all()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 2e-2 * scale, (err, scale)


def test_hymba_ring_decode_on_the_card_tracks_the_cpu(cuda):
    """hymba-1.5b's smoke widths: a 192-token prefill (200 positions with
    the meta tokens: flash on the card, the ring of 32 rolled), then 3 decode
    steps on the ring, the global cache and the mamba states, on the card
    and on the CPU's plain versions from the same weights and tokens: logits
    and every cache leaf within 2e-2 of their largest magnitude."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import hymba as TH
    from repro_torch.serve.serve_step import make_decode_step

    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), embedding_mode="dense")
    params = TH.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 195)))
    n0 = cfg.n_meta_tokens + 192
    runs = {}
    for device in ("cuda", "cpu"):
        ops.reset_launch_counts()
        p = _tree_to(params, device)
        logits, cache = TH.prefill(cfg, p, toks[:, :192].to(device), max_len=n0 + 3)
        counts = ops.launch_counts()
        out = [logits.cpu()]
        for i in range(3):
            logits, cache = make_decode_step(cfg)(
                p, {"token": toks[:, 192 + i:193 + i].to(device)}, cache, n0 + i)
            out.append(logits.cpu())
        leaves = [t.cpu() for group in cache for t in group]
        runs[device] = out, leaves, counts
    assert runs["cuda"][2]["flash_attention"] == cfg.n_layers
    assert set(runs["cpu"][2].values()) == {0}
    for got, want in zip(runs["cuda"][0] + runs["cuda"][1], runs["cpu"][0] + runs["cpu"][1]):
        assert got.shape == want.shape and torch.isfinite(got.float()).all()
        got, want = got.float(), want.float()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        assert err <= 2e-2 * scale, (err, scale)


# --------------------------------------------------------------- moe_gmm

GMM_CASES = [
    # E, K, N, group sizes, extra rows past the groups
    (4, 128, 128, [100, 0, 300, 56], 0),  # the reference's shapes
    (3, 256, 128, [128, 128, 128], 0),
    (5, 128, 256, [7, 250, 1, 0, 130], 0),  # groups of 1, empty groups
    (5, 100, 72, [7, 250, 1, 0, 130], 0),  # K and N that do not tile
    (3, 9, 13, [1, 1, 1], 0),  # odd K and N below a tile
    (8, 256, 200, [300, 0, 0, 129, 128, 127, 1, 64], 0),
    (4, 64, 48, [10, 0, 20, 5], 37),  # rows past the last group -> 0
    (64, 2048, 1024, [32] * 64, 0),  # an OLMoE decode step's capacity buffer
    # K and N tails of the Hopper kernel's 64-deep, 256-wide tiles, tiles
    # that start and end mid-box, groups of exactly 64 rows (one consumer)
    (6, 136, 264, [1, 65, 0, 200, 64, 129], 5),
    (3, 64, 512, [64, 64, 64], 0),
    (9, 2048, 1024, [1, 0, 3, 0, 0, 2, 0, 1, 1], 0),  # a compacted decode step
]


def _gmm_inputs(case, dtype, cuda):
    E, K, N, sizes, extra = case
    g = torch.Generator().manual_seed(E * K + N)
    x = torch.randn(sum(sizes) + extra, K, generator=g).to(cuda, dtype)
    w = (torch.randn(E, K, N, generator=g) * 0.1).to(cuda, dtype)
    return x, w, torch.tensor(sizes, dtype=torch.int32, device=cuda)


def _gmm_close(got, want):
    """fp32 within 2e-4 (the reference's test_gmm_vs_ref). bf16: both round
    an fp32 sum, taken in another order, to bf16 once, so they sit at most
    one bf16 ulp apart: rtol 2^-6, with atol 1e-4 of the largest output for
    outputs near 0."""
    assert got.dtype == want.dtype and got.shape == want.shape and got.is_contiguous()
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        atol = 1e-4 * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2**-6, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GMM_CASES)
def test_gmm_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain

    x, w, gs = _gmm_inputs(case, dtype, cuda)
    before = gmm_cuda.launches
    got = ops.gmm(x, w, gs)
    assert gmm_cuda.launches == before + 1
    want = gmm_plain(x, w, gs)
    _gmm_close(got, want)
    if case[4]:
        assert torch.equal(got[sum(case[3]):], torch.zeros_like(got[sum(case[3]):]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_kernel_takes_unaligned_views(cuda, dtype):
    """x a column view (row stride K + 3, base off 16 bytes), w a view of a
    wider stacked tensor (N offset 3) and a layer of a stacked [L, E, K, N]
    tensor, group sizes on the CPU."""
    from repro_torch.kernels.moe_gmm import gmm_plain, gmm_variant

    g = torch.Generator().manual_seed(7)
    sizes = torch.tensor([33, 0, 90, 1, 6])
    xb = torch.randn(130, 67, generator=g).to(cuda, dtype)
    wb = (torch.randn(2, 5, 64, 99, generator=g) * 0.1).to(cuda, dtype)
    for x, w in ((xb[:, 3:], wb[1, :, :, 3:]), (xb[:, :64], wb[0, :, :, :96]),
                 (xb[:, 3:], wb[1, :, :, :96]), (xb[:, :64].contiguous(), wb[1, :, :, 3:])):
        # layouts TMA cannot describe fall to the wmma kernel (bf16)
        assert gmm_variant(x, w) == ("f32" if dtype == torch.float32 else "wmma")
        _gmm_close(ops.gmm(x, w, sizes), gmm_plain(x, w, sizes))


HOPPER_GMM_CASES = [c for c in GMM_CASES if c[1] % 8 == 0 and c[2] % 8 == 0]


@pytest.mark.parametrize("case", HOPPER_GMM_CASES)
def test_gmm_hopper_kernel_matches_plain_and_wmma(cuda, case):
    """The wgmma + TMA kernel on every bf16 case a TMA descriptor takes:
    within one bf16 ulp of the plain version over the whole output (a tile
    that stored past its end row would overwrite the next group's rows),
    zeros past the last group, the same bits with the plan passed in and on
    a second launch, and within the tolerance of the wmma kernel."""
    from repro_torch.kernels.moe_gmm import TILE_ROWS, gmm_cuda, gmm_plain, gmm_tiles, gmm_variant

    x, w, gs = _gmm_inputs(case, torch.bfloat16, cuda)
    assert gmm_variant(x, w) == "hopper"
    before = dict(gmm_cuda.launches_by_variant)
    got = gmm_cuda(x, w, gs)
    assert gmm_cuda.launches_by_variant == {**before, "hopper": before["hopper"] + 1}
    _gmm_close(got, gmm_plain(x, w, gs))
    if case[4]:
        assert torch.equal(got[sum(case[3]):], torch.zeros_like(got[sum(case[3]):]))
    tiles = gmm_tiles(gs, x.shape[0], TILE_ROWS[torch.bfloat16])
    assert torch.equal(gmm_cuda(x, w, gs, tiles=tiles), got)
    assert torch.equal(gmm_cuda(x, w, gs), got)
    _gmm_close(gmm_cuda(x, w, gs, variant="wmma"), gmm_plain(x, w, gs))
    assert gmm_cuda.launches_by_variant["wmma"] == before["wmma"] + 1


def test_moe_block_compacted_equals_padded_on_the_card(cuda):
    """olmoe-1b-7b's smoke widths on the card, bf16: moe_block (the
    compacted buffer) against the same routing through the capacity-buffer
    layout, both through the Hopper kernel: each kept row is the same
    product, so within one bf16 ulp of the largest output."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.moe_gmm import gmm_cuda
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT

    cfg = get_smoke_config("olmoe-1b-7b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    lp = {n: t[0] for n, t in TT.init(cfg, gen, dtype=torch.bfloat16)["layers"]["moe"].items()}
    x = torch.randn((2, 96, cfg.d_model), generator=gen, device=cuda).to(torch.bfloat16)
    before = gmm_cuda.launches_by_variant["hopper"]
    got, _ = TM.moe_block(x, lp, cfg)
    assert gmm_cuda.launches_by_variant["hopper"] == before + 3
    xf = x.reshape(-1, cfg.d_model)
    r = TM.route(xf, lp["router"], cfg)
    E, G, C = cfg.n_experts, r.groups, r.capacity
    want = TM.run_experts(xf, lp, cfg, r, r.slot, E * G * C,
                          torch.full((E,), G * C, dtype=torch.int32, device=cuda))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.reshape(want.shape).float(), want.float(), rtol=2**-6,
                               atol=2**-7 * float(want.float().abs().max()))


def test_gmm_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.moe_gmm import gmm_cuda

    x, w = torch.zeros(8, 16, device=cuda), torch.zeros(2, 16, 8, device=cuda)
    gs = torch.tensor([4, 4], device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        gmm_cuda(x, w.bfloat16(), gs)
    with pytest.raises(ValueError, match="K="):
        gmm_cuda(x, w[:, :8], gs)
    with pytest.raises(ValueError, match="group_sizes"):
        gmm_cuda(x, w, gs.float())
    with pytest.raises(ValueError, match="unit column stride"):
        gmm_cuda(torch.zeros(16, 8, device=cuda).T, w, gs)
    with pytest.raises(ValueError, match="unit stride over N"):
        gmm_cuda(x, torch.zeros(2, 8, 16, device=cuda).transpose(1, 2), gs)


# --------------------------------------------------------------------------
# slice 8: the sharded working table and the launcher
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,b", [(53, 16, 24), (269_658, 8, 25_600), (3_729, 4096, 8_192)])
def test_sharded_bodies_match_plain(cuda, n, d, b):
    """The S = 4 per-shard bodies of ``ShardedWorkingTable`` on the card
    against the same bodies on the CPU (the plain versions): the gathers
    bitwise, ``accumulate`` bitwise on dyadic values (every sum exact); each
    body launches its kernel once."""
    from repro_torch.core.hbm_ps import (a2a_restore_body, a2a_serve_body, accumulate_body,
                                         plan_a2a, psum_body, to_sharded_rows)

    S = 4
    rng = np.random.default_rng(n)
    table = _dyadic(rng, (n, d))
    slots = rng.integers(0, n, b).astype(np.int32)
    grads = torch.from_numpy(_dyadic(rng, (b, d)))
    shards = torch.from_numpy(to_sharded_rows(table, S)).chunk(S)
    req, restore = (torch.from_numpy(a) for a in plan_a2a(slots, S))
    m = req.shape[-1]
    sl = torch.from_numpy(slots)
    for r in range(S):
        before = ops.launch_counts()
        kp = psum_body(shards[r].to(cuda), sl.to(cuda), r, S)
        ka = accumulate_body(shards[r].to(cuda), sl.to(cuda), grads.to(cuda), r, S)
        ks = a2a_serve_body(shards[r].to(cuda), req[:, r].reshape(-1).to(cuda), S)
        after = ops.launch_counts()
        assert after["embedding_lookup"] == before["embedding_lookup"] + 2
        assert after["scatter_add"] == before["scatter_add"] + 1
        assert torch.equal(kp.cpu(), psum_body(shards[r], sl, r, S))
        assert torch.equal(ka.cpu(), accumulate_body(shards[r], sl, grads, r, S))
        assert torch.equal(ks.cpu(), a2a_serve_body(shards[r], req[:, r].reshape(-1), S))
    served = [a2a_serve_body(shards[o].to(cuda), req[:, o].reshape(-1).to(cuda), S)
              for o in range(S)]
    got = torch.cat([a2a_restore_body(torch.cat([served[o][r * m:(r + 1) * m] for o in range(S)]),
                                      restore[r].to(cuda)) for r in range(S)])
    assert torch.equal(got.cpu(), torch.from_numpy(table[slots]))


def test_sharded_working_table_on_a_world_of_one_nccl_equals_working_table(cuda):
    """``ShardedWorkingTable`` over a real NCCL group of one (its
    ``all_reduce`` and two ``all_to_all_single``) equals ``WorkingTable``
    bitwise."""
    from repro_torch.core.hbm_ps import ShardedWorkingTable, WorkingTable, plan_a2a
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    init_distributed("cuda")
    try:
        assert torch.distributed.get_backend() == "nccl"
        swt = ShardedWorkingTable(make_host_mesh(), "model")
        rng = np.random.default_rng(0)
        table = torch.from_numpy(_dyadic(rng, (3_729, 4096))).to(cuda)
        slots = torch.from_numpy(rng.integers(0, 3_729, 8_192).astype(np.int32)).to(cuda)
        grads = torch.from_numpy(_dyadic(rng, (8_192, 4096))).to(cuda)
        assert torch.equal(swt.get_psum(table, slots), WorkingTable.get(table, slots))
        assert torch.equal(swt.accumulate(table, slots, grads),
                           WorkingTable.accumulate(table, slots, grads))
        req, restore = plan_a2a(slots.cpu().numpy(), 1)
        got = swt.get_a2a(table, torch.from_numpy(req[0]).to(cuda),
                          torch.from_numpy(restore[0]).to(cuda))
        assert torch.equal(got, WorkingTable.get(table, slots))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_launcher_trains_and_resumes_bitwise_on_the_card(cuda, tmp_path, arch):
    """``launch.train.run`` at smoke widths on an NCCL world of one (128
    tokens a row, so attention takes the flash kernel): finite losses
    through the kernels, and a resume restores params, optimizer state and
    PS rows bitwise."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch
    from repro_torch.train.optim import AdamW, tree_leaves
    from repro_torch.train.train_step import TrainSettings

    cfg = get_smoke_config(arch)
    settings = TrainSettings(optimizer=AdamW(lr=1e-3), microbatches=2)

    def rows(client):
        with client.session("tok_emb", np.arange(cfg.vocab_size, dtype=np.uint64),
                            read_only=True) as s:
            return np.asarray(s.params)[s.slots].copy(), np.asarray(s.opt_state)[s.slots].copy()

    try:
        ops.reset_launch_counts()
        a = launch.run(cfg, settings, steps=2, batch=4, seq=128, ckpt_every=2,
                       base=str(tmp_path))
        counts = ops.launch_counts()
        assert np.isfinite(a.losses).all() and len(a.losses) == 2
        assert counts["embedding_lookup"] == counts["scatter_add"] == 4
        assert counts["fused_adagrad"] == 2 and counts["flash_attention"] > 0
        assert (counts["moe_gmm"] > 0) == (arch == "olmoe-1b-7b")
        saved = rows(a.client)
        b = launch.run(cfg, settings, steps=0, resume=True, ckpt_every=0, base=str(tmp_path))
        assert b.start == 2
        state = lambda r: (tree_leaves(r.params) + tree_leaves(r.opt_state.m)
                           + tree_leaves(r.opt_state.v) + [r.opt_state.step])
        for x, y in zip(state(a), state(b)):
            assert x.is_cuda and torch.equal(x, y)
        for x, y in zip(saved, rows(b.client)):
            assert np.array_equal(x, y)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


TP_RANK_SCRIPT = """
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    import repro_torch.models.hymba, repro_torch.models.moe, repro_torch.models.whisper
    import repro_torch.models.xlstm
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.fused_adagrad import adagrad_plain
    from repro_torch.kernels.scatter_add import scatter_add_plain_
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.common import gather_from_model
    from repro_torch.train.optim import AdamW, tree_leaves, tree_map
    from repro_torch.train.train_step import TrainSettings, make_lm_grads, replicated_leaves
    for name, mod in list(sys.modules.items()):  # every model module computes in COMPUTE
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if name.startswith("repro_torch.models") and hasattr(mod, attr):
                setattr(mod, attr, getattr(torch, os.environ["COMPUTE"]))
    info = init_distributed("cuda", init_method=os.environ["INIT_METHOD"], backend="gloo")
    dev = info.device
    cfg = dataclasses.replace(get_smoke_config(os.environ["ARCH"]),
                              **json.loads(os.environ["VARIANT"]))
    mesh = make_host_mesh(model=2)
    rules = shd.build_rules(cfg, mesh)
    shd.install_constraints(mesh, rules, cfg)
    schema = get_model(cfg).schema(cfg)
    z = torch.load(os.environ["INPUTS"])
    mr = mesh.get_local_rank("model")
    params = shd.shard_tree(tree_map(lambda t: t.to(dev), z["params"]), schema, rules, mesh, mr)
    d = cfg.d_model
    wt = z["wt"][:, mr * d // 2:(mr + 1) * d // 2].contiguous().to(dev)
    batch = {k: v.to(dev) for k, v in z["batch"].items()}
    # each kernel's first call on this rank's shards, held against its plain version below
    plain = {"flash_attention_cuda": flash_attention_plain,
             "embedding_lookup_cuda": embedding_lookup_plain,
             "scatter_add_cuda_": scatter_add_plain_}
    kernel = {w: getattr(ops, w) for w in plain}
    first = {}
    def recorder(w):
        def call(*args, **kw):
            first.setdefault(w, ([a.detach().clone() if torch.is_tensor(a) else a
                                  for a in args], kw))
            return kernel[w](*args, **kw)
        return call
    for w in plain:
        setattr(ops, w, recorder(w))
    ops.reset_launch_counts()
    settings = TrainSettings(microbatches=2, attn_impl="flash")
    g, tg, metrics = make_lm_grads(cfg, settings, hier=True)(params, batch, wt)
    counts = ops.launch_counts()
    for w in plain:
        setattr(ops, w, kernel[w])
    first["adagrad_cuda"] = ([wt, torch.full_like(wt, 0.1), tg, 0.05], {})
    plain["adagrad_cuda"], kernel["adagrad_cuda"] = adagrad_plain, ops.adagrad_cuda
    vs_plain = {}
    for w, (args, kw) in first.items():
        if w == "scatter_add_cuda_":  # both into zeros
            got = kernel[w](torch.zeros_like(args[0]), *args[1:], **kw)
            want = plain[w](torch.zeros_like(args[0]), *args[1:])
        else:
            got, want = kernel[w](*args, **kw), plain[w](*args, **kw)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        vs_plain[w] = ([list(a.shape) for a in args if torch.is_tensor(a)],
                       [(a.float().cpu(), b.float().cpu()) for a, b in zip(got, want)])
    g = tree_map(lambda t: t.cpu(), shd.gather_tree(g, schema, rules, mesh))
    out = {"g": g, "t": gather_from_model(tg, -1).cpu(), "loss": float(metrics["loss"]),
           "counts": counts, "vs_plain": vs_plain}
    shd.clear_constraints()
    settings = TrainSettings(optimizer=AdamW(lr=1e-3), microbatches=2)
    base = os.path.join(os.environ["OUT"], "run")
    res = launch.run(cfg, settings, steps=2, batch=4, seq=128, model_parallel=2, base=base,
                     ckpt_every=2, device=dev, backend="gloo")
    # the step-2 checkpoint (gathered to rank 0's host) resumed on the shards
    again = launch.run(cfg, settings, steps=0, model_parallel=2, base=base, resume=True,
                       ckpt_every=0, device=dev, backend="gloo")
    leaves = lambda r: (tree_leaves(r.params) + tree_leaves(r.opt_state.m)
                        + tree_leaves(r.opt_state.v))
    pairs = zip(leaves(res), leaves(again))
    out.update(losses=res.losses, local=tree_map(lambda t: t.cpu(), res.params),
               mask=replicated_leaves(cfg, res.params), device=str(dev),
               resumed_equal=all(torch.equal(a, b) for a, b in pairs))
    torch.save(out, os.path.join(os.environ["OUT"], f"rank{info.rank}.pt"))
    torch.distributed.destroy_process_group()
"""

# the smoke configs whose heads divide over a model axis of 2 (hymba's 5 do not)
TP_VARIANTS = {"hymba-1.5b": {"n_heads": 4, "n_kv_heads": 2}}


@pytest.mark.parametrize("arch,compute,tol", [("yi-9b", "bfloat16", 5e-2),
                                               ("olmoe-1b-7b", "float32", 1e-3),
                                               ("hymba-1.5b", "float32", 1e-3),
                                               ("xlstm-1.3b", "float32", 1e-3),
                                               ("whisper-tiny", "bfloat16", 5e-2)])
def test_tensor_parallel_gloo_ranks_on_one_card_match_the_world_of_one(cuda, tmp_path,
                                                                       monkeypatch, arch,
                                                                       compute, tol):
    """Two gloo ranks on this one card, a (1, 2) mesh (NCCL takes one rank a
    card): ``make_lm_grads`` of the smoke config (``TP_VARIANTS``' heads for
    hymba) on each rank's shards (2 microbatches of 4 x 128 tokens, flash
    attention) gathered over ``model`` against the same gradients in one
    process with no group (within ``tol`` of each leaf's largest, as
    ``test_lm_train_step_on_the_card_matches_the_plain_path`` holds them;
    olmoe in fp32 for its router's near-ties, hymba and xlstm in fp32 as
    the CPU tests hold them); each rank's kernels launched on its shards,
    each at its first call's local inputs against its plain version (the
    lookup and Adagrad bitwise, ``scatter_add`` within its contract bound,
    flash within its tolerance); then two steps of
    ``launch.train.run(..., model_parallel=2)`` leave the replicated leaves
    bitwise equal on the two ranks, and their step-2 checkpoint, resumed at
    ``model_parallel=2``, gives each rank its shards of params and AdamW
    state bitwise."""
    import dataclasses
    import json
    import os
    import subprocess
    import sys
    import textwrap
    from pathlib import Path

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model, hymba, whisper
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import tree_leaves, tree_map
    from repro_torch.train.train_step import TrainSettings, make_lm_grads

    dtype = getattr(torch, compute)
    for mod in (T, hymba, whisper):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", dtype)
    monkeypatch.setattr(moe_mod, "DISPATCH_DTYPE", dtype)
    variant = TP_VARIANTS.get(arch, {})
    cfg = dataclasses.replace(get_smoke_config(arch), **variant)
    params = get_model(cfg).init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    n_working, B, S = 100, 4, 128
    batch = {"tokens": torch.from_numpy(rng.integers(0, n_working, (B, S))),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    wt = torch.from_numpy(rng.standard_normal((n_working, cfg.d_model)).astype(np.float32) * 0.02)
    torch.save({"params": params, "batch": batch, "wt": wt}, tmp_path / "inputs.pt")
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent(TP_RANK_SCRIPT))
    root = Path(__file__).resolve().parents[1]
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(root / "src"), RANK=str(r),
                            WORLD_SIZE="2", LOCAL_RANK=str(r), OMP_NUM_THREADS="1",
                            INIT_METHOD=f"file://{tmp_path / 'rendezvous'}", ARCH=arch,
                            VARIANT=json.dumps(variant), COMPUTE=compute,
                            INPUTS=str(tmp_path / "inputs.pt"), OUT=str(tmp_path)))
        for r in range(2)]
    errs = [p.communicate(timeout=600)[1] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-3000:] for e in errs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    on = lambda t: t.to(cuda)
    want_g, want_t, want_m = make_lm_grads(cfg, TrainSettings(microbatches=2, attn_impl="flash"),
                                           hier=True)(tree_map(on, params),
                                                      tree_map(on, batch), on(wt))
    L = cfg.n_layers
    # attention calls a forward, each on the flash kernel (attn_impl="flash")
    attention = {"audio": cfg.encoder_layers + 2 * L, "ssm": 0}.get(cfg.family, L)
    for got in ranks:
        assert got["device"] == "cuda:0"
        assert abs(got["loss"] - float(want_m["loss"])) <= 1e-2 * abs(float(want_m["loss"]))
        for a, b in zip(tree_leaves(got["g"]) + [got["t"]], tree_leaves(want_g) + [want_t]):
            assert a.shape == b.shape and bool(torch.isfinite(a).all())
            assert float((a - b.cpu()).abs().max()) <= tol * float(b.abs().max())
        want = {"embedding_lookup": 2, "scatter_add": 2, "flash_attention": 4 * attention,
                "moe_gmm": 18 * L if cfg.is_moe else 0}
        assert got["counts"] == {n: want.get(n, 0) for n in got["counts"]}
        vs_plain = got["vs_plain"]
        assert set(vs_plain) == {"embedding_lookup_cuda", "scatter_add_cuda_", "adagrad_cuda"} | (
            {"flash_attention_cuda"} if attention else set())
        for w, (shapes, outs) in vs_plain.items():
            assert w == "flash_attention_cuda" or shapes[0][-1] == cfg.d_model // 2, (w, shapes)
            for k, p in outs:
                if w in ("embedding_lookup_cuda", "adagrad_cuda"):
                    assert torch.equal(k, p), w
                elif w == "scatter_add_cuda_":
                    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max()) + 1e-6, w
                else:
                    rtol = 2e-5 if dtype == torch.float32 else 2**-6
                    assert torch.allclose(k, p, rtol=rtol, atol=2e-5), (w, shapes)
        assert np.isfinite(got["losses"]).all() and got["losses"] == ranks[0]["losses"]
        assert got["resumed_equal"]
    flags = tree_leaves(ranks[0]["mask"])
    assert any(flags) and not all(flags)
    for a, b, replicated in zip(tree_leaves(ranks[0]["local"]), tree_leaves(ranks[1]["local"]),
                                flags):
        assert torch.equal(a, b) if replicated else a.shape == b.shape
