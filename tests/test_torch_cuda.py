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
from repro_torch.kernels.topk_mips import MAX_K, topk_mips_cuda, topk_mips_plain  # noqa: E402
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
    kv, ki = ops.topk_mips(q, c, k, n_valid=n_valid)
    assert topk_mips_cuda.launches == before + 1
    pv, pi = topk_mips_plain(q, c, k, n_valid=n_valid)
    assert torch.equal(kv, pv) and torch.equal(ki, pi)


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


# ------------------------------------------------------------- adagrad


@pytest.mark.parametrize("shape", [(269_400, 8), (1001, 3), (7, 12), (0, 8), (1, 1)])
def test_adagrad_kernel_matches_plain_bitwise(cuda, shape):
    g = torch.Generator().manual_seed(shape[0])
    p = torch.randn(shape, generator=g).to(cuda)
    a = torch.randn(shape, generator=g).abs().to(cuda)
    gr = torch.randn(shape, generator=g).to(cuda)
    before = adagrad_cuda.launches
    kp, ka = ops.adagrad_update(p, a, gr, 0.05)
    assert adagrad_cuda.launches == before + (1 if p.numel() else 0)
    pp, pa = adagrad_plain(p, a, gr, 0.05)
    assert torch.equal(kp, pp) and torch.equal(ka, pa)
    cp, ca = adagrad_plain(p.cpu(), a.cpu(), gr.cpu(), 0.05)  # the CPU gives the same bits
    assert torch.equal(kp.cpu(), cp) and torch.equal(ka.cpu(), ca)


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
