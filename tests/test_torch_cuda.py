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
    assert out["cpu"][-1] == {"topk_mips": 0, "embedding_bag": 0}
    for a, b in zip(out["cuda"][:-1], out["cpu"][:-1]):
        np.testing.assert_array_equal(a, b)
