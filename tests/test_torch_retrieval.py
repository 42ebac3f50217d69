"""The port's retrieval subsystem against the JAX reference.

Mirrors the engine-level cases of ``tests/test_retrieval.py`` on the port
(``device="cpu"``: the kernels' plain versions run), and requires the port's
search and rerank to equal the JAX package's on the same published snapshot
— bitwise on dyadic-grid rows, where every score is exact in fp32. The last
case runs the whole serving slice end to end at small widths.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.retrieval import RetrievalEngine as JRetrievalEngine  # noqa: E402
from repro.serve import ServingCluster as JServingCluster  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs.ctr_models import CTRConfig, table_specs  # noqa: E402
from repro_torch.convert import publish_arrays  # noqa: E402
from repro_torch.core.node import Cluster  # noqa: E402
from repro_torch.core.tables import RowSchema, TableRegistry, TableSpec  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTRStream  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.metrics import KNOWN_COUNTERS, Counters  # noqa: E402
from repro_torch.retrieval import (  # noqa: E402
    RETRIEVAL_COUNTER_NAMES,
    RetrievalEngine,
    RetrievalIndex,
)
from repro_torch.serve import (  # noqa: E402
    LiveClusterView,
    ServingCluster,
    ServingEngine,
    SnapshotPublisher,
)

DIM = 8
N_ADS = 300


def _dyadic(rng, shape):
    """f32 values on a 1/64 grid: every score is exact in fp32."""
    return (rng.integers(-128, 128, size=shape) / 64.0).astype(np.float32)


def _oracle(q, rows, k):
    v, i = jref.topk_mips_ref(q, rows, k)
    return np.asarray(v), np.asarray(i)


@pytest.fixture
def setup(tmp_path):
    reg = TableRegistry([
        TableSpec("ads", RowSchema.with_adagrad(DIM)),
        TableSpec("user", RowSchema.with_adagrad(DIM)),
    ])
    cluster = Cluster(2, str(tmp_path / "train"), dim=2 * DIM, cache_capacity=1024,
                      file_capacity=64, init_cols=DIM, tables=reg)
    rng = np.random.default_rng(7)
    keys = np.arange(N_ADS, dtype=np.uint64)
    rows = _dyadic(rng, (N_ADS, DIM))
    full = np.zeros((N_ADS, 2 * DIM), np.float32)
    full[:, :DIM] = rows
    cluster.push(reg.get("ads").namespace(keys), full, unpin=False)
    # a second table in the same key range: the index must filter it out
    cluster.push(reg.get("user").namespace(np.arange(40, dtype=np.uint64)),
                 np.full((40, 2 * DIM), 9.0, np.float32), unpin=False)
    pub = SnapshotPublisher(cluster, str(tmp_path / "snap"))
    pub.publish()
    return cluster, reg, pub, keys, rows


def _engine(pub, **kw):
    eng = ServingEngine(ServingCluster(pub.dir), cache_rows=1024, device="cpu")
    kw.setdefault("device", "cpu")
    return RetrievalEngine(eng, "ads", **kw)


def _jax_engine(directory, **kw):
    eng = JServingEngine(JServingCluster(directory), cache_rows=1024)
    kw.setdefault("use_pallas", False)
    return JRetrievalEngine(eng, "ads", **kw)


# ------------------------------------------------------------ index build


def test_index_build_filters_sorts_and_pads_to_load_width(setup):
    cluster, reg, pub, keys, rows = setup
    idx = RetrievalIndex.build(ServingCluster(pub.dir), "ads", device="cpu")
    assert idx.n_rows == N_ADS and idx.dim == DIM and idx.version == 1
    np.testing.assert_array_equal(idx.keys, keys)  # ascending raw keys
    corpus = idx.corpus.numpy()
    assert corpus.shape == (N_ADS, DIM)  # no 128-lane or block padding
    np.testing.assert_array_equal(corpus, rows)
    assert not (corpus == 9.0).any()  # the "user" table never leaks in


def test_index_pads_odd_dims_to_four_floats(tmp_path):
    spec = TableSpec("ads", RowSchema.with_adagrad(5))
    rows = _dyadic(np.random.default_rng(0), (20, 5))
    publish_arrays(str(tmp_path), n_nodes=2, dim=10, init_cols=5,
                   tables={"ads": (spec, np.arange(20, dtype=np.uint64), rows)})
    idx = RetrievalIndex.build(ServingCluster(str(tmp_path)), "ads", device="cpu")
    assert tuple(idx.corpus.shape) == (20, 8)
    np.testing.assert_array_equal(idx.corpus[:, :5].numpy(), rows)
    assert not idx.corpus[:, 5:].any()


def test_index_rejects_live_view(setup):
    cluster, reg, pub, keys, rows = setup
    live = ServingEngine(LiveClusterView(cluster), device="cpu")
    with pytest.raises(TypeError):
        RetrievalEngine(live, "ads", device="cpu")


# -------------------------------------------------------- engine semantics


def test_search_matches_oracle_and_jax_engine_on_snapshot(setup):
    cluster, reg, pub, keys, rows = setup
    retr, jretr = _engine(pub), _jax_engine(pub.dir)
    q = _dyadic(np.random.default_rng(8), (5, DIM))
    res, jres = retr.search(q, 10), jretr.search(q, 10)
    want_v, want_i = _oracle(q, rows, 10)
    for r in (res, jres):
        np.testing.assert_array_equal(r.scores, want_v)
        np.testing.assert_array_equal(r.indices, want_i)
    np.testing.assert_array_equal(res.ad_keys, jres.ad_keys)
    np.testing.assert_array_equal(res.ad_keys[res.valid],
                                  res.indices[res.valid].astype(np.uint64))
    assert res.valid.all() and res.version == 1
    assert retr.counters["retrieval_searches"] == 1
    assert retr.counters["retrieval_rows_scored"] == 5 * N_ADS


def test_search_equals_jax_pallas_kernel_in_interpret_mode(setup):
    cluster, reg, pub, keys, rows = setup
    retr = _engine(pub)
    jretr = _jax_engine(pub.dir, use_pallas=True, interpret=True, block_q=8, block_n=64)
    q = _dyadic(np.random.default_rng(18), (9, DIM))
    for k in (3, 400):  # k beyond the corpus pads with (-inf, -1)
        res, jres = retr.search(q, k), jretr.search(q, k)
        np.testing.assert_array_equal(res.scores, jres.scores)
        np.testing.assert_array_equal(res.indices, jres.indices)
        np.testing.assert_array_equal(res.valid, jres.valid)


def test_search_shape_contract_and_validation(setup):
    cluster, reg, pub, keys, rows = setup
    retr = _engine(pub)
    empty = retr.search(np.zeros((0, DIM), np.float32), 7)
    assert empty.scores.shape == (0, 7) and empty.indices.shape == (0, 7)
    with pytest.raises(ValueError):
        retr.search(np.zeros((2, DIM + 1), np.float32), 5)  # wrong emb dim
    with pytest.raises(ValueError):
        retr.search(np.zeros((2, DIM), np.float32), 0)  # k < 1
    retr.close()
    with pytest.raises(RuntimeError):
        retr.search(np.zeros((2, DIM), np.float32), 5)


def test_roll_forward_atomic_under_concurrent_search(setup):
    """Every in-flight search during a roll matches the oracle of the single
    version it reports — never a mix of two corpora."""
    cluster, reg, pub, keys, rows = setup
    rows2 = rows * 2.0  # still dyadic; every score differs from v1's
    full2 = np.zeros((N_ADS, 2 * DIM), np.float32)
    full2[:, :DIM] = rows2
    retr = _engine(pub)
    assert retr.version == 1
    q = _dyadic(np.random.default_rng(9), (4, DIM))
    oracle = {1: _oracle(q, rows, 6), 2: _oracle(q, rows2, 6)}
    stop, bad, done = threading.Event(), [], []

    def worker():
        n = 0
        try:
            while not stop.is_set():
                res = retr.search(q, 6)
                wv, wi = oracle[res.version]
                if not (np.array_equal(res.scores, wv) and np.array_equal(res.indices, wi)):
                    bad.append(f"version {res.version} result != its oracle")
                    stop.set()
                n += 1
        except Exception as e:  # a crash must fail the test, not pass it
            bad.append(f"worker raised: {e!r}")
            stop.set()
        finally:
            done.append(n)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    cluster.push(reg.get("ads").namespace(keys), full2, unpin=False)
    v2 = pub.publish()
    after = retr.roll_forward()
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not bad, bad[0]
    assert sum(done) > 0, "workers never completed a search"
    assert after == v2 == 2 and retr.version == 2
    assert retr.counters["retrieval_rolls"] == 1
    np.testing.assert_array_equal(retr.search(q, 6).scores, oracle[2][0])
    assert retr.roll_forward() == 2 and retr.counters["retrieval_rolls"] == 1
    assert retr.counters["retrieval_index_builds"] == 2


def test_retention_refs_survive_compaction_until_close(setup):
    cluster, reg, pub, keys, rows = setup
    retr = _engine(pub, retain_cluster=cluster)
    rng = np.random.default_rng(10)
    res = retr.search(_dyadic(rng, (3, DIM)), 5)
    pub.release(1)  # drop the publisher's refs; the engine's remain
    for n in cluster.nodes:
        n.ssd.compact(force=True)
    uk = rng.integers(0, N_ADS, size=(3, 4)).astype(np.uint64)
    rr = retr.rerank(res, uk, np.zeros((3, 4), np.int32), np.ones((3, 4), bool), n_slots=2)
    assert rr.valid.all()  # v1 files still readable through the pinned view
    retr.close()
    for n in cluster.nodes:
        n.ssd.compact(force=True)
    assert sum(n.ssd.n_retained_orphans for n in cluster.nodes) == 0


def test_rerank_matches_manual_rescoring_and_jax_engine(setup):
    cluster, reg, pub, keys, rows = setup
    retr, jretr = _engine(pub), _jax_engine(pub.dir)
    rng = np.random.default_rng(11)
    q = _dyadic(rng, (5, DIM))
    res, jres = retr.search(q, 10), jretr.search(q, 10)
    uk = rng.integers(0, N_ADS, size=(5, 6)).astype(np.uint64)
    so = rng.integers(-1, 5, size=(5, 6)).astype(np.int32)  # -1 and 4: dropped
    va = rng.random((5, 6)) < 0.8
    rr = retr.rerank(res, uk, so, va, n_slots=4)
    jrr = jretr.rerank(jres, uk, np.clip(so, 0, 3), va & (so >= 0) & (so < 4), n_slots=4)
    for a in ("scores", "indices", "ad_keys", "valid"):
        np.testing.assert_array_equal(getattr(rr, a), getattr(jrr, a))
    kept = (va & (so >= 0) & (so < 4)).astype(np.float32)
    user_vec = np.einsum("bn,bnd->bd", kept, rows[uk])
    final = res.scores + np.einsum("qd,qkd->qk", user_vec, rows[res.indices])
    for b in range(5):
        order = np.lexsort((res.indices[b], -final[b]))
        np.testing.assert_allclose(rr.scores[b], final[b][order], rtol=1e-6)
        np.testing.assert_array_equal(rr.indices[b], res.indices[b][order])
    assert rr.version == res.version
    assert retr.counters["retrieval_reranks"] == 1


def test_rerank_on_an_empty_corpus_keeps_the_shape_contract(tmp_path):
    spec = TableSpec("ads", RowSchema.with_adagrad(DIM))
    publish_arrays(str(tmp_path), n_nodes=1, dim=2 * DIM, init_cols=DIM,
                   tables={"ads": (spec, np.zeros(0, np.uint64), np.zeros((0, DIM), np.float32))})
    retr = RetrievalEngine(ServingEngine(ServingCluster(str(tmp_path)), device="cpu"), "ads",
                           device="cpu")
    res = retr.search(np.ones((2, DIM), np.float32), 3)
    assert (res.indices == -1).all() and np.isneginf(res.scores).all()
    rr = retr.rerank(res, np.ones((2, 4), np.uint64), np.zeros((2, 4), np.int32),
                     np.ones((2, 4), bool), n_slots=1)
    assert rr.scores.shape == (2, 3) and not rr.valid.any()


def test_lookup_at_pins_version_across_roll(setup):
    cluster, reg, pub, keys, rows = setup
    eng = ServingEngine(ServingCluster(pub.dir), cache_rows=1024, device="cpu")
    v1_view = eng.source.acquire()
    full2 = np.zeros((N_ADS, 2 * DIM), np.float32)
    full2[:, :DIM] = rows * 3.0
    cluster.push(reg.get("ads").namespace(keys), full2, unpin=False)
    pub.publish()
    eng.roll_forward()
    np.testing.assert_array_equal(eng.lookup("ads", keys[:8]), rows[:8] * 3.0)
    np.testing.assert_array_equal(eng.lookup_at("ads", keys[:8], view=v1_view), rows[:8])


def test_retrieval_counters_registered():
    for name in RETRIEVAL_COUNTER_NAMES:
        assert name in KNOWN_COUNTERS
    c = Counters(strict=True)
    c.inc("retrieval_searches")
    assert c["retrieval_searches"] == 1


# ------------------------------------------------------ the slice, end to end


def test_serving_slice_end_to_end_equals_jax(tmp_path):
    """publish -> ServingCluster -> ServingEngine -> index -> pooled user
    queries -> search k=10 and k=100 -> rerank -> lookup_device, at small
    widths: the port's results equal the JAX package's on the same
    snapshot, bitwise, and the CPU run launches no kernel."""
    cfg = CTRConfig("ctr-small", 3000, 24, 8, 6, (8,), 16, 1)
    spec = table_specs(cfg)[0]
    width = spec.schema.width
    rng = np.random.default_rng(42)
    rows = (rng.integers(-8, 8, size=(cfg.n_sparse_keys, width)) / 16.0).astype(np.float32)
    publish_arrays(str(tmp_path), n_nodes=2, dim=width, init_cols=cfg.emb_dim,
                   tables={spec.name: (spec, np.arange(cfg.n_sparse_keys, dtype=np.uint64),
                                       rows)})
    kops.reset_launch_counts()
    engine = ServingEngine(ServingCluster(str(tmp_path)), device_hot_rows=256, device="cpu")
    jengine = JServingEngine(JServingCluster(str(tmp_path)), device_hot_rows=256)
    retr = RetrievalEngine(engine, spec.name, device="cpu")
    jretr = JRetrievalEngine(jengine, spec.name, use_pallas=False)
    stream = SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots,
                                cfg.batch_size, seed=3)
    batch = stream.next_batch()
    valid = batch.valid.astype(np.float32)
    q = np.einsum("bn,bnd->bd", valid, engine.lookup(spec.name, batch.keys))
    jq = np.einsum("bn,bnd->bd", valid, jengine.lookup(spec.name, batch.keys))
    np.testing.assert_array_equal(q, jq)
    for k in (10, 100):
        res, jres = retr.search(q, k), jretr.search(jq, k)
        for a in ("scores", "indices", "ad_keys", "valid"):
            np.testing.assert_array_equal(getattr(res, a), getattr(jres, a))
        assert res.valid.all() and np.isfinite(res.scores).all()
    res, jres = retr.search(q, 10), jretr.search(jq, 10)
    rr = retr.rerank(res, batch.keys, batch.slot_of, batch.valid, n_slots=cfg.n_slots)
    jrr = jretr.rerank(jres, batch.keys, batch.slot_of, batch.valid, n_slots=cfg.n_slots)
    for a in ("scores", "indices", "ad_keys", "valid"):
        np.testing.assert_array_equal(getattr(rr, a), getattr(jrr, a))
    for _ in range(3):
        keys = stream.next_batch().keys[:4]
        slots, tbl = engine.lookup_device(spec.name, keys)
        jslots, jtbl = jengine.lookup_device(spec.name, keys)
        np.testing.assert_array_equal(slots, jslots)
        np.testing.assert_array_equal(tbl.numpy(), np.asarray(jtbl))
    assert engine.counters.snapshot() == jengine.counters.snapshot()
    assert engine.counters["device_rows_reused"] > 0
    assert set(kops.launch_counts().values()) == {0}
