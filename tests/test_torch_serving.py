"""The port's serving stack against the JAX reference, across snapshots.

The snapshot format is shared: a directory the JAX package published opens
in the port's ``ServingCluster``, and one the port published
(``convert.publish_arrays``) opens in the JAX package's. On either, the
port's ``ServingEngine`` (``device="cpu"``) must serve exactly what the
reference's serves — ``lookup``, ``lookup_at``, ``lookup_many``, hot-cache
hits, ``roll_forward`` and ``lookup_device`` with its residency counters.
Rows are random normal floats: serving moves bytes, so equality is bitwise.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.client import PSClient  # noqa: E402
from repro.core.node import Cluster as JCluster  # noqa: E402
from repro.core.tables import RowSchema as JRowSchema  # noqa: E402
from repro.core.tables import TableSpec as JTableSpec  # noqa: E402
from repro.serve import ServingCluster as JServingCluster  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import SnapshotPublisher as JSnapshotPublisher  # noqa: E402
from repro_torch.convert import publish_arrays  # noqa: E402
from repro_torch.core.hbm_ps import DeviceHotSet  # noqa: E402
from repro_torch.core.node import Cluster  # noqa: E402
from repro_torch.core.tables import RowSchema, TableRegistry, TableSpec  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ServingCluster,
    ServingEngine,
    SnapshotPublisher,
    latest_version,
)

DIM = 8
N_KEYS = 300


def _rows(seed, n=N_KEYS, width=2 * DIM):
    return np.random.default_rng(seed).normal(size=(n, width)).astype(np.float32)


def _engines(directory, **kw):
    jax_eng = JServingEngine(JServingCluster(directory), **kw)
    port_eng = ServingEngine(ServingCluster(directory), device="cpu", **kw)
    return jax_eng, port_eng


def _assert_engines_agree(jax_eng, port_eng, table, rng):
    """Drive both engines through the same requests; every output and
    every counter must be equal."""
    written = rng.choice(N_KEYS, size=(4, 9)).astype(np.uint64)
    unseen = np.arange(10_000, 10_012, dtype=np.uint64).reshape(3, 4)  # init rows
    for q in (written, unseen, written):  # the repeat hits the hot cache
        np.testing.assert_array_equal(port_eng.lookup(table, q), jax_eng.lookup(table, q))
    streams = [(table, rng.choice(N_KEYS, size=20).astype(np.uint64)) for _ in range(3)]
    for a, b in zip(port_eng.lookup_many(streams), jax_eng.lookup_many(streams)):
        np.testing.assert_array_equal(a, b)
    keys = rng.choice(N_KEYS, size=30).astype(np.uint64)
    np.testing.assert_array_equal(
        port_eng.lookup_at(table, keys, view=port_eng.source.acquire()),
        jax_eng.lookup_at(table, keys, view=jax_eng.source.acquire()),
    )
    for _ in range(6):
        q = rng.choice(64, size=(3, 5)).astype(np.uint64)  # heavy reuse
        p_slots, p_tbl = port_eng.lookup_device(table, q)
        j_slots, j_tbl = jax_eng.lookup_device(table, q)
        assert isinstance(p_tbl, torch.Tensor) and p_tbl.device.type == "cpu"
        np.testing.assert_array_equal(p_slots, j_slots)
        np.testing.assert_array_equal(p_tbl.numpy(), np.asarray(j_tbl))
    assert (dataclasses.asdict(port_eng.device_hot_stats(table))
            == dataclasses.asdict(jax_eng.device_hot_stats(table)))
    assert port_eng.counters.snapshot() == jax_eng.counters.snapshot()
    assert port_eng.counters["hot_hits"] > 0 and port_eng.counters["device_rows_reused"] > 0


def test_jax_published_snapshot_serves_identically_in_port(tmp_path):
    cluster = JCluster(2, str(tmp_path / "train"), dim=2 * DIM,
                       cache_capacity=1024, file_capacity=64, init_cols=DIM)
    client = PSClient(cluster, [JTableSpec("emb", JRowSchema.with_adagrad(DIM))])
    spec = client.registry.get("emb")
    keys = np.arange(N_KEYS, dtype=np.uint64)
    cluster.push(spec.namespace(keys), _rows(0), unpin=False)
    pub = JSnapshotPublisher(cluster, str(tmp_path / "snap"))
    pub.publish()
    jax_eng, port_eng = _engines(pub.dir, cache_rows=512, device_hot_rows=32)
    assert port_eng.version == jax_eng.version == 1
    _assert_engines_agree(jax_eng, port_eng, "emb", np.random.default_rng(1))
    # a second version, rolled forward on both
    cluster.push(spec.namespace(keys), _rows(2), unpin=False)
    assert pub.publish() == 2
    assert port_eng.roll_forward() == jax_eng.roll_forward() == 2
    _assert_engines_agree(jax_eng, port_eng, "emb", np.random.default_rng(3))
    np.testing.assert_array_equal(port_eng.lookup("emb", keys[:5]), _rows(2)[:5, :DIM])


def test_port_published_snapshot_serves_identically_in_jax(tmp_path):
    spec = TableSpec("emb", RowSchema.with_adagrad(DIM))
    keys = np.arange(N_KEYS, dtype=np.uint64)
    directory = str(tmp_path / "snap")
    v1 = publish_arrays(directory, n_nodes=2, dim=2 * DIM, init_cols=DIM,
                        tables={"emb": (spec, keys, _rows(4))})
    assert v1 == 1 and latest_version(directory) == 1
    jax_eng, port_eng = _engines(directory, cache_rows=512, device_hot_rows=32)
    for eng in (jax_eng, port_eng):
        np.testing.assert_array_equal(eng.lookup("emb", keys), _rows(4)[:, :DIM])
    _assert_engines_agree(jax_eng, port_eng, "emb", np.random.default_rng(5))
    # the next call publishes version 2 beside version 1, whose files stay
    v2 = publish_arrays(directory, n_nodes=2, dim=2 * DIM, init_cols=DIM,
                        tables={"emb": (spec, keys[:100], _rows(6, n=100))})
    assert v2 == 2
    assert port_eng.roll_forward() == jax_eng.roll_forward() == 2
    _assert_engines_agree(jax_eng, port_eng, "emb", np.random.default_rng(7))
    old = ServingEngine(ServingCluster(directory, version=1), device="cpu")
    np.testing.assert_array_equal(old.lookup("emb", keys[:10]), _rows(4)[:10, :DIM])


def test_publish_arrays_rejects_bad_tables(tmp_path):
    spec = TableSpec("emb", RowSchema.with_adagrad(DIM))
    keys = np.arange(4, dtype=np.uint64)
    with pytest.raises(ValueError, match="spec named"):
        publish_arrays(str(tmp_path), n_nodes=1, dim=2 * DIM,
                       tables={"other": (spec, keys, _rows(0, n=4))})
    with pytest.raises(ValueError, match="rows"):
        publish_arrays(str(tmp_path), n_nodes=1, dim=2 * DIM,
                       tables={"emb": (spec, keys, _rows(0, n=4, width=3 * DIM))})
    assert latest_version(str(tmp_path)) is None


def test_entry_points_default_to_cuda_and_fail_loudly_without_it(tmp_path, monkeypatch):
    spec = TableSpec("emb", RowSchema.with_adagrad(DIM))
    publish_arrays(str(tmp_path), n_nodes=1, dim=2 * DIM,
                   tables={"emb": (spec, np.arange(8, dtype=np.uint64), _rows(0, n=8))})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(ServingCluster(str(tmp_path)))
    with pytest.raises(ValueError, match="unsupported device"):
        ServingEngine(ServingCluster(str(tmp_path)), device="meta")


def test_rollover_atomic_under_concurrent_lookups(tmp_path):
    reg = TableRegistry([TableSpec("emb", RowSchema.embedding(DIM))])
    cluster = Cluster(2, str(tmp_path / "train"), dim=DIM, cache_capacity=1024,
                      file_capacity=64, tables=reg)
    pub = SnapshotPublisher(cluster, str(tmp_path / "snap"))
    keys = reg.get("emb").namespace(np.arange(N_KEYS, dtype=np.uint64))
    for marker in (1.0, 2.0):
        cluster.push(keys, np.full((N_KEYS, DIM), marker, np.float32), unpin=False)
        pub.publish()
    eng = ServingEngine(ServingCluster(pub.dir, version=1), cache_rows=512,
                        device_hot_rows=64, device="cpu")
    stop, bad, done = threading.Event(), [], []

    def worker(seed):
        rng, n = np.random.default_rng(seed), 0
        try:
            while not stop.is_set():
                q = rng.choice(N_KEYS, size=16).astype(np.uint64)
                host = np.unique(eng.lookup("emb", q))
                slots, tbl = eng.lookup_device("emb", q)
                dev = np.unique(tbl[torch.from_numpy(slots).long()].numpy())
                for vals in (host, dev):  # one request, one version
                    if len(vals) != 1 or vals[0] not in (1.0, 2.0):
                        bad.append(f"mixed versions in one request: {vals[:4]}")
                        stop.set()
                n += 1
        except Exception as e:  # a crash must fail the test, not pass it
            bad.append(f"worker raised: {e!r}")
            stop.set()
        finally:
            done.append(n)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    eng.roll_forward(2)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not bad, bad[0]
    assert sum(done) > 0
    assert eng.version == 2 and eng.counters["version_rolls"] == 1
    np.testing.assert_array_equal(eng.lookup("emb", np.arange(16, dtype=np.uint64)),
                                  np.full((16, DIM), 2.0, np.float32))


def test_device_hot_set_version_keyed_reset():
    dev = DeviceHotSet(capacity=8, row_bytes=16)
    keys = np.array([1, 2, 3], dtype=np.uint64)
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    plan = dev.plan(keys, version=1)
    assert plan.n_reused == 0
    assert torch.equal(dev.assemble_and_admit(rows, plan), rows)
    assert dev.plan(keys, version=1).n_reused == 3  # resident now
    assert dev.plan(keys, version=2).n_reused == 0  # roll resets residency


def test_device_hot_set_capacity_keeps_hottest_and_assembles_exactly():
    dev = DeviceHotSet(capacity=2, row_bytes=16)
    hot = np.array([1, 2], dtype=np.uint64)
    rows2 = torch.ones((2, 4), dtype=torch.float32)
    for _ in range(3):  # make keys 1,2 clearly hottest
        plan = dev.plan(hot, version=1)  # fresh rows: one per plan.fresh_dst
        dev.assemble_and_admit(rows2[: len(plan.fresh_dst)], plan)
    cold = np.array([3, 4], dtype=np.uint64)
    dev.assemble_and_admit(rows2 * 2, dev.plan(cold, version=1))
    assert dev.n_resident == 2
    mixed = np.array([1, 3, 5], dtype=np.uint64)
    plan = dev.plan(mixed, version=1)
    assert plan.n_reused == 1  # key 1 resident; 3 was evicted, 5 never seen
    fresh = torch.tensor([[7.0] * 4, [9.0] * 4])
    out = dev.assemble(fresh, plan)
    assert torch.equal(out, torch.tensor([[1.0] * 4, [7.0] * 4, [9.0] * 4]))
