"""The port's threaded paths under its SanLock, in a fresh interpreter.

``REPRO_TORCH_SANLOCK=1 python -m pytest -p repro_torch.analysis.pytest_plugin``
runs three threaded paths of the port at TINY sizes on the CPU: the
pipelined ``CTRTrainer`` with streaming ingest, concurrent
``ServingEngine.lookup`` threads beside ``lookup_device``, and
``RetrievalEngine.roll_forward`` during searches. The plugin fails a test on
a lock-acquisition cycle or residual MEM-PS pins; this test also requires
that the locks of those paths' classes were wrapped (a sanitizer that wraps
nothing would pass the first two checks) and that acquisitions nested, so
the graph the cycle check reads is not empty.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

PATHS = textwrap.dedent('''
    import json
    import os
    import threading

    import numpy as np
    import torch

    from repro_torch.analysis import sanlock
    from repro_torch.configs.ctr_models import TINY
    from repro_torch.convert import publish_arrays
    from repro_torch.core.node import Cluster
    from repro_torch.core.tables import RowSchema, TableSpec
    from repro_torch.data.synthetic_ctr import SyntheticCTRStream
    from repro_torch.retrieval import RetrievalEngine
    from repro_torch.serve import ServingCluster, ServingEngine, SnapshotPublisher
    from repro_torch.train.trainer import CTRTrainer, TrainerConfig


    def _stream(seed):
        return SyntheticCTRStream(TINY.n_sparse_keys, TINY.nnz_per_example, TINY.n_slots,
                                  TINY.batch_size, seed=seed)


    def _cluster(tmp_path):
        return Cluster(2, str(tmp_path / "ps"), dim=2 * TINY.emb_dim, cache_capacity=2048,
                       file_capacity=128, init_cols=TINY.emb_dim)


    def _join(threads, bad, done):
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not bad, bad[0]
        assert sum(done) > 0


    def test_pipelined_trainer_with_ingest(tmp_path):
        tr = CTRTrainer(TINY, _cluster(tmp_path), TrainerConfig(ingest=True), device="cpu")
        res = tr.run(_stream(1).raw_records(), 4)
        assert len(res) == 4 and tr.ingestor.ring.live_slots == 0


    def test_concurrent_lookups_beside_lookup_device(tmp_path):
        spec = TableSpec("emb", RowSchema.embedding(8))
        rows = np.random.default_rng(0).standard_normal((500, 8), dtype=np.float32)
        publish_arrays(str(tmp_path), n_nodes=2, dim=8,
                       tables={"emb": (spec, np.arange(500, dtype=np.uint64), rows)})
        eng = ServingEngine(ServingCluster(str(tmp_path)), cache_rows=128,
                            device_hot_rows=64, device="cpu")
        stop, bad, done = threading.Event(), [], []

        def worker(seed):
            rng, n = np.random.default_rng(seed), 0
            try:
                while not stop.is_set() and n < 40:
                    q = rng.choice(500, size=24).astype(np.uint64)
                    if n % 2:
                        slots, tbl = eng.lookup_device("emb", q)
                        got = tbl[torch.from_numpy(slots).long()].numpy()
                    else:
                        got = eng.lookup("emb", q)
                    if not np.array_equal(got, rows[q.astype(np.int64)]):
                        bad.append("a lookup returned other rows")
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
        _join(threads, bad, done)


    def test_roll_forward_during_searches(tmp_path):
        cluster = _cluster(tmp_path)
        tr = CTRTrainer(TINY, cluster, TrainerConfig(), device="cpu")
        stream = _stream(3)
        tr.run(iter(stream), 2)
        pub = SnapshotPublisher(cluster, str(tmp_path / "snap"))
        pub.publish()
        eng = tr.client.serving_view(snapshots=pub, cache_rows=1024, device="cpu")
        retr = RetrievalEngine(eng, tr.table, retain_cluster=cluster, device="cpu")
        q = np.random.default_rng(9).standard_normal((4, TINY.emb_dim)).astype(np.float32)
        stop, bad, done = threading.Event(), [], []

        def worker():
            n = 0
            try:
                while not stop.is_set():
                    res = retr.search(q, 5)
                    if res.version not in (1, 2) or not np.isfinite(res.scores).all():
                        bad.append(f"search returned version {res.version}")
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
        tr.run(iter(stream), 2)
        pub.publish()
        after = retr.roll_forward()
        stop.set()
        _join(threads, bad, done)
        assert after == 2 and retr.version == 2
        retr.close()


    def test_zz_report():
        with open(os.environ["SANLOCK_REPORT"], "w") as f:
            json.dump({"installed": sanlock.enabled(), "wrapped": sanlock.wrapped(),
                       "edges": len(sanlock.edges()), "cycle": sanlock.find_cycle()}, f)
''')

# every lock the three paths' classes own, and the one the port allocates
# at import (wrapped only if the plugin installed before collection)
WANT_WRAPPED = {
    "StagingRing._lock", "HierarchicalPS._lock", "HierarchicalPS._push_lock",
    "MemParameterServer._lock", "SSDParameterServer._lock", "Counters._lock",
    "ServingEngine._mu", "ServingEngine._cache_mu", "ServingEngine._dev_mu",
    "ServingCluster._lock", "SnapshotPublisher._lock", "RetrievalEngine._lock",
    "kernels/build.py:_lock",
}


def test_threaded_paths_under_the_port_sanlock(tmp_path):
    test_file = tmp_path / "test_port_paths.py"
    test_file.write_text(PATHS)
    report = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_SANLOCK="1",
               SANLOCK_REPORT=str(report), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "repro_torch.analysis.pytest_plugin",
         "-p", "no:cacheprovider", "--noconftest", "--rootdir", str(tmp_path), str(test_file)],
        capture_output=True, text=True, env=env, timeout=240, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "4 passed" in out.stdout, out.stdout[-2000:]
    got = json.loads(report.read_text())
    assert got["installed"] and got["cycle"] is None
    assert WANT_WRAPPED <= set(got["wrapped"]), sorted(WANT_WRAPPED - set(got["wrapped"]))
    assert got["edges"] > 0, "no wrapped lock was ever taken under another"


def test_plugin_fails_a_test_on_a_cycle_and_on_residual_pins(tmp_path):
    """The plugin's two teardown checks fire: a reversed acquisition order of
    two port-allocated locks, and a cluster left holding pins (the marked
    twin passes)."""
    test_file = tmp_path / "test_faults.py"
    test_file.write_text(textwrap.dedent('''
        import numpy as np
        import pytest

        from repro_torch.core.node import Cluster
        from repro_torch.metrics import Counters


        def _pinned(tmp_path):
            cl = Cluster(1, str(tmp_path / "ps"), dim=8, cache_capacity=64,
                         file_capacity=32, init_cols=4)
            cl.pull(np.arange(3, dtype=np.uint64), pin=True)
            return cl


        def test_leaks_pins(tmp_path):
            cl = _pinned(tmp_path)
            assert cl.total_pins() == 3


        @pytest.mark.pscheck_allow_pins
        def test_leaks_pins_allowed(tmp_path):
            cl = _pinned(tmp_path)
            assert cl.total_pins() == 3


        def test_lock_order_cycle():
            a, b = Counters(), Counters()
            with a._lock:
                with b._lock:
                    pass
            with b._lock:
                with a._lock:
                    pass
    '''))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_SANLOCK="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "repro_torch.analysis.pytest_plugin",
         "-p", "no:cacheprovider", "--noconftest", "--rootdir", str(tmp_path), "-rE",
         str(test_file)],
        capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path)
    text = out.stdout
    assert out.returncode == 1, text[-3000:]
    assert "ERROR at teardown of test_lock_order_cycle" in text, text[-3000:]
    assert "lock-acquisition cycle" in text and "metrics.py" in text, text[-3000:]
    assert "ERROR at teardown of test_leaks_pins " in text + " ", text[-3000:]
    assert "residual MEM-PS pins" in text, text[-3000:]
    assert "test_leaks_pins_allowed" not in [
        ln.split("::")[-1].split()[0] for ln in text.splitlines() if ln.startswith("ERROR")]
