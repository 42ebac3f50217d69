"""The port's streaming-ingestion slice against the JAX package, on the CPU.

* ``feature_extract``: the port's plain version (u64 math spelled on int64
  tensors) equals the reference's ``feature_extract_portable``, its Pallas
  kernel in interpret mode and the host oracle ``extract_host``, bitwise,
  over the reference's cases; the wrapper's refusals are pinned.
* ``DeviceIngestor(device="cpu")`` equals the JAX ``DeviceIngestor`` on the
  same raw records (keys, slot_of, valid bitwise, equal ``staging_bytes``).
* The staging ring's ownership protocol: blocking at depth, ordered and
  idempotent release, abort waking a blocked stager, ``on_drain`` release.
* The trainer with ``ingest=True``: losses within 1e-5 of the JAX ingest
  trainer from the same numpy tower; inside the port pipelined == serial ==
  host feeder bitwise, and the failure path and fault ride-through hold.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.ctr_models import TINY as J_TINY  # noqa: E402
from repro.core.node import Cluster as JCluster  # noqa: E402
from repro.data.synthetic_ctr import RawRecordBatch as JRawRecordBatch  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTRStream as JStream  # noqa: E402
from repro.ingest import DeviceIngestor as JDeviceIngestor  # noqa: E402
from repro.kernels.feature_extract import (  # noqa: E402
    feature_extract_pallas,
    feature_extract_portable,
)
from repro.train.trainer import CTRTrainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs.ctr_models import TINY  # noqa: E402
from repro_torch.convert import tower_from_numpy  # noqa: E402
from repro_torch.core.faults import NIC_STALL, NODE_KILL, FaultInjector, FaultSpec  # noqa: E402
from repro_torch.core.keys import splitmix64  # noqa: E402
from repro_torch.core.node import Cluster  # noqa: E402
from repro_torch.core.pipeline import (  # noqa: E402
    DependencyAborted,
    DependencyRegistry,
    Pipeline,
    Stage,
)
from repro_torch.data.synthetic_ctr import (  # noqa: E402
    RawRecordBatch,
    SyntheticCTRStream,
    extract_host,
    to_ctr_batch,
)
from repro_torch.ingest import DeviceIngestor, StagingRing  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.feature_extract import (  # noqa: E402
    feature_extract_cuda,
    feature_extract_plain,
    splitmix64_plain,
    umod_plain,
)
from repro_torch.metrics import KNOWN_COUNTERS  # noqa: E402
from repro_torch.train.trainer import CTRTrainer, TrainerConfig  # noqa: E402

# one framework against the other: the same math summed in another order
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
KEYS = np.arange(TINY.n_sparse_keys, dtype=np.uint64)
CLUSTER_KW = dict(dim=TINY.emb_dim * 2, cache_capacity=2048, file_capacity=128,
                  init_cols=TINY.emb_dim)
_EDGE_U64 = np.array(
    [0, 1, 2, 0xFFFFFFFF, 0x100000000, 2**63, 2**64 - 1, 0x9E3779B97F4A7C15],
    dtype=np.uint64,
)


def _rand_u64(rng, n):
    return rng.integers(0, 2**64, size=n, dtype=np.uint64)


def _i64(x):
    """u64 numpy -> the int64 tensor that carries its bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint64).view(np.int64))


def _u64(t):
    return t.numpy().view(np.uint64)


# ------------------------------------------------------- the plain u64 math


@pytest.mark.parametrize("seed", [0, 17, 31, 2**63, 2**64 - 1])
def test_splitmix64_plain_matches_numpy(seed):
    rng = np.random.default_rng(seed % 1000)
    x = np.concatenate([_EDGE_U64, _rand_u64(rng, 4096)])
    got = splitmix64_plain(_i64(x) ^ _i64(np.array([seed], dtype=np.uint64)))
    np.testing.assert_array_equal(_u64(got), splitmix64(x ^ np.uint64(seed)))


@pytest.mark.parametrize("m", [1, 2, 3, 7, 25, 128, 600_000, 2**31 - 1, 2**31, 2**31 + 1,
                               2**32 - 5, 2**32, 2**32 + 1, 10**11 + 7, 2**48 - 59,
                               2**62 + 11, 2**63 - 25, 2**63])
def test_umod_plain_matches_numpy(m):
    rng = np.random.default_rng(m % 9973)
    x = np.concatenate([_EDGE_U64, _rand_u64(rng, 4096)])
    got = umod_plain(_i64(x), m)
    assert int(got.min()) >= 0
    np.testing.assert_array_equal(_u64(got), x % np.uint64(m), err_msg=f"modulus {m}")


# ------------------------------------------------- extraction parity


def _pairs(x):
    x = np.asarray(x, dtype=np.uint64)
    return ((x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _assert_extract_parity(raw, lengths, n_keys, n_slots):
    """Port plain == extract_host == feature_extract_portable == the Pallas
    kernel in interpret mode, bitwise, on the same numpy inputs."""
    want_k, want_s, want_v = extract_host(raw, lengths, n_keys, n_slots)
    got_k, got_s = ops.feature_extract(_i64(raw), torch.from_numpy(want_v),
                                       n_keys=n_keys, n_slots=n_slots)
    assert got_k.dtype == torch.int64 and got_s.dtype == torch.int32
    np.testing.assert_array_equal(_u64(got_k), want_k)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    hi, lo = _pairs(raw)
    for fn in (
        lambda: feature_extract_portable(lo, hi, want_v, n_keys=n_keys, n_slots=n_slots),
        lambda: feature_extract_pallas(lo, hi, want_v, n_keys=n_keys, n_slots=n_slots,
                                       interpret=True),
    ):
        j_hi, j_lo, j_s = fn()
        j_k = (np.asarray(j_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(j_lo).astype(
            np.uint64)
        np.testing.assert_array_equal(_u64(got_k), j_k)
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(j_s))
    return want_k


@pytest.mark.parametrize("n_keys,n_slots", [
    (600_000, 25),  # narrow
    (2**31 + 1, 25), (2**32 - 5, 7), (2**32, 125),  # the 2^31..2^32 range
    (4096, 128),  # powers of two
    (10**11, 25), (2**36 - 5, 125),  # paper-scale wide key spaces
])
def test_feature_extract_plain_matches_the_reference_bitwise(n_keys, n_slots):
    rng = np.random.default_rng(n_keys % 1000)
    raw = np.concatenate([_EDGE_U64, _rand_u64(rng, 64 * 16 - len(_EDGE_U64))]).reshape(64, 16)
    lengths = rng.integers(0, 17, 64).astype(np.int32)
    want_k = _assert_extract_parity(raw, lengths, n_keys, n_slots)
    if n_keys > 2**32:
        assert (want_k >> np.uint64(32)).any(), "the high key bits must be live"


@pytest.mark.parametrize("B,P", [(1, 1), (3, 5), (7, 129), (64, 16), (13, 37)])
def test_feature_extract_full_rows_and_odd_shapes(B, P):
    rng = np.random.default_rng(B * P)
    _assert_extract_parity(_rand_u64(rng, B * P).reshape(B, P), None, 1000, 8)


def test_feature_extract_empty_examples_and_empty_input():
    rng = np.random.default_rng(4)
    raw = _rand_u64(rng, 8 * 4).reshape(8, 4)
    lengths = np.zeros(8, dtype=np.int32)  # every example empty
    want_k, want_s, want_v = extract_host(raw, lengths, 1000, 8)
    assert not want_v.any() and not want_k.any() and not want_s.any()
    _assert_extract_parity(raw, lengths, 1000, 8)
    k, s = ops.feature_extract(torch.zeros(0, 5, dtype=torch.int64),
                               torch.zeros(0, 5, dtype=torch.bool), n_keys=10, n_slots=3)
    assert k.shape == s.shape == (0, 5) and k.dtype == torch.int64 and s.dtype == torch.int32


def test_feature_extract_golden_values_and_float_mask():
    """The reference's pinned golden values, and a non-bool mask read as != 0."""
    raw = np.array([[0, 1, 2**63, 2**64 - 1, 123456789]], dtype=np.uint64)
    k, s = ops.feature_extract(_i64(raw), torch.tensor([[1.0, 2.0, 1.0, 0.5, 3.0]]),
                               n_keys=600_000, n_slots=25)
    assert _u64(k).tolist() == [[41379, 321095, 501017, 21531, 431833]]
    assert s.tolist() == [[21, 23, 10, 17, 22]]
    assert feature_extract_cuda.launches == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("kw,match", [
    (dict(n_keys=0), "n_keys"), (dict(n_keys=2**63 + 1), "n_keys"),
    (dict(n_slots=0), "n_slots"), (dict(n_slots=2**31), "n_slots"),
    (dict(key_seed=-1), "key_seed"), (dict(slot_seed=2**64), "slot_seed"),
    (dict(raw_dtype=torch.int32), "int64"), (dict(valid_shape=(4, 3)), "valid"),
])
def test_feature_extract_refuses_what_it_does_not_take(kw, match):
    args = dict(n_keys=1000, n_slots=8, key_seed=17, slot_seed=31)
    args.update({k: v for k, v in kw.items() if k in args})
    raw = torch.zeros(4, 5, dtype=kw.get("raw_dtype", torch.int64))
    valid = torch.ones(kw.get("valid_shape", (4, 5)), dtype=torch.bool)
    with pytest.raises(ValueError, match=match):
        ops.feature_extract(raw, valid, **args)
    with pytest.raises(ValueError, match=match):
        feature_extract_plain(raw, valid, **args)


def test_feature_extract_cuda_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        feature_extract_cuda(torch.zeros(2, 2, dtype=torch.int64),
                             torch.ones(2, 2, dtype=torch.bool), n_keys=10, n_slots=3,
                             key_seed=17, slot_seed=31)


# --------------------------------------------------------- the ingestor


def _raw_pair(seed, batch, width):
    """One raw record batch ``width`` ids wide, as the port's and the
    reference's dataclass (the stream draws at least the pack width; a
    narrower reader row is cut from it)."""
    cfg = TINY
    r = next(SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots, batch,
                                seed=seed).raw_records(max_nnz=max(width, cfg.nnz_per_example)))
    r = RawRecordBatch(np.ascontiguousarray(r.raw_ids[:, :width]),
                       np.minimum(r.lengths, width).astype(np.int32), r.labels, r.batch_id)
    return r, JRawRecordBatch(r.raw_ids.copy(), r.lengths.copy(), r.labels.copy(), r.batch_id)


@pytest.mark.parametrize("width", [TINY.nnz_per_example + 8, TINY.nnz_per_example - 5])
def test_ingestor_matches_the_jax_ingestor_bitwise(width):
    """Wider reader rows truncate, narrower ones pad; both ingestors give
    the same planes and count the same staging bytes."""
    cfg = TINY
    kw = dict(n_keys=cfg.n_sparse_keys, n_slots=cfg.n_slots, pack_width=cfg.nnz_per_example)
    port, ref = DeviceIngestor(device="cpu", **kw), JDeviceIngestor(**kw)
    for seed in (2, 3):
        raw, jraw = _raw_pair(seed, 32, width)
        got, want = port.ingest(raw), ref.ingest(jraw)
        np.testing.assert_array_equal(got.keys, np.asarray(want.keys))
        assert got.keys.dtype == np.uint64
        np.testing.assert_array_equal(got.slot_of.numpy(), np.asarray(want.slot_of))
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
        pad = max(0, cfg.nnz_per_example - raw.raw_ids.shape[1])  # the host feeder does not pad
        want_k, _, _ = extract_host(np.pad(raw.raw_ids, ((0, 0), (0, pad))), raw.lengths,
                                    cfg.n_sparse_keys, cfg.n_slots, cfg.nnz_per_example)
        np.testing.assert_array_equal(got.keys, want_k)
        port.release(got)
        ref.release(want)
    for name in ("staging_bytes", "ingest_batches", "ingest_examples"):
        assert port.counters[name] == ref.counters[name] > 0, name
    assert port.ring.live_slots == 0


def test_ingestor_reset_frees_the_ring_as_the_reference_does():
    """A reset with a staged batch in flight leaves both rings empty and at
    sequence 0, and the next run stages from slot 0 on again, to the same
    planes."""
    cfg = TINY
    kw = dict(n_keys=cfg.n_sparse_keys, n_slots=cfg.n_slots, pack_width=cfg.nnz_per_example,
              depth=1)
    port, ref = DeviceIngestor(device="cpu", **kw), JDeviceIngestor(**kw)
    raw, jraw = _raw_pair(4, 16, cfg.nnz_per_example)
    in_flight = port.ingest(raw), ref.ingest(jraw)  # staged, never released
    assert (port.ring.live_slots, port.ring.staged_total) == (ref.ring.live_slots,
                                                              ref.ring.staged_total) == (1, 1)
    port.reset()
    ref.reset()
    state = lambda ing: (ing.ring.live_slots, ing.ring.staged_total)
    assert state(port) == state(ref) == (0, 0)
    got, want = port.ingest(raw), ref.ingest(jraw)  # depth 1: blocks unless slot 0 is free
    assert got.staged.seq == want.staged.seq == 0
    assert state(port) == state(ref) == (1, 1)
    np.testing.assert_array_equal(got.keys, np.asarray(want.keys))
    np.testing.assert_array_equal(got.keys, in_flight[0].keys)
    np.testing.assert_array_equal(got.slot_of.numpy(), np.asarray(want.slot_of))
    for name in ("staging_bytes", "ingest_batches", "ingest_examples"):
        assert port.counters[name] == ref.counters[name] > 0, name


def test_ingestor_pads_narrow_reader_rows():
    ing = DeviceIngestor(n_keys=1000, n_slots=8, pack_width=6, device="cpu")
    raw = RawRecordBatch(
        raw_ids=np.arange(8, dtype=np.uint64).reshape(2, 4),  # L=4 < P=6
        lengths=np.array([4, 2], dtype=np.int32),
        labels=np.zeros(2, dtype=np.float32),
        batch_id=0,
    )
    got = ing.ingest(raw)
    want_k, want_s, want_v = extract_host(
        np.pad(raw.raw_ids, ((0, 0), (0, 2))), raw.lengths, 1000, 8
    )
    np.testing.assert_array_equal(got.keys, want_k)
    np.testing.assert_array_equal(got.slot_of.numpy(), want_s)
    np.testing.assert_array_equal(got.valid.numpy(), want_v)


# ------------------------------------------------------------- staging ring


def test_staging_ring_blocks_at_depth_and_releases_in_order():
    deps = DependencyRegistry()
    ring = StagingRing(depth=2, deps=deps, device="cpu")
    host = {"x": np.zeros(4, dtype=np.float32)}
    s0 = ring.stage(0, host)
    s1 = ring.stage(1, host)
    assert ring.live_slots == 2
    assert isinstance(s0.tensors["x"], torch.Tensor)

    staged3 = []

    def third():
        staged3.append(ring.stage(2, host))

    t = threading.Thread(target=third, daemon=True)
    t.start()
    time.sleep(0.15)
    assert not staged3, "third stage must block until slot 0 frees"
    ring.release(s0)
    t.join(timeout=5.0)
    assert not t.is_alive() and staged3[0].seq == 2
    ring.release(s1)
    ring.release(staged3[0])
    ring.release(staged3[0])  # idempotent
    assert ring.live_slots == 0
    assert ring.counters["ingest_batches"] == 3


def test_staging_ring_copies_its_planes():
    ring = StagingRing(depth=1, device="cpu")
    host = np.arange(4, dtype=np.int64)
    staged = ring.stage(0, {"x": host})
    host[:] = -1
    assert staged.tensors["x"].tolist() == [0, 1, 2, 3]


def test_staging_ring_abort_wakes_blocked_stager():
    deps = DependencyRegistry()
    ring = StagingRing(depth=1, deps=deps, device="cpu")
    ring.stage(0, {"x": np.zeros(2, dtype=np.float32)})
    err = []

    def second():
        try:
            ring.stage(1, {"x": np.zeros(2, dtype=np.float32)})
        except DependencyAborted as e:
            err.append(e)

    t = threading.Thread(target=second, daemon=True)
    t.start()
    time.sleep(0.1)
    deps.abort()
    t.join(timeout=5.0)
    assert not t.is_alive() and err, "abort must wake the blocked stage()"


def test_pipeline_on_drain_releases_unconsumed_outputs():
    """A mid-pipeline failure drains queued stage outputs through the
    producer's on_drain hook (and hook errors are collected, not raised)."""
    deps = DependencyRegistry()
    ring = StagingRing(depth=8, deps=deps, device="cpu")
    released = []

    def boom(item):
        raise RuntimeError("consumer died")

    pipe = Pipeline(
        [
            Stage("stage", lambda i: ring.stage(i, {"x": np.zeros(2, dtype=np.float32)}),
                  capacity=4,
                  on_drain=lambda s: (released.append(s.seq), ring.drain_release(s))),
            Stage("boom", boom, capacity=4, max_retries=0),
        ],
        deps=deps,
    )
    with pytest.raises(Exception):
        for _ in pipe.run(range(6)):
            pass
    # every slot frees except the one the failing consumer had already
    # dequeued — that in-flight item is the trainer's ring.reset() job
    assert ring.live_slots == 1
    assert len(released) == ring.staged_total - 1 and released
    assert ring.counters["ingest_drained"] == len(released)
    assert not pipe.drain_errors


def test_ingest_counters_registered():
    for name in ("ingest_batches", "ingest_examples", "staging_bytes",
                 "ingest_wait_us", "ingest_overlap_us", "ingest_drained"):
        assert name in KNOWN_COUNTERS


# ------------------------------------------------------ trainer integration


def _cluster(tmp_path, tag):
    return Cluster(2, str(tmp_path / tag), **CLUSTER_KW)


def _raw_stream(seed=3, cls=SyntheticCTRStream):
    cfg = TINY
    return cls(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots, cfg.batch_size,
               seed=seed).raw_records()


def _host_arm(seed=3):
    cfg = TINY
    return (to_ctr_batch(r, cfg.n_sparse_keys, cfg.n_slots, cfg.nnz_per_example)
            for r in _raw_stream(seed))


def _ingest_trainer(tmp_path, tag, **kw):
    cl = _cluster(tmp_path, tag)
    return CTRTrainer(TINY, cl, TrainerConfig(ingest=True, **kw), device="cpu"), cl


def _numpy_tower(seed=0):
    from repro_torch.models import ctr as ctr_model

    rng = np.random.default_rng(seed)
    return {
        name: (rng.normal(size=shape) / np.sqrt(shape[0]) if init == "normal"
               else np.zeros(shape)).astype(np.float32)
        for name, (shape, init) in ctr_model.tower_schema(TINY).items()
    }


def test_ingest_trainer_tracks_the_jax_ingest_trainer(tmp_path):
    """Six ingested batches of the same raw records from the same tower:
    per-batch losses and every flushed row within the stated tolerance of
    the reference's ingest trainer, and the same ingest counters."""
    tower = _numpy_tower(0)
    jcl = JCluster(2, str(tmp_path / "jax"), **CLUSTER_KW)
    jt = JTrainer(J_TINY, jcl, JTrainerConfig(ingest=True))
    jt.tower = {k: jax.numpy.asarray(v) for k, v in tower.items()}
    want = [r["loss"] for r in jt.run(_raw_stream(cls=JStream), 6)]
    tr, cl = _ingest_trainer(tmp_path, "port")
    tr.tower = tower_from_numpy(tower, "cpu")
    got = [r["loss"] for r in tr.run(_raw_stream(), 6)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jcl.flush_all()
    cl.flush_all()
    # rows: Adagrad's step lr*g/(sqrt(a)+eps) magnifies the last bits of a
    # gradient near zero (one element of 8,000 moved by 2.2e-6 here), so
    # rows are held within 1e-5 absolute
    np.testing.assert_allclose(cl.pull(KEYS, pin=False), jcl.pull(KEYS, pin=False),
                               rtol=1e-5, atol=1e-5)
    for name in ("ingest_batches", "ingest_examples", "staging_bytes"):
        assert tr.ingestor.counters[name] == jt.ingestor.counters[name] > 0, name


def test_ingest_pipelined_equals_serial_equals_host_feeder_bitwise(tmp_path):
    """The ingest pipeline's losses and flushed rows are bitwise equal to
    the host numpy feeder on the same raw records — pipelined and serial."""
    ops.reset_launch_counts()
    runs = {}
    for tag, ingest, pipelined in (("host", False, True), ("ingest", True, True),
                                   ("serial", True, False)):
        cl = _cluster(tmp_path, tag)
        tr = CTRTrainer(TINY, cl, TrainerConfig(ingest=ingest), device="cpu")
        src = _raw_stream() if ingest else _host_arm()
        losses = [r["loss"] for r in tr.run(src, 8, pipelined=pipelined)]
        cl.flush_all()
        runs[tag] = losses, cl.pull(KEYS, pin=False), tr
    for tag in ("ingest", "serial"):
        assert runs[tag][0] == runs["host"][0], tag
        np.testing.assert_array_equal(runs[tag][1], runs["host"][1])
        c = runs[tag][2].ingestor.counters
        assert c["ingest_batches"] == 8 and c["ingest_examples"] == 8 * TINY.batch_size
        assert c["staging_bytes"] > 0
        assert runs[tag][2].ingestor.ring.live_slots == 0, "run end must leave no slot live"
    assert runs["host"][2].ingestor is None
    assert "ingest" in runs["ingest"][2].last_pipeline.report()
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors: plain versions only


def test_ingest_failure_path_frees_slots(tmp_path):
    tr, cl = _ingest_trainer(tmp_path, "die")  # no ride-through
    FaultInjector([FaultSpec(NODE_KILL, at_op=20, node_id=0)]).arm(cl)
    with pytest.raises(Exception):
        tr.run(_raw_stream(), 10)
    assert tr.ingestor.ring.live_slots == 0
    assert cl.total_pins() == 0


def test_ingest_rides_through_nic_stall_in_staging(tmp_path):
    """A NIC stall on the very first transfer — with ingest on, the staging
    host->device copy — only slows the run; it does not change it."""
    tr_c, _ = _ingest_trainer(tmp_path, "calm")
    want = [r["loss"] for r in tr_c.run(_raw_stream(), 6)]
    tr, cl = _ingest_trainer(tmp_path, "stall", ride_through=True)
    inj = FaultInjector([FaultSpec(NIC_STALL, at_op=1, stall_s=0.2)]).arm(cl)
    got = [r["loss"] for r in tr.run(_raw_stream(), 6)]
    inj.disarm()
    assert inj.all_fired() and cl.network.stalls >= 1
    assert got == want


def test_ingest_rides_through_node_kill_bitwise(tmp_path):
    tr_c, cl_c = _ingest_trainer(tmp_path, "clean")
    want = [r["loss"] for r in tr_c.run(_raw_stream(), 10)]
    cl_c.flush_all()
    tr, cl = _ingest_trainer(tmp_path, "chaos", ride_through=True)
    inj = FaultInjector([FaultSpec(NODE_KILL, at_op=40, node_id=1)]).arm(cl)
    got = [r["loss"] for r in tr.run(_raw_stream(), 10)]
    inj.disarm()
    assert inj.all_fired()
    assert cl.fault_counters["node_recoveries"] >= 1
    np.testing.assert_array_equal(got, want)
    cl.flush_all()
    np.testing.assert_array_equal(cl.pull(KEYS, pin=False), cl_c.pull(KEYS, pin=False))
    assert tr.ingestor.ring.live_slots == 0
    assert cl.total_pins() == 0 and tr.ps.n_inflight() == 0
