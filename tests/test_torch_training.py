"""The port's CTR training slice against the JAX package, on the CPU.

Both sides start from the same numpy inputs: the working table, the
mini-batches, the stream and the tower come from numpy seeds, and each
side gets the tower in its own form (``convert.tower_from_numpy`` for the
port; torch's generator cannot reproduce ``jax.random``). The tower is
drawn with numpy rather than by the reference's ``init_tower``, whose
``fold_in(hash(name))`` changes with Python's per-process string hash.
Across the two frameworks the results agree within a stated tolerance —
the tower's matmuls and reductions sum in another order. Adagrad's step
lr*g/(sqrt(a)+eps) magnifies those last bits wherever a row's gradient
lies near zero, so the tolerance holds for the seeded tower used here
(max row difference 2.4e-7), not for every tower (another seed moved a
few rows by 1.5e-5). Inside the port pipelined == serial, ride-through ==
fault-free and resume == uninterrupted hold bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.ctr_models import TINY as J_TINY  # noqa: E402
from repro.core.node import Cluster as JCluster  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTRStream as JStream  # noqa: E402
from repro.train.optim import AdamW as JAdamW  # noqa: E402
from repro.train.train_step import make_ctr_train_step as j_make_step  # noqa: E402
from repro.train.trainer import CTRTrainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs.ctr_models import TINY  # noqa: E402
from repro_torch.convert import adam_state_from_numpy, tower_from_numpy  # noqa: E402
from repro_torch.core.faults import NODE_KILL, FaultInjector, FaultSpec  # noqa: E402
from repro_torch.core.node import Cluster  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTRStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ctr as ctr_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optim import AdamW  # noqa: E402
from repro_torch.train.train_step import make_ctr_train_step  # noqa: E402
from repro_torch.train.trainer import CTRTrainer, TrainerConfig  # noqa: E402

# one framework against the other: the same math summed in another order
LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
KEYS = np.arange(TINY.n_sparse_keys, dtype=np.uint64)
CLUSTER_KW = dict(dim=TINY.emb_dim * 2, cache_capacity=2048, file_capacity=128,
                  init_cols=TINY.emb_dim)


def _stream(seed=5, cls=SyntheticCTRStream):
    return cls(TINY.n_sparse_keys, TINY.nnz_per_example, TINY.n_slots, TINY.batch_size, seed=seed)


def _numpy_tower(seed=0):
    """The tower both trainers start from: normal x 1/sqrt(fan_in), zero
    biases, from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {
        name: (rng.normal(size=shape) / np.sqrt(shape[0]) if init == "normal"
               else np.zeros(shape)).astype(np.float32)
        for name, (shape, init) in ctr_model.tower_schema(TINY).items()
    }


def _trainer(tmp_path, tag, tcfg=None, tower=None, file_capacity=128):
    cl = Cluster(2, str(tmp_path / tag), **{**CLUSTER_KW, "file_capacity": file_capacity})
    tr = CTRTrainer(TINY, cl, tcfg or TrainerConfig(), device="cpu")
    if tower is not None:
        tr.tower = tower_from_numpy(tower, "cpu")
    return tr, cl


def _flushed(cl):
    cl.flush_all()
    return cl.pull(KEYS, pin=False)


# ------------------------------------------------------------- the model


def test_tower_schema_and_init_match_the_reference_shapes():
    from repro.models import ctr as j_ctr

    tower = ctr_model.init_tower(TINY, torch.Generator().manual_seed(0))
    ref = {k: np.asarray(v) for k, v in j_ctr.init_tower(J_TINY, jax.random.PRNGKey(0)).items()}
    assert sorted(tower) == sorted(ref) == sorted(ctr_model.tower_schema(TINY))
    for k, v in tower.items():
        assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float32
        if k.startswith("b"):
            assert not v.any()
        else:  # normal x 1/sqrt(fan_in)
            assert 0.5 < float(v.std()) * np.sqrt(v.shape[0]) < 1.5
    again = ctr_model.init_tower(TINY, torch.Generator().manual_seed(0))
    assert all(torch.equal(tower[k], again[k]) for k in tower)
    assert sorted(j_ctr.tower_schema(J_TINY)) == sorted(tower)


def _minibatches(seed, n_working, k=2, mb=32):
    rng = np.random.default_rng(seed)
    nnz = TINY.nnz_per_example
    return {
        "slot_ids": rng.integers(0, n_working, (k, mb, nnz)).astype(np.int32),
        "slot_of": rng.integers(0, TINY.n_slots, (k, mb, nnz)).astype(np.int32),
        "valid": rng.random((k, mb, nnz)) < 0.8,
        "labels": (rng.random((k, mb)) < 0.3).astype(np.float32),
    }


def test_one_train_step_matches_the_jax_step():
    """One batch of k=2 mini-batches through ``make_ctr_train_step`` from the
    same tower, table and accumulator: loss, table, accumulator and tower
    agree within the stated tolerance."""
    rng = np.random.default_rng(3)
    n_working = 300
    table = (rng.normal(size=(n_working, TINY.emb_dim)) * 0.1).astype(np.float32)
    accum = np.abs(rng.normal(size=(n_working, TINY.emb_dim))).astype(np.float32)
    mbs = _minibatches(4, n_working)
    tower = _numpy_tower(1)

    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(j_make_step(J_TINY, 0.05, jopt))
    jt, jst, jtab, jacc, jm = jstep(tower, jopt.init(tower), table, accum, mbs)

    opt = AdamW(lr=1e-3)
    ptower = tower_from_numpy(tower, "cpu")
    pstate = adam_state_from_numpy(jax.tree.map(np.asarray, jopt.init(tower)), "cpu")
    step = make_ctr_train_step(TINY, 0.05, opt)
    minibatches = {k: torch.from_numpy(v) for k, v in mbs.items()}
    t_in, a_in = torch.from_numpy(table.copy()), torch.from_numpy(accum.copy())
    pt, pst, ptab, pacc, pm = step(ptower, pstate, t_in, a_in, minibatches)

    assert np.array_equal(t_in.numpy(), table) and np.array_equal(a_in.numpy(), accum)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(ptab.numpy(), np.asarray(jtab), rtol=PARAM_RTOL, atol=PARAM_ATOL)
    np.testing.assert_allclose(pacc.numpy(), np.asarray(jacc), rtol=PARAM_RTOL, atol=PARAM_ATOL)
    assert int(pst.step) == int(jst.step) == 2
    for k in tower:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(jt[k]), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
        np.testing.assert_allclose(pst.m[k].numpy(), np.asarray(jst.m[k]), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL)
    assert not np.array_equal(ptab.numpy(), table)  # the rows really trained


# ------------------------------------------------------------- the trainer


def test_trainer_tracks_the_jax_trainer(tmp_path):
    """Six batches of the same stream from the same tower and the same
    initial rows: per-batch losses and every flushed row within the stated
    tolerance of the reference trainer."""
    tower = _numpy_tower(0)
    jcl = JCluster(2, str(tmp_path / "jax"), **CLUSTER_KW)
    jt = JTrainer(J_TINY, jcl, JTrainerConfig())
    jt.tower = {k: jax.numpy.asarray(v) for k, v in tower.items()}
    want = [r["loss"] for r in jt.run(_stream(cls=JStream), 6)]
    tr, cl = _trainer(tmp_path, "port", tower=tower)
    got = [r["loss"] for r in tr.run(_stream(), 6)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    jcl.flush_all()
    rows, want_rows = _flushed(cl), jcl.pull(KEYS, pin=False)
    np.testing.assert_allclose(rows, want_rows, rtol=PARAM_RTOL, atol=PARAM_ATOL)
    fresh = Cluster(2, str(tmp_path / "fresh"), **CLUSTER_KW).pull(KEYS, pin=False)
    assert np.abs(rows - fresh).max() > 1e-3  # training moved the rows
    for k in tower:
        np.testing.assert_allclose(tr.tower[k].numpy(), np.asarray(jt.tower[k]),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL)


def _run_full(tmp_path, tag, pipelined, n=8):
    tr, cl = _trainer(tmp_path, tag)
    losses = [r["loss"] for r in tr.run(_stream(), n, pipelined=pipelined)]
    return losses, _flushed(cl), tr, cl


def test_pipeline_is_lossless_bitwise(tmp_path):
    """The paper's lossless-pipeline claim inside the port: overlapping
    pull(i+1) with train(i) leaves the losses and every flushed row
    bitwise equal to serial execution."""
    ops.reset_launch_counts()
    p_loss, p_rows, p_tr, p_cl = _run_full(tmp_path, "p", True)
    s_loss, s_rows, s_tr, _ = _run_full(tmp_path, "s", False)
    np.testing.assert_array_equal(p_loss, s_loss)
    np.testing.assert_array_equal(p_rows, s_rows)
    assert all(np.isfinite(p_loss))
    assert p_tr.ps.stats.conflict_rows > 0  # the conflict path really ran
    assert s_tr.ps.stats.rows_forwarded == 0
    assert p_tr.dev_ws.stats.rows_reused > 0
    assert p_cl.total_pins() == 0 and p_tr.ps.n_inflight() == 0
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors: plain versions only


def test_ride_through_node_kill_is_bitwise(tmp_path):
    """Kill an owner mid-pipeline: the trainer recovers the node, replays
    the untrained suffix and resumes — losses and flushed rows bitwise
    equal to a fault-free run."""
    clean, clean_cl = _trainer(tmp_path, "clean")
    want = [r["loss"] for r in clean.run(_stream(), 10)]
    want_rows = _flushed(clean_cl)
    tr, cl = _trainer(tmp_path, "chaos", TrainerConfig(ride_through=True))
    inj = FaultInjector([FaultSpec(NODE_KILL, at_op=40, node_id=1)]).arm(cl)
    got = [r["loss"] for r in tr.run(_stream(), 10)]
    inj.disarm()
    assert inj.all_fired() and tr.recovery_time_s > 0.0
    assert cl.fault_counters["node_recoveries"] >= 1
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_flushed(cl), want_rows)
    assert cl.total_pins() == 0 and tr.ps.n_inflight() == 0


def test_checkpoint_resume_continues_identically(tmp_path):
    """Checkpoint after 4 batches, "crash", restore into a fresh trainer and
    train 4 more: the tower and the losses of batches 5-8 equal those of an
    uninterrupted 8-batch run, bitwise."""
    ref, _ = _trainer(tmp_path, "ref", file_capacity=64)
    want = [r["loss"] for r in ref.run(_stream(seed=3), 8)]

    tcfg = TrainerConfig(checkpoint_every=4, checkpoint_dir=str(tmp_path / "ck"))
    tr, _ = _trainer(tmp_path, "ps", tcfg, file_capacity=64)
    stream = _stream(seed=3)
    first = [r["loss"] for r in tr.run(stream, 4)]
    tower_before = {k: v.clone() for k, v in tr.tower.items()}
    del tr  # "crash"

    tr2, _ = _trainer(tmp_path, "ps", tcfg, file_capacity=64)
    assert tr2.resume() == 4 and ckpt.latest_step(str(tmp_path / "ck")) == 4
    assert all(torch.equal(tr2.tower[k], tower_before[k]) for k in tower_before)
    assert int(tr2.opt_state.step) == 8  # k = 2 mini-batches per batch
    more = [r["loss"] for r in tr2.run(stream, 4)]
    np.testing.assert_array_equal(first + more, want)


def test_trainer_defaults_to_the_card_and_refuses_ingest(tmp_path):
    cl = Cluster(2, str(tmp_path / "d"), **CLUSTER_KW)
    with pytest.raises(NotImplementedError, match="slice 3"):
        CTRTrainer(TINY, cl, TrainerConfig(ingest=True), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CTRTrainer(TINY, cl)
