"""The rest of the port's CTR side against the JAX package, on the CPU.

* Heterogeneous slot groups (``TINY_HETERO``: a width-4 "query" group and a
  width-8 "ad" group, each its own named PS table): ``forward_grouped`` and
  ``make_ctr_train_step_grouped`` against the reference's, and grouped
  training through ``PSClient`` sessions on one shared cluster, side by
  side with the reference.
* The LR baseline (``lr_forward`` / ``lr_loss_fn``, the bag at width 1).
* The numpy-only copies ``core/hashing.py`` (OP+OSRP) and
  ``core/elastic.py`` (reshard), driven through the port.

Inputs come from numpy seeds and reach both sides as numpy arrays; the
tower is drawn with numpy and converted for each side. Across the two
frameworks results agree within 1e-5 (the same math summed in another
order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ctr_models import TINY_HETERO as J_HETERO  # noqa: E402
from repro.configs.ctr_models import table_specs as j_table_specs  # noqa: E402
from repro.core.client import PSClient as JPSClient  # noqa: E402
from repro.core.hashing import OPOSRP as JOPOSRP  # noqa: E402
from repro.core.node import Cluster as JCluster  # noqa: E402
from repro.data.synthetic_ctr import SyntheticCTRStream as JStream  # noqa: E402
from repro.models import ctr as j_ctr  # noqa: E402
from repro.train.optim import AdamW as JAdamW  # noqa: E402
from repro.train.train_step import make_ctr_train_step_grouped as j_make_grouped  # noqa: E402
from repro_torch.configs.ctr_models import TINY_HETERO, table_specs  # noqa: E402
from repro_torch.convert import adam_state_from_numpy, tower_from_numpy  # noqa: E402
from repro_torch.core.client import PSClient  # noqa: E402
from repro_torch.core.elastic import reshard  # noqa: E402
from repro_torch.core.hashing import OPOSRP  # noqa: E402
from repro_torch.core.node import Cluster  # noqa: E402
from repro_torch.data.synthetic_ctr import SyntheticCTRStream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ctr as ctr_model  # noqa: E402
from repro_torch.train.optim import AdamW  # noqa: E402
from repro_torch.train.train_step import make_ctr_train_step_grouped  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
K = TINY_HETERO.minibatches_per_batch
MB = TINY_HETERO.batch_size // K


def _numpy_tower(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {
        name: (rng.normal(size=shape) / np.sqrt(shape[0]) if init == "normal"
               else np.zeros(shape)).astype(np.float32)
        for name, (shape, init) in ctr_model.tower_schema(cfg).items()
    }


def _group_inputs(seed, n_working, k=K, mb=MB):
    """Per-group padded sparse triples stacked [k, mb, nnz] and labels [k, mb]."""
    rng = np.random.default_rng(seed)
    nnz = TINY_HETERO.nnz_per_example
    inputs = {
        g.name: {
            "slot_ids": rng.integers(0, n_working[g.name], (k, mb, nnz)).astype(np.int32),
            "slot_of": rng.integers(0, g.n_slots, (k, mb, nnz)).astype(np.int32),
            "valid": rng.random((k, mb, nnz)) < 0.8,
        }
        for g in TINY_HETERO.groups
    }
    return inputs, (rng.random((k, mb)) < 0.3).astype(np.float32)


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_hetero_config_and_table_specs_match_the_reference():
    assert [(s.name, s.schema.emb_dim, s.schema.width) for s in table_specs(TINY_HETERO)] == [
        (s.name, s.schema.emb_dim, s.schema.width) for s in j_table_specs(J_HETERO)]
    assert TINY_HETERO.pooled_dim == J_HETERO.pooled_dim == 4 * 4 + 4 * 8


def test_forward_grouped_matches_the_reference():
    rng = np.random.default_rng(0)
    n_working = {"query": 200, "ad": 300}
    tables = {g.name: (rng.normal(size=(n_working[g.name], g.emb_dim)) * 0.1).astype(np.float32)
              for g in TINY_HETERO.groups}
    inputs, labels = _group_inputs(1, n_working, k=1)
    inputs = _tree(lambda a: a[0], inputs)
    tower = _numpy_tower(TINY_HETERO, 2)
    got = ctr_model.forward_grouped(TINY_HETERO, tower_from_numpy(tower, "cpu"),
                                    _tree(torch.from_numpy, tables), _tree(torch.from_numpy, inputs))
    want = j_ctr.forward_grouped(J_HETERO, tower, tables, inputs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    got_l = ctr_model.loss_fn_grouped(TINY_HETERO, tower_from_numpy(tower, "cpu"),
                                      _tree(torch.from_numpy, tables),
                                      _tree(torch.from_numpy, inputs), torch.from_numpy(labels[0]))
    want_l = j_ctr.loss_fn_grouped(J_HETERO, tower, tables, inputs, labels[0])
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=RTOL, atol=ATOL)


def test_grouped_step_matches_the_jax_step():
    """Three batches of k mini-batches through the grouped step, carrying
    tower, Adam state, both group tables and accumulators: per-batch losses,
    every group table and accumulator and the tower within 1e-5."""
    rng = np.random.default_rng(3)
    n_working = {"query": 150, "ad": 250}
    tables = {g.name: (rng.normal(size=(n_working[g.name], g.emb_dim)) * 0.1).astype(np.float32)
              for g in TINY_HETERO.groups}
    accums = {n: np.abs(rng.normal(size=t.shape)).astype(np.float32) for n, t in tables.items()}
    tower = _numpy_tower(TINY_HETERO, 1)

    jopt = JAdamW(lr=1e-3)
    jstep = jax.jit(j_make_grouped(J_HETERO, 0.05, jopt))
    j_state = (tower, jopt.init(tower), tables, accums)
    opt = AdamW(lr=1e-3)
    step = make_ctr_train_step_grouped(TINY_HETERO, 0.05, opt)
    p_state = (tower_from_numpy(tower, "cpu"),
               adam_state_from_numpy(jax.tree.map(np.asarray, jopt.init(tower)), "cpu"),
               _tree(lambda a: torch.from_numpy(a.copy()), tables),
               _tree(lambda a: torch.from_numpy(a.copy()), accums))
    tables_in = _tree(lambda t: t.clone(), p_state[2])
    for b in range(3):
        inputs, labels = _group_inputs(10 + b, n_working)
        mbs = {"inputs": inputs, "labels": labels}
        *j_state, jm = jstep(*j_state, mbs)
        *p_state, pm = step(*p_state, _tree(torch.from_numpy, mbs))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    assert all(torch.equal(tables_in[n], torch.from_numpy(tables[n])) for n in tables)  # inputs kept
    for name in tables:
        for p, j in ((p_state[2], j_state[2]), (p_state[3], j_state[3])):
            assert p[name].shape == j[name].shape
            np.testing.assert_allclose(p[name].numpy(), np.asarray(j[name]), rtol=RTOL, atol=ATOL)
        assert not np.array_equal(p_state[2][name].numpy(), tables[name])  # rows trained
    for k in tower:
        np.testing.assert_allclose(p_state[0][k].numpy(), np.asarray(j_state[0][k]),
                                   rtol=RTOL, atol=ATOL)
    assert int(p_state[1].step) == int(j_state[1].step) == 3 * K


def _grouped_training(tmp_path, tag, port: bool, n_batches=6):
    """The reference's hetero training loop (tests/test_hetero_ctr.py): one
    session per group table on one shared cluster, one grouped step per
    batch, committed rows. Returns the per-batch losses and every row."""
    cfg = TINY_HETERO
    specs = (table_specs if port else j_table_specs)(cfg)
    width = max(s.schema.width for s in specs)
    cluster = (Cluster if port else JCluster)(2, str(tmp_path / tag), dim=width,
                                              cache_capacity=2048, file_capacity=64)
    client = (PSClient if port else JPSClient)(cluster, specs)
    tower = _numpy_tower(cfg, 0)
    if port:
        opt = AdamW(lr=1e-3)
        tower = tower_from_numpy(tower, "cpu")
        step = make_ctr_train_step_grouped(cfg, row_lr=0.05, tower_opt=opt)
        arr, out = torch.from_numpy, lambda t: t.numpy()
    else:
        opt = JAdamW(lr=1e-3)
        step = jax.jit(j_make_grouped(J_HETERO, row_lr=0.05, tower_opt=opt))
        arr, out = jnp.asarray, np.asarray
    opt_state = opt.init(tower)
    streams = {g.name: (SyntheticCTRStream if port else JStream)(
        cfg.n_sparse_keys, cfg.nnz_per_example, g.n_slots, cfg.batch_size, seed=i, noise=0.2)
        for i, g in enumerate(cfg.groups)}
    stack = lambda a: arr(np.ascontiguousarray(a.reshape((K, MB) + a.shape[1:])))
    losses = []
    for _ in range(n_batches):
        batches = {name: s.next_batch() for name, s in streams.items()}
        sessions = {name: client.session(name, b.keys) for name, b in batches.items()}
        minibatches = {
            "labels": stack(batches["query"].labels),
            "inputs": {name: {"slot_ids": stack(sessions[name].slots),
                              "slot_of": stack(batches[name].slot_of),
                              "valid": stack(batches[name].valid)} for name in streams},
        }
        tables = {n: arr(s.params.copy()) for n, s in sessions.items()}
        accums = {n: arr(s.opt_state.copy()) for n, s in sessions.items()}
        tower, opt_state, tables, accums, m = step(tower, opt_state, tables, accums, minibatches)
        for name, s in sessions.items():
            s.commit(out(tables[name]), out(accums[name]))
        losses.append(float(m["loss"]))
    cluster.flush_all()
    assert cluster.total_pins() == 0 and client.n_inflight() == 0
    keys = np.arange(cfg.n_sparse_keys, dtype=np.uint64)
    rows = {s.name: cluster.pull(client.table(s.name).namespace(keys), pin=False) for s in specs}
    return losses, rows


def test_grouped_training_on_one_cluster_tracks_the_reference(tmp_path):
    ops.reset_launch_counts()
    got, got_rows = _grouped_training(tmp_path, "port", True)
    want, want_rows = _grouped_training(tmp_path, "jax", False)
    assert all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for name in got_rows:  # each group's rows at its own width on the shared cluster
        np.testing.assert_allclose(got_rows[name], want_rows[name], rtol=1e-5, atol=1e-5)
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors: plain versions only


# ------------------------------------------------------------ LR baseline


@pytest.mark.parametrize("seed", [0, 1])
def test_lr_loss_and_gradient_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    n_working, B, nnz = 500, 64, 24
    table = (rng.normal(size=(n_working, 1)) * 0.2).astype(np.float32)
    ids = rng.integers(0, n_working, (B, nnz)).astype(np.int32)
    valid = rng.random((B, nnz)) < 0.7
    labels = (rng.random(B) < 0.4).astype(np.float32)
    bias = np.float32(0.1)
    want_logit = j_ctr.lr_forward(table, ids, valid, jnp.asarray(bias))
    want, (want_gt, want_gb) = jax.value_and_grad(j_ctr.lr_loss_fn, argnums=(0, 4))(
        jnp.asarray(table), ids, valid, labels, jnp.asarray(bias))
    t = torch.from_numpy(table.copy()).requires_grad_()
    b = torch.tensor(bias, requires_grad=True)
    logit = ctr_model.lr_forward(t, torch.from_numpy(ids), torch.from_numpy(valid), b)
    assert logit.shape == (B,)
    np.testing.assert_allclose(logit.detach().numpy(), np.asarray(want_logit), rtol=RTOL,
                               atol=ATOL)
    loss = ctr_model.lr_loss_fn(t, torch.from_numpy(ids), torch.from_numpy(valid),
                                torch.from_numpy(labels), b)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_gt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(b.grad), float(want_gb), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------ the numpy copies


def test_oposrp_copy_matches_the_reference():
    rng = np.random.default_rng(1)
    cols = rng.integers(0, 2**40, size=(20, 30)).astype(np.uint64)
    valid = rng.random((20, 30)) < 0.8
    for k, seed in ((16, 0), (64, 9)):
        got, want = OPOSRP(k, seed).transform_padded(cols, valid), JOPOSRP(k, seed).transform_padded(
            cols, valid)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_elastic_reshard_in_the_port_keeps_every_row(tmp_path):
    cl = Cluster(2, str(tmp_path / "src"), dim=4, cache_capacity=64, file_capacity=16)
    keys = np.arange(500, dtype=np.uint64)
    vals = np.random.default_rng(0).normal(size=(500, 4)).astype(np.float32)
    cl.push(keys, vals, unpin=False)
    new = reshard(cl, 3, str(tmp_path / "dst"))
    assert new.n_nodes == 3
    np.testing.assert_array_equal(new.pull(keys, pin=False), vals)
