"""The port's hier_ps LM training step (the paper's technique on an LM)
against the JAX reference, on the CPU.

* The loss gradients of ``make_lm_grads(..., hier=True)`` — every parameter
  leaf and the working table's — against ``jax.value_and_grad`` of the
  reference's ``_make_loss_fn`` over (params, working table), for the archs
  of ``tests/test_models.py::test_smoke_train_step_hier``: yi-9b,
  olmoe-1b-7b and whisper-tiny here, xlstm-1.3b and hymba-1.5b in
  ``tests/test_torch_lm_train_hier_families.py``; 2 microbatches,
  tolerances as ``tests/test_torch_lm_train.py`` states them.
* One whole hier step against the reference's jitted
  ``make_lm_train_step_hier``: the new working rows (row-Adagrad) and
  accumulator.
* hier == flat through a real port ``Cluster``, as
  ``tests/test_hier_lm.py`` holds the reference: the same steps with all
  vocab rows resident, and with each batch's rows pulled and pushed through
  the PS (``HierarchicalPS``, and ``PSClient`` sessions of a named
  ``tok_emb`` table as the launcher drives them): losses within rtol 1e-4,
  final rows within atol 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train.optim import AdamW as JAdamW  # noqa: E402
from repro.train.train_step import TrainSettings as JTrainSettings  # noqa: E402
from repro.train.train_step import make_lm_train_step_hier as jmake_step  # noqa: E402
from repro_torch.core.client import PSClient  # noqa: E402
from repro_torch.core.hier_ps import HierarchicalPS  # noqa: E402
from repro_torch.core.keys import deterministic_init  # noqa: E402
from repro_torch.core.node import Cluster  # noqa: E402
from repro_torch.core.tables import RowSchema, TableSpec  # noqa: E402
from repro_torch.train.optim import AdamW  # noqa: E402
from repro_torch.train.train_step import TrainSettings, make_lm_train_step_hier  # noqa: E402

from test_torch_lm import _pair  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    GRAD_TOL,
    LOSS_RTOL,
    assert_leaves_close,
    check_grads,
    jax_batch,
    np_batch,
    torch_batch,
)


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b", "whisper-tiny"])
def test_hier_loss_gradients_match_reference(arch):
    check_grads(arch, embedding_mode="hier_ps")


@pytest.mark.parametrize("arch", ["yi-9b", "whisper-tiny"])
def test_hier_train_step_matches_reference_step(arch):
    """The new working rows and accumulator of one step against the
    reference's: the accumulator's growth g^2 within twice ``GRAD_TOL`` of
    its largest (a square doubles g's relative error), the rows' update
    within ``GRAD_TOL`` of its largest. The accumulator starts
    at 1, so the row update is ``lr * g / (sqrt(1 + g^2) + eps)``, linear in
    small gradients (from 0 it would be ``lr * sign(g)``, see
    ``test_dense_train_step_matches_reference_step``)."""
    jcfg, tcfg, jp, tp = _pair(arch, embedding_mode="hier_ps")
    n_working = 64
    batch = np_batch(jcfg, n_working=n_working)
    wt = (np.random.default_rng(6).standard_normal((n_working, jcfg.d_model)) * 0.5
          ).astype(np.float32)
    acc = np.ones_like(wt)
    js = JTrainSettings(optimizer=JAdamW(lr=1e-3), microbatches=2, row_lr=0.05)
    ts = TrainSettings(optimizer=AdamW(lr=1e-3), microbatches=2, row_lr=0.05)
    _, _, jm, jt, ja = jax.jit(jmake_step(jcfg, js))(
        jp, js.optimizer.init(jp), jax_batch(batch), jnp.asarray(wt), jnp.asarray(acc))
    twt, tacc = torch.from_numpy(wt), torch.from_numpy(acc)
    _, _, tm, tt, ta = make_lm_train_step_hier(tcfg, ts)(
        tp, ts.optimizer.init(tp), torch_batch(batch), twt, tacc)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert tt.dtype == ta.dtype == torch.float32
    assert_leaves_close(ta - 1, np.asarray(ja) - 1, tol=2 * GRAD_TOL)
    assert_leaves_close(tt - twt, np.asarray(jt) - wt, tol=GRAD_TOL)
    assert torch.equal(twt, torch.from_numpy(wt)) and torch.equal(tacc, torch.ones_like(tacc))


ARCH, N_STEPS = "yi-9b", 5


def _data(cfg, step, B=4, S=8):
    toks = np.random.default_rng(100 + step).integers(0, cfg.vocab_size, (B, S + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _flat_run(cfg, params, settings, table):
    """The steps with every vocab row resident: tokens are their own slots."""
    step = make_lm_train_step_hier(cfg, settings)
    p, o = params, settings.optimizer.init(params)
    table, accum = torch.from_numpy(table), torch.zeros(table.shape)
    losses = []
    for i in range(N_STEPS):
        toks, tgts = _data(cfg, i)
        batch = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
        p, o, m, table, accum = step(p, o, batch, table, accum)
        losses.append(float(m["loss"]))
    return losses, table.numpy()


def test_hier_lm_equals_flat_embedding_through_the_cluster(tmp_path):
    """The reference's ``test_hier_lm_equals_flat_embedding`` on the port:
    dedup, renumbering and SSD churn (a 256-row cache) change nothing."""
    _, cfg, _, params = _pair(ARCH, embedding_mode="hier_ps")
    settings = TrainSettings(optimizer=AdamW(lr=1e-3, clip_norm=0.0), microbatches=1,
                             row_lr=0.05)
    d, V = cfg.d_model, cfg.vocab_size
    losses_a, flat = _flat_run(cfg, params, settings,
                               deterministic_init(np.arange(V, dtype=np.uint64), d, 0.01))

    cl = Cluster(2, str(tmp_path / "ps"), dim=d * 2, cache_capacity=256, file_capacity=64,
                 init_cols=d)
    ps = HierarchicalPS(cl, d, d)
    step = make_lm_train_step_hier(cfg, settings)
    p, o = params, settings.optimizer.init(params)
    losses_b = []
    for i in range(N_STEPS):
        toks, tgts = _data(cfg, i)
        ws = ps.prepare_batch(toks.astype(np.uint64))
        batch = {"tokens": torch.from_numpy(np.asarray(ws.slots)),
                 "targets": torch.from_numpy(tgts)}
        p, o, m, new_t, new_acc = step(p, o, batch, torch.from_numpy(ws.params),
                                       torch.from_numpy(ws.opt_state))
        ps.complete_batch(ws, new_t.numpy(), new_acc.numpy())
        losses_b.append(float(m["loss"]))
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-4, atol=1e-5)
    cl.flush_all()
    rows = cl.pull(np.arange(V, dtype=np.uint64), pin=False)[:, :d]
    np.testing.assert_allclose(rows, flat, atol=2e-5, rtol=1e-4)


def test_hier_lm_through_psclient_sessions_equals_flat(tmp_path):
    """The launcher's loop: a named ``tok_emb`` table (rows ``[emb |
    adagrad]``), one ``PSClient.session`` per batch, ``s.commit`` of the new
    rows and accumulator; against the flat run from the same initial rows."""
    _, cfg, _, params = _pair(ARCH, embedding_mode="hier_ps")
    settings = TrainSettings(optimizer=AdamW(lr=1e-3), microbatches=2, row_lr=0.05)
    d, V = cfg.d_model, cfg.vocab_size
    cl = Cluster(2, str(tmp_path / "ps"), dim=d * 2, cache_capacity=256, file_capacity=64,
                 init_scale=0.02)
    client = PSClient(cl, [TableSpec("tok_emb", RowSchema.with_adagrad(d))])
    vocab = np.arange(V, dtype=np.uint64)
    with client.session("tok_emb", vocab, read_only=True) as s:
        initial = np.array(s.params)[np.asarray(s.slots)]
        assert not np.asarray(s.opt_state).any()
    losses_a, flat = _flat_run(cfg, params, settings, initial)

    step = make_lm_train_step_hier(cfg, settings)
    p, o = params, settings.optimizer.init(params)
    losses_b = []
    for i in range(N_STEPS):
        toks, tgts = _data(cfg, i)
        with client.session("tok_emb", toks.astype(np.uint64)) as s:
            batch = {"tokens": torch.from_numpy(np.asarray(s.slots)),
                     "targets": torch.from_numpy(tgts)}
            p, o, m, new_t, new_acc = step(p, o, batch, torch.from_numpy(s.params),
                                           torch.from_numpy(s.opt_state))
            s.commit(new_t.numpy(), new_acc.numpy())
        losses_b.append(float(m["loss"]))
    np.testing.assert_allclose(losses_a, losses_b, rtol=1e-4, atol=1e-5)
    with client.session("tok_emb", vocab, read_only=True) as s:
        rows = np.asarray(s.params)[np.asarray(s.slots)]
    np.testing.assert_allclose(rows, flat, atol=2e-5, rtol=1e-4)
    assert client.n_inflight() == 0
