"""The port's dense-embedding LM training step against the JAX reference, on
the CPU: yi-9b, phi3-mini and granite-20b here, the other seven smoke archs
in ``tests/test_torch_lm_train_{moe,families}.py`` (one file per worker).

Both sides start from the same numpy weights (``test_torch_lm._pair``) and
the same numpy batch, split into 2 microbatches as the reference's
``tests/test_models.py::test_smoke_train_step_dense`` does, remat on. The
port's gradients (``make_lm_grads``: its ``_make_loss_fn`` per microbatch,
summed in fp32 and divided by their number) are held against
``jax.value_and_grad`` of the reference's ``_make_loss_fn``, jitted, over the
same microbatches, twice:

* with fp32 compute on both sides (every module's ``COMPUTE_DTYPE`` and the
  MoE ``DISPATCH_DTYPE`` set to fp32): every gradient leaf within
  ``FP32_TOL`` = 1e-3 of its own largest magnitude (``max |port - ref| <=
  1e-3 * max |ref|``, per leaf; the worst seen was 2.2e-4, xlstm's ``b_i`` in
  hier_ps mode, the rest below 1e-5), the loss within 1e-5;
* in bf16, as the models train: both sides round activations to bf16 after
  sums taken in other orders (and the reference's CPU compiler keeps fused
  elementwise chains in fp32 where the port rounds each op), so a rounding
  flips on one side and not the other. Each leaf is held within
  ``GRAD_TOL`` = 5e-2 of its own largest magnitude; over the ten smoke archs
  the worst was 2.7e-2. One leaf nearly cancels: xlstm's ``b_i`` in hier_ps
  mode, at most 2.3e-3 against bf16 noise of 1.1e-4 in the reference and
  5e-4 in the port (each against its fp32 gradient). ``BF16_LOOSE`` holds it
  within 0.25 of its largest in bf16; the fp32 check holds it within
  ``FP32_TOL``. The loss within ``LOSS_RTOL`` = 1e-3 (the worst seen was
  1.8e-4).
"""

import contextlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train.optim import AdamW as JAdamW  # noqa: E402
from repro.train.train_step import TrainSettings as JTrainSettings  # noqa: E402
from repro.train.train_step import _make_loss_fn as _jloss_fn  # noqa: E402
from repro.train.train_step import make_lm_train_step as jmake_lm_train_step  # noqa: E402
from repro_torch.train.optim import AdamW, tree_leaves, tree_map  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainSettings,
    cross_entropy,
    make_lm_grads,
    make_lm_train_step,
)

from test_torch_lm import _pair  # noqa: E402

GRAD_TOL = 5e-2
FP32_TOL = 1e-3
LOSS_RTOL = 1e-3
# (arch, embedding mode, leaf) -> its bf16 tolerance, where the gradient
# nearly cancels and bf16 noise is a large share of it (module docstring)
BF16_LOOSE = {("xlstm-1.3b", "hier_ps", "mlstm/b_i"): 0.25}
DENSE = ["yi-9b", "phi3-mini-3.8b", "granite-20b"]


def np_batch(cfg, B=4, S=8, seed=1, n_working=None):
    """tokens (or working slots below ``n_working``), targets and the
    family's extra inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    hi = cfg.vocab_size if n_working is None else n_working
    batch = {"tokens": rng.integers(0, hi, (B, S)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _bf16_extras(batch, to):
    """The family's extra inputs in bf16 on each side (the reference's
    ``make_batch`` draws them in bf16)."""
    return {k: to(v, k in ("frames", "image_embeds")) for k, v in batch.items()}


def jax_batch(batch):
    return _bf16_extras(batch, lambda v, bf: jnp.asarray(v, jnp.bfloat16 if bf else None))


def torch_batch(batch):
    return _bf16_extras(batch, lambda v, bf: torch.from_numpy(v).to(torch.bfloat16) if bf
                        else torch.from_numpy(v))


def jax_grads(jcfg, jp, batch, *, hier=False, wt=None, microbatches=2):
    """The reference's loss gradients over ``microbatches`` microbatches:
    the mean of ``jax.value_and_grad`` of its ``_make_loss_fn`` per
    microbatch (its step's scan, unrolled) -> (param grads, table grads or
    None, mean loss, mean aux)."""
    loss_fn = _jloss_fn(jcfg, JTrainSettings(microbatches=microbatches), hier)
    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1) if hier else 0, has_aux=True))
    jb = jax_batch(batch)
    B = batch["tokens"].shape[0]
    n = B // microbatches
    acc, losses, auxs = None, [], []
    for i in range(microbatches):
        micro = {k: v[i * n:(i + 1) * n] for k, v in jb.items()}
        (_, (loss, aux)), g = vg(jp, wt, micro)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        losses.append(float(loss))
        auxs.append(float(aux))
    acc = jax.tree.map(lambda g: g / microbatches, acc)
    pg, tg = acc if hier else (acc, None)
    return pg, tg, float(np.mean(losses)), float(np.mean(auxs))


def assert_leaves_close(got, want, tol=GRAD_TOL, loose=None, path=()):
    """Each leaf of the port's tree within ``tol`` of its own largest
    magnitude (within ``loose[leaf path]`` where given); the trees hold the
    same leaves."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), path
        for k in got:
            assert_leaves_close(got[k], want[k], tol, loose, path + (k,))
        return
    name = "/".join(path)
    tol = (loose or {}).get(name, tol)
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape and np.isfinite(g).all(), name
    err, scale = float(np.abs(g - w).max()), float(np.abs(w).max())
    assert err <= tol * scale, f"{name}: max |diff| {err} > {tol} * max |ref| {scale}"


@contextlib.contextmanager
def fp32_compute():
    """Both packages' models compute in fp32: every loaded model module's
    ``COMPUTE_DTYPE`` and ``DISPATCH_DTYPE`` set to fp32 for the block."""
    saved = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith(("repro.models", "repro_torch.models")):
            continue
        f32 = torch.float32 if name.startswith("repro_torch") else jnp.float32
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if hasattr(mod, attr):
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, f32)
    try:
        yield
    finally:
        for mod, attr, value in saved:
            setattr(mod, attr, value)


def check_grads(arch, embedding_mode="dense", microbatches=2):
    """The port's loss gradients against the reference's, with fp32 compute
    and in bf16 (see the module docstring)."""
    jcfg, tcfg, jp, tp = _pair(arch, embedding_mode=embedding_mode)
    hier = embedding_mode == "hier_ps"
    n_working = 64 if hier else None
    batch = np_batch(jcfg, n_working=n_working)
    wt = (np.random.default_rng(5).standard_normal((64, jcfg.d_model)) * 0.02).astype(np.float32)
    settings = TrainSettings(microbatches=microbatches)
    ref, port = {}, {}
    for f32 in (True, False):
        with fp32_compute() if f32 else contextlib.nullcontext():
            ref[f32] = jax_grads(jcfg, jp, batch, hier=hier,
                                 wt=jnp.asarray(wt) if hier else None, microbatches=microbatches)
            port[f32] = make_lm_grads(tcfg, settings, hier=hier)(
                tp, torch_batch(batch), torch.from_numpy(wt) if hier else None)
    loose = {leaf: t for (a, mode, leaf), t in BF16_LOOSE.items()
             if (a, mode) == (arch, embedding_mode)}
    for f32, tol, loss_rtol in ((True, FP32_TOL, 1e-5), (False, GRAD_TOL, LOSS_RTOL)):
        jpg, jtg, jloss, jaux = ref[f32]
        tpg, ttg, metrics = port[f32]
        assert abs(float(metrics["loss"]) - jloss) <= loss_rtol * abs(jloss), f32
        assert abs(float(metrics["moe_aux"]) - jaux) <= loss_rtol * max(abs(jaux), 1.0), f32
        assert_leaves_close(tpg, jpg, tol, None if f32 else loose)
        if hier:
            assert ttg.dtype == torch.float32 and ttg.shape == wt.shape
            assert_leaves_close(ttg, jtg, tol)
        else:
            assert ttg is None


@pytest.mark.parametrize("arch", DENSE)
def test_dense_loss_gradients_match_reference(arch):
    check_grads(arch)


def test_cross_entropy_matches_the_one_hot_contraction():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 33)).astype(np.float32) * 4)
    targets = torch.from_numpy(rng.integers(0, 33, (2, 5)))
    onehot = torch.nn.functional.one_hot(targets, 33).float()
    want = torch.mean(torch.logsumexp(logits, -1) - torch.einsum("bsv,bsv->bs", logits, onehot))
    assert torch.equal(cross_entropy(logits, targets), want)


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_dense_train_step_matches_reference_step(arch):
    """One whole step against the reference's jitted ``make_lm_train_step``
    (2 microbatches, AdamW with the clip): metrics, and each leaf's update
    ``new - old`` within ``GRAD_TOL`` of the reference's largest. AdamW's
    first step from a zero state is ``lr * sign(g)`` where ``|g| >> eps``,
    which makes the sign of gradients that round to near zero decide a
    full-size update; an ``eps`` of 1 keeps the update linear in small
    gradients, so the comparison measures the step and not that sign."""
    jcfg, tcfg, jp, tp = _pair(arch)
    batch = np_batch(jcfg)
    js = JTrainSettings(optimizer=JAdamW(lr=1e-2, eps=1.0), microbatches=2)
    ts = TrainSettings(optimizer=AdamW(lr=1e-2, eps=1.0), microbatches=2)
    jnew, jopt, jm = jax.jit(jmake_lm_train_step(jcfg, js))(
        jp, js.optimizer.init(jp), jax_batch(batch))
    tnew, topt, tm = make_lm_train_step(tcfg, ts)(tp, ts.optimizer.init(tp), torch_batch(batch))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert int(topt.step) == int(jopt.step) == 1
    delta_t = tree_map(lambda a, b: a.float() - b.float(), tnew, tp)
    delta_j = jax.tree.map(lambda a, b: np.asarray(a, np.float32) - np.asarray(b, np.float32),
                           jnew, jp)
    assert_leaves_close(delta_t, delta_j)
    # the inputs are not modified
    _, _, _, tp_again = _pair(arch)
    for a, b in zip(tree_leaves(tp), tree_leaves(tp_again)):
        assert torch.equal(a, b)


def test_microbatches_split_the_batch():
    """Two microbatches of 2 equal one batch of 4 up to the order of the fp32
    sums (each microbatch's loss is its own mean)."""
    _, tcfg, _, tp = _pair("yi-9b")
    batch = torch_batch(np_batch(tcfg))
    one = make_lm_grads(tcfg, TrainSettings(microbatches=1))(tp, batch)
    two = make_lm_grads(tcfg, TrainSettings(microbatches=2))(tp, batch)
    assert abs(float(one[2]["loss"]) - float(two[2]["loss"])) <= 1e-5 * float(one[2]["loss"])
    assert_leaves_close(two[0], tree_map(lambda t: t.numpy(), one[0]), tol=1e-2)
