"""The pieces of the port's LM training against the JAX reference, on the CPU.

* The three autograd Functions of ``kernels.ops`` that carry the card's
  kernels through a backward: ``embedding_lookup`` (its backward scatter-adds
  through ``scatter_add``), ``flash_attention`` (its backward recomputes
  ``attention_blockwise``, as the reference's ``_flash_bwd``) and ``gmm``
  (dx by ``gmm`` over w transposed, dw one grouped matmul): their gradients
  against ``jax.vjp`` of the reference's ops on the same numpy inputs. On the CPU
  the port runs the kernels' plain versions; the reference's flash runs its
  Pallas kernel in interpret mode.
* The optimizers on nested trees (AdamW with the global-norm clip, Adagrad,
  ``cosine_schedule``) against the reference's.
* Remat: each family's training forward with ``remat`` on equals it off,
  values and gradients bit for bit, and the backward runs each layer again.
* The kernel calls one LM train step makes, counted on the plain versions
  the CPU runs: the numbers ``chip_smoke.py``'s ``lm_train`` phase checks.

Tolerances are stated per test, relative to the largest magnitude of the
reference's value (``max |port - ref| <= tol * max |ref|``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.convert import lm_adam_state_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainSettings,
    make_lm_grads,
    make_lm_train_step_hier,
)

from test_torch_lm import _pair  # noqa: E402


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a, dtype=torch.float32, grad=True):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).requires_grad_(grad)


# --------------------------------------------------------------------------
# embedding_lookup: backward through scatter_add
# --------------------------------------------------------------------------


@pytest.mark.parametrize("values", ["dyadic", "normal"])
def test_embedding_lookup_grad_matches_reference_with_duplicate_ids(values, monkeypatch):
    """Duplicate ids (zipf-like, one id 40 times) accumulate their rows'
    gradients: dyadic values (every sum exact) bit for bit, normal values
    within 1e-6. The backward goes through scatter_add once."""
    rng = np.random.default_rng(0)
    N, B, D = 50, 120, 24
    ids = np.concatenate([np.full(40, 7), rng.integers(0, N, B - 40)]).astype(np.int32)
    rng.shuffle(ids)
    if values == "dyadic":
        table = (rng.integers(-64, 64, (N, D)) / 16).astype(np.float32)
        g = (rng.integers(-64, 64, (B, D)) / 16).astype(np.float32)
    else:
        table = rng.standard_normal((N, D)).astype(np.float32)
        g = rng.standard_normal((B, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jops.embedding_lookup(t, jnp.asarray(ids)), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))

    calls = []
    real = ops.scatter_add_plain_
    monkeypatch.setattr(ops, "scatter_add_plain_", lambda *a: calls.append(1) or real(*a))
    t = _t(table)
    out = ops.embedding_lookup(t, torch.from_numpy(ids))
    assert torch.equal(out, t.detach()[torch.from_numpy(ids).long()])
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    assert calls == [1]
    if values == "dyadic":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not got[np.setdiff1d(np.arange(N), ids)].any()  # unread rows: no gradient


def test_embedding_lookup_grad_in_bf16_on_the_cpu():
    """The CPU path takes any dtype; only the card's scatter_add is fp32."""
    t = torch.randn(10, 8).to(torch.bfloat16).requires_grad_()
    ids = torch.tensor([1, 1, 3])
    (got,) = torch.autograd.grad(ops.embedding_lookup(t, ids), t, torch.ones(3, 8,
                                                                           dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got[1].eq(2).all() and got[3].eq(1).all()


# --------------------------------------------------------------------------
# flash_attention: backward by recompute
# --------------------------------------------------------------------------

FLASH_CASES = [
    # name, B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset
    ("causal", 2, 4, 2, 128, 128, 16, True, 0, 0),
    ("window", 1, 4, 1, 128, 128, 16, True, 32, 0),
    ("not_causal", 2, 4, 4, 64, 96, 8, False, 0, 0),
    ("cross", 1, 6, 2, 32, 256, 16, False, 0, 0),
    ("causal_q_offset", 1, 4, 2, 128, 256, 16, True, 0, 128),
    ("window_q_offset", 1, 2, 1, 128, 256, 16, True, 48, 128),
    ("rows_keep_no_key", 1, 2, 1, 32, 64, 8, True, 0, -8),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_grads_match_reference_flash(case, dtype):
    """dq, dk, dv of the port's Function against ``jax.vjp`` of the
    reference's ``attention(impl="flash")`` (the Pallas kernel in interpret
    mode forward, ``attention_blockwise``'s vjp backward): fp32 within 1e-5
    of the largest gradient, bf16 within 2e-2 (both round q, k, v, the output
    and the gradients to bf16, in other orders). Every gradient is finite,
    rows that keep no key included."""
    _, B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset = case
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, Sq, Dh), (B, Hkv, Skv, Dh), (B, Hkv, Skv, Dh)))
    g = rng.standard_normal((B, H, Sq, Dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want_out, vjp = jax.vjp(lambda q, k, v: jops.attention(q, k, v, impl="flash", **kw),
                            *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    tq, tk, tv = (_t(a, tdt) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g, tdt, grad=False))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _rel(out.detach(), want_out) <= tol
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == tdt
        assert _rel(a, b) <= tol, f"d{name}"
    if q_offset < 0:  # the first rows keep no key: output 0 and no gradient
        assert not out[:, :, :-q_offset].any() and not got[0][:, :, :-q_offset].any()


def test_flash_attention_grad_of_one_input_only():
    """Only the inputs that require grad get one (a frozen K/V cache)."""
    q = torch.randn(1, 2, 16, 8, requires_grad=True)
    k, v = torch.randn(1, 1, 16, 8), torch.randn(1, 1, 16, 8)
    (dq,) = torch.autograd.grad(ops.flash_attention(q, k, v).sum(), q)
    kq = q.detach().requires_grad_()
    (want,) = torch.autograd.grad(ops.attention_blockwise(kq, k, v, block_k=128).sum(), kq)
    assert torch.equal(dq, want)


# --------------------------------------------------------------------------
# gmm: dx and dw
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [[5, 0, 12, 3], [1, 30, 1], [0, 0, 16]])
def test_gmm_grads_match_reference(sizes, dtype):
    """dx and dw against ``jax.vjp`` of the reference's ``gmm_ref``: fp32
    within 1e-5 of the largest gradient. In bf16 the reference's dw is a
    scatter-add of per-row products that rounds to bf16 at every add, where
    the port sums each group in fp32 and rounds once; so the bf16 gradients
    are held against the reference in fp32 on the same bf16-rounded inputs,
    within 1e-2 (the port's one rounding). An empty group's dw is 0. The
    Function takes the tile plan and ignores it on the CPU."""
    from repro_torch.kernels.moe_gmm import TILE_ROWS, gmm_tiles

    rng = np.random.default_rng(len(sizes) + sum(sizes))
    T, K, N, E = sum(sizes), 24, 40, len(sizes)
    tdt = getattr(torch, dtype)
    rounded = lambda a: torch.from_numpy(a).to(tdt).float().numpy()
    x = rounded(rng.standard_normal((T, K)).astype(np.float32))
    w = rounded(rng.standard_normal((E, K, N)).astype(np.float32))
    g = rounded(rng.standard_normal((T, N)).astype(np.float32))
    gs = np.asarray(sizes, np.int32)
    _, vjp = jax.vjp(lambda x, w: jref.gmm_ref(x, w, jnp.asarray(gs)),
                     jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(g))
    tx, tw = _t(x, tdt), _t(w, tdt)
    tgs = torch.from_numpy(gs)
    out = ops.gmm(tx, tw, tgs, tiles=gmm_tiles(tgs, T, TILE_ROWS[tdt]))
    got = torch.autograd.grad(out, (tx, tw), _t(g, tdt, grad=False))
    tol = 1e-5 if dtype == "float32" else 1e-2
    for name, a, b in zip(("dx", "dw"), got, want):
        assert a.dtype == tdt and _rel(a, b) <= tol, name
    for e, n in enumerate(sizes):
        if n == 0:
            assert not got[1][e].any()


def test_gmm_dw_reads_only_the_groups_rows():
    """``ops.gmm_dw`` (one ``torch._grouped_mm``) against a per-group sum in
    float64: rows past the last group are not read (NaN there changes
    nothing), groups are cut at row T, negative and empty groups give 0."""
    rng = np.random.default_rng(7)
    T, K, N = 40, 16, 24
    x = rng.standard_normal((T, K)).astype(np.float32)
    dy = rng.standard_normal((T, N)).astype(np.float32)
    for sizes in ([5, 0, 12, 3], [10, -4, 0, 50]):
        ends = np.minimum(np.cumsum(np.maximum(sizes, 0)), T)
        xn = x.copy()
        xn[ends[-1]:] = np.nan
        got = ops.gmm_dw(torch.from_numpy(xn), torch.from_numpy(dy),
                         torch.tensor(sizes, dtype=torch.int32))
        assert got.shape == (len(sizes), K, N) and got.dtype == torch.float32
        for e, (a, b) in enumerate(zip(np.r_[0, ends[:-1]], ends)):
            want = x[a:b].astype(np.float64).T @ dy[a:b]
            np.testing.assert_allclose(got[e].numpy(), want, rtol=1e-5, atol=1e-5)
            if a == b:
                assert not got[e].any()


# --------------------------------------------------------------------------
# optimizers on nested trees
# --------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": {"c": (rng.standard_normal(5) * scale).astype(np.float32),
                  "d": {"e": (rng.standard_normal((2, 2, 3)) * scale).astype(np.float32)}}}


def _close_trees(got, want, tol):
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            _close_trees(got[k], want[k], tol)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _to_torch(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.asarray(a, np.float32).copy()), tree)


@pytest.mark.parametrize("clip,wd", [(1.0, 0.0), (0.0, 0.1), (1e3, 0.0)])
def test_adamw_on_nested_trees_matches_reference(clip, wd):
    """Four AdamW steps on a nested tree, gradients large enough for the
    clip to bite (clip 1.0): params, m and v within 1e-6; the state carried
    across from the reference (``lm_adam_state_from_numpy``) continues the
    same."""
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jopt = joptim.AdamW(lr=1e-2, clip_norm=clip, weight_decay=wd)
    topt = optim.AdamW(lr=1e-2, clip_norm=clip, weight_decay=wd)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init(params)
    tp, ts = _to_torch(params), topt.init(_to_torch(params))
    for i in range(4):
        g = _tree(rng, scale=3.0)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    _close_trees(tp, jp, 1e-6)
    _close_trees(ts.m, js.m, 1e-6)
    _close_trees(ts.v, js.v, 1e-6)
    assert int(ts.step) == int(js.step) == 4
    carried = lm_adam_state_from_numpy(jax.tree.map(np.asarray, tuple(js)), device="cpu")
    assert carried.step.dtype == torch.int32 and int(carried.step) == 4
    g = _tree(rng, scale=3.0)
    jp2, _ = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
    tp2, _ = topt.update(_to_torch(g), carried, _to_torch(jax.tree.map(np.asarray, jp)))
    _close_trees(tp2, jp2, 1e-6)


def test_global_norm_and_flat_dicts():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert abs(float(optim.global_norm(_to_torch(tree))) - want) <= 1e-6 * want
    flat = {"w0": torch.ones(2, 3), "b0": torch.ones(3)}  # the CTR tower's layout
    new, state = optim.AdamW(lr=0.1).update({k: v * 2 for k, v in flat.items()},
                                            optim.AdamW().init(flat), flat)
    assert sorted(new) == ["b0", "w0"] and sorted(state.m) == ["b0", "w0"]


def test_adagrad_on_nested_trees_matches_reference():
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jopt, topt = joptim.Adagrad(lr=0.05), optim.Adagrad(lr=0.05)
    jp, js = jax.tree.map(jnp.asarray, params), jopt.init(params)
    tp, ts = _to_torch(params), topt.init(_to_torch(params))
    for _ in range(3):
        g = _tree(rng)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(_to_torch(g), ts, tp)
    _close_trees(tp, jp, 1e-6)
    _close_trees(ts.accum, js.accum, 1e-6)


def test_cosine_schedule_matches_reference():
    jlr, tlr = joptim.cosine_schedule(3e-4, 10, 100), optim.cosine_schedule(3e-4, 10, 100)
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got = tlr(torch.tensor(step, dtype=torch.int32))
        want = float(jlr(jnp.int32(step)))
        assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * 3e-4, step
    assert float(tlr(7)) == float(tlr(torch.tensor(7)))


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------

FAMILIES = ["yi-9b", "olmoe-1b-7b", "pixtral-12b", "hymba-1.5b", "xlstm-1.3b", "whisper-tiny"]


def _batch(cfg, B=2, S=8, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(
            rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_value_or_gradient(arch, monkeypatch):
    """Loss, aux and every gradient leaf with remat on equal them with remat
    off, bit for bit; with remat the backward runs each checkpointed layer
    a second time (counted at ``torch.utils.checkpoint``'s entry)."""
    _, cfg, _, params = _pair(arch)
    batch = _batch(cfg)
    import repro_torch.models.common as common

    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(common.torch.utils.checkpoint, "checkpoint",
                        lambda fn, *a, **kw: calls.append(1) or real(fn, *a, **kw))
    out = {}
    for remat in (True, False):
        settings = TrainSettings(remat=remat, microbatches=1)
        grads, _, metrics = make_lm_grads(cfg, settings)(params, batch)
        out[remat] = (grads, metrics)
    assert calls, "remat=True checkpointed nothing"
    (g_on, m_on), (g_off, m_off) = out[True], out[False]
    assert torch.equal(m_on["loss"], m_off["loss"]) and torch.equal(m_on["moe_aux"],
                                                                    m_off["moe_aux"])
    on, off = optim.tree_leaves(g_on), optim.tree_leaves(g_off)
    assert len(on) == len(off) == len(optim.tree_leaves(params))
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_remat_recomputes_each_layer_once_in_the_backward(monkeypatch):
    """yi-9b's smoke config: the layer body runs L times in the forward, and
    L more times in the backward with remat, never without."""
    from repro_torch.models import transformer as TT

    _, cfg, _, params = _pair("yi-9b")
    calls = []
    real = TT._block
    monkeypatch.setattr(TT, "_block", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    batch = _batch(cfg)
    for remat, want in ((True, 2 * cfg.n_layers), (False, cfg.n_layers)):
        calls.clear()
        make_lm_grads(cfg, TrainSettings(remat=remat))(params, batch)
        assert len(calls) == want, remat
    # serving's forward without autograd checkpoints nothing
    calls.clear()
    with torch.no_grad():
        get_model(cfg).forward(cfg, params, batch["tokens"])
    assert len(calls) == cfg.n_layers


# --------------------------------------------------------------------------
# the kernel calls of one LM train step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_hier_step_kernel_calls_per_step(arch, monkeypatch):
    """One ``make_lm_train_step_hier`` step with 2 microbatches, flash
    attention asked for (``attn_impl="flash"``), counted at the plain
    versions the CPU runs in the kernels' place: per microbatch one
    embedding_lookup and one scatter_add (its backward), per layer and
    microbatch two flash_attention (the forward and remat's recompute), for
    an MoE layer nine gmm (wi, wg and wo in the forward, again in the
    recompute, and dx of each); one fused_adagrad per step."""
    _, cfg, _, params = _pair(arch, embedding_mode="hier_ps")
    counts = dict.fromkeys(("embedding_lookup_plain", "scatter_add_plain_",
                            "flash_attention_plain", "gmm_plain", "adagrad_plain"), 0)
    for name in counts:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    rng = np.random.default_rng(4)
    n_working, B, S = 40, 4, 8
    batch = {"tokens": torch.from_numpy(rng.integers(0, n_working, (B, S))),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    wt = torch.from_numpy(rng.standard_normal((n_working, cfg.d_model)).astype(np.float32))
    settings = TrainSettings(microbatches=2, attn_impl="flash")
    step = make_lm_train_step_hier(cfg, settings)
    out = step(params, settings.optimizer.init(params), batch, wt, torch.zeros_like(wt))
    L, M = cfg.n_layers, 2
    assert counts == {"embedding_lookup_plain": M, "scatter_add_plain_": M,
                      "flash_attention_plain": 2 * L * M,
                      "gmm_plain": 9 * L * M if cfg.is_moe else 0, "adagrad_plain": 1}
    assert np.isfinite(float(out[2]["loss"])) and not torch.equal(out[3], wt)


def test_train_steps_check_the_embedding_mode():
    from repro_torch.train.train_step import make_lm_train_step

    _, cfg, _, _ = _pair("yi-9b")
    with pytest.raises(ValueError, match="hier_ps"):
        make_lm_train_step_hier(cfg)
    with pytest.raises(ValueError, match="dense"):
        make_lm_train_step(dataclasses.replace(cfg, embedding_mode="hier_ps"))
