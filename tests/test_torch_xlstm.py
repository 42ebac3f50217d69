"""The port's SSM family (xlstm) against the JAX reference, on the CPU.

Both sides start from the same numpy-drawn weights and inputs
(``test_torch_lm._pair``); the config is xlstm-1.3b's smoke config (2
layers: one mLSTM block and one sLSTM block, 2 heads), in ``dense``
embedding mode as the reference's own xlstm test runs it.

Tolerances:

* the mLSTM cells (sequential and chunkwise) and the mLSTM and sLSTM blocks:
  in fp32 within 1e-4 of the largest magnitude (the scans sum in other
  orders: jnp's cumsum and XLA's dots against PyTorch's); in bf16 within the
  LM tolerance, 2e-2 of the largest magnitude (a bf16 rounding that flips on
  one side moves the output by one bf16 step of ~0.8%, and the recurrence
  carries it);
* the LM (forward, prefill, decode and every state leaf): 2e-2 of the
  largest magnitude, as the dense slice (``tests/test_torch_lm.py``);
* the reference's own self-checks, run on the port's functions, at their
  own tolerances (``tests/test_models.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import xlstm as JX  # noqa: E402
from repro.serve.serve_step import make_decode_step as jmake_decode_step  # noqa: E402
from repro.serve.serve_step import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.models.common import log_sigmoid, param_count, take  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from test_torch_lm import TOL, _close, _pair, _tokens  # noqa: E402

ARCH = "xlstm-1.3b"


def _tol(dtype):
    return 1e-4 if dtype == "float32" else TOL


def _cell_inputs(B=2, H=3, S=64, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, dh)).astype(np.float32) for _ in range(3))
    li = (rng.standard_normal((B, H, S)) * 2).astype(np.float32)
    f_pre = (rng.standard_normal((B, H, S)) * 2).astype(np.float32)
    return q, k, v, li, f_pre


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["sequential", "chunkwise"])
def test_mlstm_cell_matches_reference(cell, dtype):
    """One cell over 64 steps from a zero state, then 16 more from the state
    it left; q, k, v in ``dtype``, the gates in fp32 (as the block gives
    them): outputs and every state leaf."""
    q, k, v, li, f_pre = _cell_inputs()
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a).astype(jd) for a in (q, k, v)] + [
        jnp.asarray(li), jax.nn.log_sigmoid(jnp.asarray(f_pre))]
    targs = [torch.from_numpy(a).to(td) for a in (q, k, v)] + [
        torch.from_numpy(li), log_sigmoid(torch.from_numpy(f_pre))]
    _close(targs[4], jargs[4], tol=1e-6)
    jfn = getattr(JX, f"mlstm_{cell}")
    tfn = getattr(TX, f"mlstm_{cell}")
    kw = {"chunk": 16} if cell == "chunkwise" else {}
    jh, jst = jfn(*(a[:, :, :48] for a in jargs), **kw)
    th, tst = tfn(*(a[:, :, :48] for a in targs), **kw)
    assert th.dtype == td
    for g, w in zip((th,) + tuple(tst), (jh,) + tuple(jst)):
        _close(g, w, tol=_tol(dtype))
    jh, jst = jfn(*(a[:, :, 48:] for a in jargs), jst, **kw)
    th, tst = tfn(*(a[:, :, 48:] for a in targs), tst, **kw)
    for g, w in zip((th,) + tuple(tst), (jh,) + tuple(jst)):
        _close(g, w, tol=_tol(dtype))


def _block_case(dtype, kind, seed=0):
    jcfg, tcfg, jp, tp = _pair(ARCH, seed=seed)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    if kind == "mlstm":
        jl = jax.tree.map(lambda a: a[0, 0].astype(jd), jp["mlstm"])
        tl = {k: v.to(td) for k, v in take(take(tp["mlstm"], 0), 0).items()}
    else:
        jl = jax.tree.map(lambda a: a[0].astype(jd), jp["slstm"])
        tl = {k: v.to(td) for k, v in take(tp["slstm"], 0).items()}
    x = np.random.default_rng(seed + 1).standard_normal((2, 17, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jl, tl, jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_matches_reference(kind, dtype):
    """One block (weights in ``dtype``) over 16 steps from a zero state, then
    one decode step from the state it left: outputs and every state leaf."""
    jcfg, tcfg, jl, tl, jx, tx = _block_case(dtype, kind)
    jfn = jax.jit(getattr(JX, f"{kind}_block"), static_argnums=0,
                  static_argnames=("chunk",) if kind == "mlstm" else ())
    tfn = getattr(TX, f"{kind}_block")
    kw = {"chunk": 8} if kind == "mlstm" else {}
    want, jst = jfn(jcfg, jl, jx[:, :16], **kw)
    got, tst = tfn(tcfg, tl, tx[:, :16], **kw)
    assert got.dtype == tx.dtype
    for g, w in zip((got,) + tuple(tst), (want,) + tuple(jst)):
        _close(g, w, tol=_tol(dtype))
    want, jst = jfn(jcfg, jl, jx[:, 16:], state=jst)
    got, tst = tfn(tcfg, tl, tx[:, 16:], state=tst)
    for g, w in zip((got,) + tuple(tst), (want,) + tuple(jst)):
        _close(g, w, tol=_tol(dtype))


def test_mlstm_chunkwise_matches_sequential():
    """The reference's self-check on the port's cells: the chunkwise form
    equals the sequential recurrence within 2e-4 at chunks 8, 32 and 64."""
    q, k, v, li, f_pre = (torch.from_numpy(a) for a in _cell_inputs(seed=1))
    lf = log_sigmoid(f_pre)
    h_seq, st_seq = TX.mlstm_sequential(q, k, v, li, lf)
    for chunk in (8, 32, 64):
        h_chk, st_chk = TX.mlstm_chunkwise(q, k, v, li, lf, chunk=chunk)
        np.testing.assert_allclose(h_seq.numpy(), h_chk.numpy(), atol=2e-4, rtol=2e-4)
        for a, b in zip(st_seq, st_chk):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-4, rtol=2e-4)


def test_xlstm_decode_matches_forward_exactly():
    """The reference's self-check on the port: 16 decode steps from
    ``init_cache`` against the chunked forward (chunk 8), within 3e-2."""
    _, cfg, _, params = _pair(ARCH, seed=2)
    tokens = torch.from_numpy(_tokens(cfg, S=16, seed=3))
    full, _ = TX.forward(cfg, params, tokens, chunk=8)
    cache = TX.init_cache(cfg, 2, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = TX.decode_step(cfg, params, tokens[:, t:t + 1], cache)
        outs.append(lg)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               atol=3e-2, rtol=3e-2)


def test_forward_matches_reference():
    jcfg, tcfg, jp, tp = _pair(ARCH)
    toks = _tokens(jcfg, S=32)
    want, _ = JX.forward(jcfg, jp, jnp.asarray(toks), chunk=8)
    got, aux = TX.forward(tcfg, tp, torch.from_numpy(toks), chunk=8)
    assert got.dtype == torch.float32 and got.shape == (2, 32, jcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_reference():
    """Through the serving factories: the prefill is the forward's last
    logits and no state, as the reference's; then 6 decode steps from
    ``init_cache``, fed the same tokens on both sides, and every state leaf
    after the last."""
    jcfg, tcfg, jp, tp = _pair(ARCH, seed=1)
    toks = _tokens(jcfg, S=64, seed=4)
    want, jstate = jmake_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got, state = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert jstate is None and state is None and got.shape == (2, 1, jcfg.vocab_size)
    _close(got, want)
    jc, tc = JX.init_cache(jcfg, 2), get_model(tcfg).init_cache(tcfg, 2, device="cpu")
    jstep, tstep = jax.jit(jmake_decode_step(jcfg)), make_decode_step(tcfg)
    for t in range(6):
        tok = toks[:, t:t + 1]
        want, jc = jstep(jp, {"token": jnp.asarray(tok)}, jc, None)
        got, tc = tstep(tp, {"token": torch.from_numpy(tok)}, tc, None)
        _close(got, want)
    for jg, tg in ((jc.mlstm, tc.mlstm), (jc.slstm, tc.slstm)):
        for field in jg._fields:
            assert tuple(getattr(tg, field).shape) == getattr(jg, field).shape, field
            _close(getattr(tg, field), getattr(jg, field))


def test_full_width_xlstm_shapes_without_allocating():
    """xlstm-1.3b at its published widths: 6 supersteps of 7 mLSTM blocks and
    one sLSTM block, head dim 1024, and the reference's parameter count."""
    cfg = get_config(ARCH)
    assert TX.layout(cfg) == (6, 7)
    sch = TX.schema(cfg)
    assert sch["mlstm"]["wq"].shape == (6, 7, 4, 1024, 1024)
    assert sch["slstm"]["r_zifo"].shape == (6, 4, 512, 2048)
    assert 1.9e9 < param_count(sch) < 2.1e9
