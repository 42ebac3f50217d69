"""The port's hybrid family (hymba, with its mamba heads) against the JAX
reference, on the CPU.

Both sides start from the same weights: a parameter pytree laid out by the
reference's schema and drawn with numpy at ``init``'s scales
(``test_torch_lm._np_params``), given to JAX as is and to the port through
``convert.lm_params_from_numpy``; inputs come from numpy. The config is
hymba-1.5b's smoke config (2 layers, layer 0 global, layer 1 sliding-window
of 32, 8 meta tokens), in ``dense`` embedding mode as the reference's own
hymba test runs it.

Tolerances:

* the mamba mixer alone, on one set of fp32 or bf16 weights: within 1e-4
  of the largest magnitude (the reference's own chunked-vs-recurrent
  tolerance); its bf16 mixer equals the reference's eager one bit for bit,
  and the scans sum in other orders only in fp32;
* the LM (forward, prefill logits and every cache leaf, decode): within
  2e-2 of the largest magnitude, as the dense slice
  (``tests/test_torch_lm.py``): both compute in bf16 and XLA fuses some
  roundings away that eager PyTorch keeps.
* the reference's own self-checks, run on the port's functions, at their
  own tolerances (``tests/test_models.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import hymba as JH  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.serve.serve_step import make_decode_step as jmake_decode_step  # noqa: E402
from repro.serve.serve_step import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import hymba as TH  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models.common import param_count, silu  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from test_torch_lm import _close, _f32, _pair, _tokens  # noqa: E402

ARCH = "hymba-1.5b"


def _leaf_pairs(jc, tc):
    """(name, reference leaf, port leaf) for every leaf of a HymbaCache."""
    for group in ("swa", "glb", "ssm_swa", "ssm_glb"):
        jg, tg = getattr(jc, group), getattr(tc, group)
        for field in jg._fields:
            yield f"{group}.{field}", getattr(jg, field), getattr(tg, field)


def _cache_close(jc, tc):
    for name, j, t in _leaf_pairs(jc, tc):
        assert tuple(t.shape) == tuple(j.shape), name
        if float(np.abs(_f32(j)).max()) == 0.0:  # a leaf no position has filled
            assert float(np.abs(_f32(t)).max()) == 0.0, name
        else:
            _close(t, j)


# ------------------------------------------------------------------ mamba


def _mamba_params(d, N, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, spec in JMB.mamba_schema(d, N).items():
        if spec.init in ("zeros", "ones"):
            out[name] = np.full(spec.shape, float(spec.init == "ones"), np.float32)
        else:
            fan = spec.shape[spec.fan_axis]
            scale = spec.scale if spec.scale is not None else 1 / math.sqrt(fan)
            out[name] = (rng.standard_normal(spec.shape) * scale).astype(np.float32)
    out["a_log"] = (rng.standard_normal(out["a_log"].shape) * 0.5).astype(np.float32)
    out["dt_bias"] = (rng.standard_normal(out["dt_bias"].shape) * 0.5).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_matches_reference_chunked_and_decode(dtype):
    """The mixer over 48 steps (3 chunks of 16, from a zero state), then one
    recurrent decode step from the state it left: outputs and both state
    leaves."""
    p = _mamba_params(32, 4, seed=0)
    x = np.random.default_rng(1).standard_normal((2, 48, 32)).astype(np.float32)
    x1 = np.random.default_rng(2).standard_normal((2, 1, 32)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jd) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in p.items()}
    jmixer = jax.jit(JMB.mamba_mixer, static_argnames=("chunk",))
    want, jst = jmixer(jp, jnp.asarray(x).astype(jd), chunk=16)
    got, tst = TMB.mamba_mixer(tp, torch.from_numpy(x).to(td), chunk=16)
    assert got.dtype == td and tst.h.dtype == torch.float32
    for g, w in ((got, want), (tst.h, jst.h), (tst.conv, jst.conv)):
        _close(g, w, tol=1e-4)
    want1, jst1 = jmixer(jp, jnp.asarray(x1).astype(jd), state=jst)
    got1, tst1 = TMB.mamba_mixer(tp, torch.from_numpy(x1).to(td), state=tst)
    for g, w in ((got1, want1), (tst1.h, jst1.h), (tst1.conv, jst1.conv)):
        _close(g, w, tol=1e-4)


def test_mamba_chunked_matches_recurrent():
    """The reference's self-check (``tests/test_models.py``) on the port's
    scans: the chunked scan (log-depth pair scan per chunk) equals the
    exact recurrence within 1e-4, outputs and final state."""
    p = {k: torch.from_numpy(v) for k, v in _mamba_params(32, 4, seed=3).items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, 32)).astype(np.float32))
    din = p["out_proj"].shape[0]
    xz = x @ p["in_proj"]
    xin, _ = TMB._conv_causal(xz[..., :din], p["conv_w"], p["conv_b"])
    xin = silu(xin)
    dt, B_t, C_t, A = TMB._ssm_inputs(p, xin)
    y_rec, h_rec = TMB._scan_recurrent(xin, dt, B_t, C_t, A, None)
    y_chk, h_chk = TMB._scan_chunked(xin, dt, B_t, C_t, A, None, chunk=16)
    np.testing.assert_allclose(y_rec.numpy(), y_chk.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h_rec.numpy(), h_chk.numpy(), atol=1e-4, rtol=1e-4)


def test_linear_scan_is_the_reference_combine():
    """The doubling scan equals a left fold of the reference's ``combine``
    over every prefix, for lengths that are not powers of two too."""
    g = torch.Generator().manual_seed(0)
    for Q in (1, 5, 16):
        d = torch.rand((2, Q, 3), generator=g)
        v = torch.randn((2, Q, 3), generator=g)
        D, V = TMB._linear_scan(d, v)
        acc_d, acc_v = d[:, 0], v[:, 0]
        for j in range(Q):
            if j:
                acc_d, acc_v = acc_d * d[:, j], d[:, j] * acc_v + v[:, j]
            torch.testing.assert_close(D[:, j], acc_d)
            torch.testing.assert_close(V[:, j], acc_v)


# ------------------------------------------------------------------ hymba


def test_forward_matches_reference():
    jcfg, tcfg, jp, tp = _pair(ARCH)
    toks = _tokens(jcfg, S=40)
    want, _ = JH.forward(jcfg, jp, jnp.asarray(toks))
    got, aux = TH.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 40, jcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)


@pytest.mark.parametrize("S", [12, 40])
def test_prefill_matches_reference(S):
    """Through ``make_prefill_step``: last logits and every cache leaf. At
    S=12 the 20 positions (with the meta tokens) are padded into the ring of
    32; at S=40 the last 32 of 48 are rolled so slot = position % 32."""
    jcfg, tcfg, jp, tp = _pair(ARCH)
    toks = _tokens(jcfg, S=S, seed=S)
    want, jc = jmake_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got, tc = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert tc.swa.k.dtype == torch.bfloat16 and tc.swa.k.shape[3] == jcfg.window
    _close(got, want)
    _cache_close(jc, tc)


def test_decode_matches_reference_teacher_forced():
    """Prefill 28 tokens (36 positions) with room for 8 more, then decode 8
    fed the same tokens on both sides through ``make_decode_step``: every
    step's logits, and every cache leaf after the last, the ring having
    wrapped past slot 31."""
    jcfg, tcfg, jp, tp = _pair(ARCH)
    toks = _tokens(jcfg, S=36, seed=5)
    n0 = jcfg.n_meta_tokens + 28
    _, jc = JH.prefill(jcfg, jp, jnp.asarray(toks[:, :28]), max_len=n0 + 8)
    _, tc = get_model(tcfg).prefill(tcfg, tp, torch.from_numpy(toks[:, :28]), max_len=n0 + 8)
    jstep, tstep = jax.jit(jmake_decode_step(jcfg)), make_decode_step(tcfg)
    for t in range(28, 36):
        tok = toks[:, t:t + 1]
        want, jc = jstep(jp, {"token": jnp.asarray(tok)}, jc, jnp.int32(n0 + t - 28))
        got, tc = tstep(tp, {"token": torch.from_numpy(tok)}, tc, n0 + t - 28)
        _close(got, want)
    _cache_close(jc, tc)


def test_init_cache_decodes_like_reference():
    """Decode from ``init_cache`` (empty ring, empty global cache, zero mamba
    states) against the reference's."""
    jcfg, tcfg, jp, tp = _pair(ARCH, seed=1)
    toks = _tokens(jcfg, S=4, seed=6)
    jc = JH.init_cache(jcfg, 2, 8)
    tc = get_model(tcfg).init_cache(tcfg, 2, 8, device="cpu")
    for name, j, t in _leaf_pairs(jc, tc):
        assert tuple(t.shape) == tuple(j.shape) and t.dtype == getattr(torch, str(j.dtype)), name
    jstep = jax.jit(lambda p, tok, c, pos: JH.decode_step(jcfg, p, tok, c, pos))
    for t in range(4):
        want, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc, jnp.int32(t))
        got, tc = TH.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), tc, t)
        _close(got, want)


def test_hymba_prefill_decode_continuity():
    """The reference's self-check on the port: prefill S-1 tokens, decode
    the last one, against the forward's last logits (3e-2)."""
    _, cfg, _, params = _pair(ARCH, seed=2)
    B, S = 2, 12
    tokens = torch.from_numpy(_tokens(cfg, B=B, S=S, seed=7))
    full, _ = TH.forward(cfg, params, tokens)
    total = cfg.n_meta_tokens + S
    _, cache = TH.prefill(cfg, params, tokens[:, :S - 1], max_len=total)
    dec, _ = TH.decode_step(cfg, params, tokens[:, S - 1:], cache, total - 1)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), atol=3e-2, rtol=3e-2)


def test_cpu_path_launches_no_kernel_and_full_width_counts():
    """On CPU tensors nothing launches; hymba-1.5b's schema at its published
    widths counts what the reference counts (no tensor is made)."""
    _, tcfg, _, tp = _pair(ARCH)
    ops.reset_launch_counts()
    make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(_tokens(tcfg, S=40))})
    assert set(ops.launch_counts().values()) == {0}
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.ssm_state, cfg.window, cfg.global_attn_layers, cfg.n_meta_tokens,
            cfg.vocab_size) == (32, 1600, 25, 5, 64, 5504, 16, 1024, (0, 15, 31), 128, 32001)
    n = param_count(TH.schema(cfg))
    assert 1.6e9 < n < 1.7e9
