"""The port's audio family (whisper) against the JAX reference, on the CPU.

Both sides start from the same numpy-drawn weights and inputs
(``test_torch_lm._pair``); the frames (the stub conv frontend's output,
[B, n_frames, d]) come from numpy too. The config is whisper-tiny's smoke
config (2 encoder and 2 decoder layers, d 64, 4 heads, 32 frames), in
``dense`` embedding mode. Encoder states, logits and every cache leaf are
held within 2e-2 of their largest magnitude, as the dense slice
(``tests/test_torch_lm.py``): both compute in bf16 and XLA fuses some
roundings away that eager PyTorch keeps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import whisper as JW  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro.models.whisper import WhisperCache as JWhisperCache  # noqa: E402
from repro.serve.serve_step import make_decode_step as jmake_decode_step  # noqa: E402
from repro.serve.serve_step import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from test_torch_lm import _close, _pair, _tokens  # noqa: E402

ARCH = "whisper-tiny"


def _frames(cfg, B=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _cache_close(jc, tc):
    for group in ("self_kv", "cross_kv"):
        for field in ("k", "v"):
            j, t = getattr(getattr(jc, group), field), getattr(getattr(tc, group), field)
            assert tuple(t.shape) == j.shape, (group, field)
            _close(t, j)


def test_encode_matches_reference():
    jcfg, tcfg, jp, tp = _pair(ARCH)
    fr = _frames(jcfg)
    want = JW.encode(jcfg, jp, jnp.asarray(fr))
    got = TW.encode(tcfg, tp, torch.from_numpy(fr))
    assert got.dtype == torch.bfloat16 and got.shape == (2, jcfg.n_frames, jcfg.d_model)
    _close(got, want)
    np.testing.assert_allclose(TW._sinusoids(1500, 384).numpy(),
                               np.asarray(JW._sinusoids(1500, 384)), atol=2e-3, rtol=0)


def test_forward_matches_reference():
    jcfg, tcfg, jp, tp = _pair(ARCH)
    toks, fr = _tokens(jcfg, S=12), _frames(jcfg)
    want, _ = JW.forward(jcfg, jp, jnp.asarray(toks), jnp.asarray(fr))
    got, aux = TW.forward(tcfg, tp, torch.from_numpy(toks), torch.from_numpy(fr))
    assert got.dtype == torch.float32 and got.shape == (2, 12, jcfg.vocab_size)
    assert float(aux) == 0.0
    _close(got, want)


def test_prefill_and_decode_match_reference():
    """Through the serving factories: the prefill's last logits and its
    self and cross K/V; then the self cache padded by 4 and 4 decode steps,
    fed the same tokens on both sides, and both caches after the last."""
    jcfg, tcfg, jp, tp = _pair(ARCH, seed=1)
    toks, fr = _tokens(jcfg, S=16, seed=2), _frames(jcfg, seed=3)
    jbatch = {"tokens": jnp.asarray(toks[:, :12]), "frames": jnp.asarray(fr)}
    tbatch = {"tokens": torch.from_numpy(toks[:, :12]), "frames": torch.from_numpy(fr)}
    want, jc = jmake_prefill_step(jcfg)(jp, jbatch)
    got, tc = make_prefill_step(tcfg)(tp, tbatch)
    assert got.shape == (2, 1, jcfg.vocab_size) and tc.cross_kv.k.shape[3] == jcfg.n_frames
    _close(got, want)
    _cache_close(jc, tc)
    jc = JWhisperCache(JKVCache(*(jnp.pad(a, ((0, 0),) * 3 + ((0, 4), (0, 0)))
                                  for a in jc.self_kv)), jc.cross_kv)
    tc = TW.WhisperCache(KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 4))
                                   for a in tc.self_kv)), tc.cross_kv)
    jstep, tstep = jax.jit(jmake_decode_step(jcfg)), make_decode_step(tcfg)
    for t in range(12, 16):
        tok = toks[:, t:t + 1]
        want, jc = jstep(jp, {"token": jnp.asarray(tok)}, jc, jnp.int32(t))
        got, tc = tstep(tp, {"token": torch.from_numpy(tok)}, tc, t)
        _close(got, want)
    _cache_close(jc, tc)


def test_prefill_decode_continuity():
    """Prefill S-1 prompt tokens, decode the last one, against the forward's
    last logits, within 3e-2 as the reference's hymba continuity check."""
    _, cfg, _, params = _pair(ARCH, seed=2)
    toks = torch.from_numpy(_tokens(cfg, S=12, seed=4))
    fr = torch.from_numpy(_frames(cfg, seed=5))
    full, _ = TW.forward(cfg, params, toks, fr)
    _, cache = TW.prefill(cfg, params, toks[:, :-1], fr)
    cache = TW.WhisperCache(KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 1))
                                      for a in cache.self_kv)), cache.cross_kv)
    dec, _ = TW.decode_step(cfg, params, toks[:, -1:], cache, 11)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(), atol=3e-2, rtol=3e-2)


def test_full_width_whisper_tiny_shapes_without_allocating():
    cfg = get_config(ARCH)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.n_frames, cfg.vocab_size) == (4, 4, 384, 6, 64, 1536, 1500, 51865)
    sch = TW.schema(cfg)
    assert sch["dec_pos"].shape == (65536, 384)
    # the reference's count adds the PS-held tok_emb and leaves out the decoder
    # position table and the final LayerNorms
    n = param_count(sch)
    assert n > cfg.param_count() - cfg.vocab_size * cfg.d_model
