"""The flash backward's plain version and its kernels' arithmetic, on the CPU.

* ``flash_attention_bwd_plain`` against the reference's own backward,
  ``_flash_bwd`` (``src/repro/kernels/ops.py``: the vector-Jacobian product of
  ``attention_blockwise``), on shared numpy inputs: at the mask cases the card
  tests use (GQA, a window, not causal, cross attention, a chunk at a
  ``q_offset``, rows that keep no key) and at a rank's heads that start
  inside a KV group (``head_offset``), where the reference runs the whole
  heads and is sliced. fp32 within 1e-5 of each gradient's largest
  magnitude; bf16 within 1e-2 (the card's tolerance: both round q, k, v and
  the gradients to bf16, the port's delta also reads the bf16 output).
* The forward's log-sum-exp (``return_lse``) against the reference's
  scores, and its ``+inf`` for rows that keep no key.
* A CPU emulation of the ``hopper`` kernels' roundings (bf16 operands, fp32
  scores and accumulators, p and dS as bf16 hi + lo as tensor-core operands,
  p = exp2 in the log2 domain) within half the card's tolerance, 1e-2 of the
  largest |gradient|, against the plain version on the same o and lse, at
  every head dim the kernels take; p and dS in bf16 alone are further off.
* The variant rule between the backward's kernels (the wgmma + TMA one, the
  mma.sync one asked for by name, the SIMT one) and what each takes.
* On CPU tensors the Function's backward is the plain version, and nothing
  launches.

The kernels themselves are held against the plain version on the card
(``tests/test_torch_cuda.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HOPPER_BWD_HEAD_DIMS,
    MMA_BWD_HEAD_DIMS,
    attention_mask,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_plain,
    flash_bwd_variant,
    flash_bwd_variants,
)
from repro_torch.models.common import kv_heads_read  # noqa: E402

# B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset: the card tests' mask cases
MASK_CASES = {
    "yi_like_gqa": (2, 8, 2, 256, 256, 128, True, 0, 0),
    "hymba_like_window": (1, 5, 1, 300, 300, 64, True, 100, 0),
    "whisper_encoder": (2, 6, 6, 200, 200, 64, False, 0, 0),
    "cross": (2, 6, 6, 40, 300, 64, False, 0, 0),
    "chunk_at_q_offset": (1, 4, 2, 128, 384, 128, True, 0, 256),
    "rows_keep_no_key": (1, 2, 1, 130, 64, 64, True, 0, -40),
    # Nemotron-4-340B's heads at one rank of model = 8: 12 over 1 KV head of 192
    "nemotron_like": (1, 12, 1, 256, 256, 192, True, 0, 0),
}
# H, Hkv, this rank's q heads [lo, hi), S, Dh, causal, window: the card's
# head-offset cases at CPU lengths
OFFSET_CASES = {
    "hymba_rank1_of_2_global": (25, 5, (12, 25), 260, 64, True, 0),
    "hymba_rank1_of_2_swa": (25, 5, (12, 25), 260, 64, True, 100),
    "nemotron_rank1_of_3": (24, 2, (8, 16), 200, 128, True, 0),
    "inside_one_group": (10, 2, (2, 5), 150, 96, False, 0),
}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CARD_TOL = 1e-2  # the card's: chip_smoke.FLASH_BWD_TOL, tests/test_torch_cuda.py


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(B, H, Hkv, Sq, Skv, Dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, Sq, Dh), (B, Hkv, Skv, Dh), (B, Hkv, Skv, Dh), (B, H, Sq, Dh))]


def _reference_grads(q, k, v, g, dtype, **mask):
    """The reference's ``_flash_bwd`` on numpy inputs in ``dtype``."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    res = tuple(jnp.asarray(a, jdt) for a in (q, k, v))
    return jops._flash_bwd(mask["causal"], mask["window"], mask["q_offset"], 128, 128, res,
                           jnp.asarray(g, jdt))


def _plain_grads(q, k, v, g, dtype, **kw):
    tdt = getattr(torch, dtype)
    tq, tk, tv, tg = (torch.from_numpy(a).to(tdt) for a in (q, k, v, g))
    o, lse = flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    return flash_attention_bwd_plain(tq, tk, tv, o, lse, tg, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MASK_CASES))
def test_plain_backward_matches_the_reference_flash_bwd(name, dtype):
    B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset = MASK_CASES[name]
    q, k, v, g = _inputs(B, H, Hkv, Sq, Skv, Dh, seed=Sq + Skv + Dh)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    want = _reference_grads(q, k, v, g, dtype, **mask)
    got = _plain_grads(q, k, v, g, dtype, **mask)
    for n, a, b in zip("qkv", got, want):
        assert a.dtype == getattr(torch, dtype)
        assert _rel(a, np.asarray(b, np.float32)) <= TOL[dtype], f"d{n}"
    if q_offset < 0:  # the first rows keep no key: no gradient
        assert not got[0][:, :, :-q_offset].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OFFSET_CASES))
def test_plain_backward_with_a_head_offset_matches_the_whole_heads(name, dtype):
    """A rank's q heads [lo, hi) that start inside a KV group, with the KV
    heads they read: the reference's backward of the whole heads, with the
    output gradient zero outside [lo, hi), sliced."""
    H, Hkv, (lo, hi), S, Dh, causal, window = OFFSET_CASES[name]
    q, k, v, g = _inputs(1, H, Hkv, S, S, Dh, seed=S + lo)
    g[:, :lo] = 0.0
    g[:, hi:] = 0.0
    mask = dict(causal=causal, window=window, q_offset=0)
    want = _reference_grads(q, k, v, g, dtype, **mask)
    kv_lo, kv_hi, off = kv_heads_read(lo, hi, H // Hkv)
    assert off > 0 or hi - lo < H // Hkv
    local = [a[:, lo:hi].copy() for a in (q, g)]
    got = _plain_grads(local[0], k[:, kv_lo:kv_hi].copy(), v[:, kv_lo:kv_hi].copy(), local[1],
                       dtype, group=H // Hkv, head_offset=off, **mask)
    slices = [(slice(None), slice(lo, hi)), (slice(None), slice(kv_lo, kv_hi)),
              (slice(None), slice(kv_lo, kv_hi))]
    for n, a, b, sl in zip("qkv", got, want, slices):
        assert _rel(a, np.asarray(b, np.float32)[sl]) <= TOL[dtype], f"d{n}"


@pytest.mark.parametrize("name", ["yi_like_gqa", "hymba_like_window", "rows_keep_no_key"])
def test_forward_lse_is_the_rows_log_sum_exp(name):
    """``return_lse``: log(sum exp(s)) over the kept keys (the reference's
    fp32 scores), +inf where a row keeps none; the output is the one
    without it, bit for bit."""
    B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset = MASK_CASES[name]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(B, H, Hkv, Sq, Skv, Dh, seed=1))
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **mask)
    assert torch.equal(out, flash_attention_plain(q, k, v, **mask))
    kk = k.repeat_interleave(H // Hkv, dim=1)
    s = q.double() @ kk.double().transpose(-1, -2) / math.sqrt(Dh)
    keep = attention_mask(Sq, Skv, device="cpu", **mask)
    want = torch.logsumexp(torch.where(keep, s, -torch.inf), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, Sq)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert bool((lse[torch.isinf(lse)] > 0).all())
    fin = torch.isfinite(want)
    torch.testing.assert_close(lse[fin].double(), want[fin], rtol=0, atol=1e-5)
    assert bool(torch.isinf(lse).any()) == (q_offset < 0)


def _hopper_bwd_rounding(q, k, v, o, lse, do, *, causal, window, q_offset, split=True):
    """The hopper backward's arithmetic on bf16 q, k, v, o, dO: fp32 scores
    (exact sums of bf16 products), p = exp2(s * scale log2(e) - lse log2(e))
    zeroed where masked, dP exact, delta the fp32 row sum of dO * o, dS =
    p (dP - delta) in fp32; p as bf16 hi + lo for dV = p^T dO and dS as bf16
    hi + lo for dK = dS^T q and dQ = dS k (``split``; else each hi alone);
    the sums exact, the gradients rounded to bf16 once. GQA by repeating K
    and V and summing dk, dv over a group. The same roundings at every head
    dim: at 192 and 256 one consumer warpgroup hands P^T to the other
    through shared memory in fp32 (exact), and each splits its own operand
    into hi + lo in registers."""
    B, H, Sq, Dh = q.shape
    rep = H // k.shape[1]
    kk, vv = (t.repeat_interleave(rep, dim=1).double() for t in (k, v))
    scale = 1.0 / Dh**0.5
    log2e = 1.4426950408889634
    s = (q.double() @ kk.transpose(-1, -2)).float()
    keep = attention_mask(Sq, k.shape[2], causal=causal, window=window, q_offset=q_offset,
                          device="cpu")
    p = torch.where(keep, torch.exp2(s * (scale * log2e) - lse[..., None] * log2e), 0.0)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    dp = (do.double() @ vv.transpose(-1, -2)).float()
    ds = p * (dp - delta)
    pb, dsb = p.bfloat16().double(), ds.bfloat16().double()
    if split:
        pb = pb + (p - p.bfloat16().float()).bfloat16().double()
        dsb = dsb + (ds - ds.bfloat16().float()).bfloat16().double()
    dv = pb.transpose(-1, -2) @ do.double()
    dk = (dsb.transpose(-1, -2) @ q.double()).float() * scale
    dq = (dsb @ kk).float() * scale
    group = lambda t: t.reshape(B, k.shape[1], rep, *t.shape[2:]).sum(2)
    return dq.bfloat16(), group(dk.double()).float().bfloat16(), group(dv).float().bfloat16()


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 192)])
@pytest.mark.parametrize("dh", HOPPER_BWD_HEAD_DIMS)
def test_flash_bwd_hopper_rounding_holds_the_card_tolerance(dh, causal, window):
    """Why the hopper backward multiplies dS into dK and dQ, and p into dV,
    as bf16 hi + lo: so each of dq, dk and dv stays within half the card's
    tolerance (1e-2 of its largest magnitude) against the plain version on
    the same o and lse. dS in bf16 alone puts dq and dk further off (up to
    three quarters of the tolerance at training shapes, 2,048 keys and
    more), and p in bf16 alone dv (past half the tolerance at head dim 96);
    the split leaves them near the floor that the gradients' own bf16
    rounding sets (2^-9 of the largest)."""
    g = torch.Generator().manual_seed(dh + window)
    B, H, Hkv, S = 1, 8, 2, 512
    mk = lambda *shape: torch.randn(shape, generator=g).bfloat16()
    q, k, v, do = mk(B, H, S, dh), mk(B, Hkv, S, dh), mk(B, Hkv, S, dh), mk(B, H, S, dh)
    mask = dict(causal=causal, window=window, q_offset=0)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **mask)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **mask)
    errs = {split: [_rel(a, b.float()) for a, b in zip(
        _hopper_bwd_rounding(q, k, v, o, lse, do, split=split, **mask), want)]
        for split in (True, False)}
    assert max(errs[True]) <= CARD_TOL / 2 and min(errs[True]) > 0.0, errs
    assert max(errs[False][:2]) > max(errs[True][:2]), errs  # dq, dk
    assert errs[False][2] > errs[True][2], errs  # dv


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


BWD_VARIANT_CASES = {
    # name: a maker of (q, k, v, o, do), the kernel the rule picks
    **{f"bf16_Dh{d}": (lambda d=d: (_bf16(1, 4, 64, d), _bf16(1, 2, 64, d), _bf16(1, 2, 64, d),
                                    _bf16(1, 4, 64, d), _bf16(1, 4, 64, d)), "hopper")
       for d in HOPPER_BWD_HEAD_DIMS},
    "model_views": (lambda: (_bf16(2, 300, 8, 64).transpose(1, 2),
                             *[_bf16(2, 300, 2, 64).transpose(1, 2)] * 2,
                             _bf16(2, 300, 8, 64).transpose(1, 2),
                             _bf16(2, 300, 8, 64).transpose(1, 2)), "hopper"),
    "fp32": (lambda: tuple(torch.zeros(1, h, 64, 128) for h in (4, 2, 2, 4, 4)), "simt"),
    "Dh96": (lambda: tuple(_bf16(1, h, 64, 96) for h in (4, 2, 2, 4, 4)), "hopper"),
    "Dh192": (lambda: tuple(_bf16(1, h, 64, 192) for h in (4, 2, 2, 4, 4)), "hopper"),
    "Dh256": (lambda: tuple(_bf16(1, h, 64, 256) for h in (4, 2, 2, 4, 4)), "hopper"),
    "Dh160": (lambda: tuple(_bf16(1, h, 64, 160) for h in (4, 2, 2, 4, 4)), "simt"),
    "k_stride_0": (lambda: (_bf16(1, 4, 64, 64), *[_bf16(1, 1, 64, 64).expand(1, 2, 64, 64)] * 2,
                            _bf16(1, 4, 64, 64), _bf16(1, 4, 64, 64)), "simt"),
    "Dh16": (lambda: tuple(_bf16(1, h, 64, 16) for h in (4, 2, 2, 4, 4)), "simt"),
    "do_row_stride_not_8": (lambda: (*[_bf16(1, h, 64, 128) for h in (4, 2, 2, 4)],
                                     _bf16(1, 4, 64, 129)[..., :128]), "simt"),
    "unaligned_o": (lambda: (*[_bf16(1, h, 64, 128) for h in (4, 2, 2)],
                             _bf16(1, 4, 64, 136)[..., 4:132], _bf16(1, 4, 64, 128)), "simt"),
    "no_keys": (lambda: tuple(_bf16(1, h, s, 128) for h, s in ((4, 64), (2, 0), (2, 0),
                                                                (4, 64), (4, 64))), "simt"),
}


@pytest.mark.parametrize("name", list(BWD_VARIANT_CASES))
def test_flash_bwd_variant_rule(name):
    """The dispatch rule between the backward's kernels: the wgmma + TMA one
    for bf16 at head dims 64, 96, 128, 192 and 256 where TMA descriptors
    reach every row of q, k, v, o and dO (16-byte aligned data, (b, h, s)
    strides positive multiples of 8 elements, a dim of length 1 exempt, at
    least one key); the SIMT kernel for everything else. The rule never
    picks the mma.sync kernel."""
    build, want = BWD_VARIANT_CASES[name]
    assert flash_bwd_variant(*build()) == want


BWD_TAKES_CASES = {
    # name: a maker of (q, k, v, o, do), the variants that take them
    **{f"bf16_Dh{d}": (lambda d=d: tuple(_bf16(1, h, 64, d) for h in (4, 2, 2, 4, 4)),
                       ("hopper", "mma", "simt") if d in MMA_BWD_HEAD_DIMS else ("hopper", "simt"))
       for d in HOPPER_BWD_HEAD_DIMS},
    "model_views": (BWD_VARIANT_CASES["model_views"][0], ("hopper", "mma", "simt")),
    "fp32": (BWD_VARIANT_CASES["fp32"][0], ("simt",)),
    "Dh16": (BWD_VARIANT_CASES["Dh16"][0], ("simt",)),
    "unaligned_o": (BWD_VARIANT_CASES["unaligned_o"][0], ("simt",)),
}


@pytest.mark.parametrize("name", list(BWD_TAKES_CASES))
def test_flash_bwd_variants_lists_what_takes_the_inputs(name):
    """Every kernel that takes the inputs, the rule's pick first: at head
    dims 64 and 128 the mma.sync kernel can be asked for by name while the
    rule still picks the wgmma + TMA one; at 96, 192 and 256 only hopper and
    simt; SIMT takes anything."""
    build, want = BWD_TAKES_CASES[name]
    ins = build()
    assert flash_bwd_variants(*ins) == want
    assert flash_bwd_variant(*ins) == want[0]


def test_function_backward_on_cpu_is_the_plain_version_and_launches_nothing():
    """On CPU tensors ``ops.flash_attention``'s backward is
    ``flash_attention_bwd_plain`` on the forward's own output and lse, bit
    for bit, with a window, GQA and a head offset; the kernel wrapper
    launches nothing and refuses CPU tensors. Without grad the forward
    writes no lse and saves nothing."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(1, 6, 2, 96, 96, 16, seed=7))
    q = q[:, 1:]  # heads 1..5 of 6 over 2 kv heads: offset 1 in groups of 3
    g = g[:, 1:]
    kw = dict(causal=True, window=40, q_offset=0, group=3, head_offset=1)
    ops.reset_launch_counts()
    mine = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*mine, **kw)
    got = torch.autograd.grad(out, mine, g)
    o, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    assert torch.equal(out.detach(), o)
    for a, b in zip(got, flash_attention_bwd_plain(q, k, v, o, lse, g, **kw)):
        assert torch.equal(a, b)
    assert set(ops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd_cuda(q, k, v, o, lse, g, **kw)
    with torch.no_grad():
        assert ops.flash_attention(*mine, **kw).grad_fn is None
