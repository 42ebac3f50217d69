"""The port's MoE and VLM serving slice against the JAX reference, on the CPU.

The grouped matmul: the port's ``ops.gmm`` (its plain version on CPU
tensors) against the reference's ``ops.gmm`` with the Pallas kernel in
interpret mode, at the reference's own tolerance (2e-4), and the tile plan
the CUDA kernel's wrapper builds (:func:`gmm_tiles`), emulated tile by tile.

The MoE block and the LM: both sides start from the same weights, drawn
with numpy at the reference's ``init`` scales (``test_torch_lm._np_params``)
and converted with ``convert.lm_params_from_numpy``; inputs come from numpy.
Both compute in bf16 and sum in other orders, so logits are held within 2e-2
of their largest magnitude, as the dense slice's (``tests/test_torch_lm.py``).
A bf16 rounding that differs between the two can move a router logit, and
with it a token's expert, only where two experts' probabilities are within
a rounding of each other; the configs are the smoke configs of olmoe-1b-7b
(8 experts top-2), phi3.5-moe (4 experts top-2, GQA) and pixtral-12b (the
VLM: image embeddings before the tokens). Over 10 weight seeds the worst
forward error was 0.0087 (olmoe), 0.0081 (phi3.5-moe) and 0.0062 (pixtral)
of the largest logit. On the CPU the port runs the
kernels' plain versions; the kernels themselves are held against those on
the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.attention import KVCache as JKVCache  # noqa: E402
from repro.serve import ServingCluster as JServingCluster  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.serve_step import greedy_sample as jgreedy_sample  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy, publish_arrays  # noqa: E402
from repro_torch.core.tables import RowSchema, TableSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.moe_gmm import TILE_ROWS, gmm_plain, gmm_tiles, gmm_variant  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.common import param_count  # noqa: E402
from repro_torch.serve import ServingCluster, ServingEngine  # noqa: E402
from repro_torch.serve.serve_step import (  # noqa: E402
    greedy_sample,
    make_decode_step,
    make_prefill_step,
)
from test_torch_lm import TOL, _close, _f32, _pair, _tokens  # noqa: E402

MOE = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]
ALL = MOE + ["pixtral-12b"]


# ------------------------------------------------------------------ gmm


@pytest.mark.parametrize("E,K,N,sizes", [
    (4, 128, 128, [100, 0, 300, 56]),
    (3, 256, 128, [128, 128, 128]),
    (5, 128, 256, [7, 250, 1, 0, 130]),
])
def test_gmm_matches_reference_pallas(E, K, N, sizes):
    """The reference's test_gmm_vs_ref shapes, on numpy inputs: the port's
    ``ops.gmm`` (plain on the CPU) against the Pallas kernel in interpret
    mode and against ``ref.gmm_ref``, within 2e-4."""
    rng = np.random.default_rng(E * K + N)
    x = rng.standard_normal((sum(sizes), K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    gs = np.array(sizes, np.int32)
    want = np.asarray(jops.gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                               use_pallas=True, interpret=True))
    got = ops.gmm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    assert got.dtype == torch.float32 and got.shape == (sum(sizes), N)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.gmm_ref(x, w, gs)),
                               atol=2e-4, rtol=2e-4)


GROUPINGS = [[0, 5], [7, 0, 3], [60, 60], [1, 1, 1, 1, 1, 1], [0, 0, 9, 0], [33, 17, 0, 50, 2]]


@pytest.mark.parametrize("sizes", GROUPINGS)
def test_gmm_group_isolation(sizes):
    """The reference's property test: zeroing one expert's weights zeroes
    exactly that group's rows."""
    rng = np.random.default_rng(sum(sizes))
    T = sum(sizes)
    x = torch.from_numpy(rng.standard_normal((T, 128)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((len(sizes), 128, 128)).astype(np.float32))
    w[0] = 0.0
    out = ops.gmm(x, w, torch.tensor(sizes, dtype=torch.int32))
    assert torch.equal(out[: sizes[0]], torch.zeros_like(out[: sizes[0]]))
    assert T == sizes[0] or bool((out[sizes[0]:] != 0).any())


@pytest.mark.parametrize("sizes,extra", [(g, 0) for g in GROUPINGS]
                         + [([10, 0, 4], 23), ([300, 0], 1), ([5, 9], -6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_tile_plan_covers_each_row_once(sizes, extra, dtype):
    """The CUDA wrapper's tile plan at the kernel's tile rows: every row in
    exactly one tile, each tile inside one group, at most ``ceil(T / bt) +
    E`` tiles; computing each tile's rows with its group's weights (the
    kernel's work, emulated) equals the plain version, also where the groups
    end before row T (zeros past them) or run past it (cut at T)."""
    bt = TILE_ROWS[dtype]
    T = sum(sizes) + extra
    E = len(sizes)
    gs = torch.tensor(sizes, dtype=torch.int32)
    plan = gmm_tiles(gs, T, bt)
    assert plan.dtype == torch.int32 and plan.shape == (3, -(-T // bt) + E)
    bounds = np.cumsum([0] + sizes)
    rng = np.random.default_rng(T)
    x = torch.from_numpy(rng.standard_normal((T, 24)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((E, 24, 8)).astype(np.float32)).to(dtype)
    out = torch.full((T, 8), float("nan"), dtype=dtype)
    for g, r0, r1 in plan.T.tolist():
        if r1 <= r0:
            continue
        assert 0 <= r0 < r1 <= T and r1 - r0 <= bt
        assert torch.isnan(out[r0:r1].float()).all(), "a row in two tiles"
        if g < E:
            assert bounds[g] <= r0 and r1 <= bounds[g + 1]
            out[r0:r1] = (x[r0:r1].float() @ w[g].float()).to(dtype)
        else:
            assert g == E and r0 >= bounds[-1]
            out[r0:r1] = 0
    assert torch.equal(out, gmm_plain(x, w, gs))


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("name,x,w,want", [
    ("f32", torch.zeros(256, 64), torch.zeros(4, 64, 128), "f32"),
    ("bf16_contiguous", _bf16((256, 2048)), _bf16((64, 2048, 1024)), "hopper"),
    ("bf16_N_not_256", _bf16((100, 64)), _bf16((3, 64, 72)), "hopper"),
    ("bf16_single_expert_any_E_stride", _bf16((9, 16)), _bf16((2, 16, 24))[1:], "hopper"),
    ("bf16_K_not_8", _bf16((100, 100)), _bf16((3, 100, 64)), "wmma"),
    ("bf16_N_not_8", _bf16((100, 64)), _bf16((3, 64, 13)), "wmma"),
    ("bf16_x_offset_3_columns", _bf16((130, 67))[:, 3:], _bf16((5, 64, 96)), "wmma"),
    ("bf16_x_row_stride_67", _bf16((130, 67))[:, :64], _bf16((5, 64, 96)), "wmma"),
    ("bf16_w_offset_3_N", _bf16((130, 64)), _bf16((5, 64, 99))[:, :, 3:], "wmma"),
    ("bf16_w_layer_of_a_stack", _bf16((130, 64)), _bf16((2, 5, 64, 96))[1], "hopper"),
    ("bf16_K_0", _bf16((5, 0)), _bf16((2, 0, 8)), "wmma"),
    # dx's w^T: the view of w [E, K, N] transposed, unit stride over its depth
    ("bf16_w_k_major_view", _bf16((100, 1024)), _bf16((4, 1024, 2048)).transpose(1, 2),
     "hopper"),
    ("bf16_w_k_major_stride_67", _bf16((100, 64)), _bf16((3, 96, 67))[:, :, :64].transpose(1, 2),
     "wmma"),
])
def test_gmm_variant_picks_by_layout(name, x, w, want):
    """The Hopper kernel takes what a TMA descriptor can describe (bf16, K
    and N multiples of 8, 16-byte aligned data, strides multiples of 8
    elements, w N-major or K-major); other bf16 layouts the wmma kernel,
    fp32 the f32 kernel."""
    assert gmm_variant(x, w) == want


def test_gmm_backward_hands_the_kernel_a_view_of_w():
    """``ops.gmm``'s dx is ``gmm(dy, w^T)`` over the view ``w.transpose(1,
    2)``: the same storage as w (same ``data_ptr``), unit stride over the
    product's depth, K-major, which the hopper kernel reads where it lies;
    no transposed copy is made, and the gradients are autograd's of the
    plain version, bit for bit."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((40, 64)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 64, 48)).astype(np.float32)).bfloat16()
    gs, dy = torch.tensor([10, 0, 30]), torch.from_numpy(
        rng.standard_normal((40, 48)).astype(np.float32)).bfloat16()
    calls, real = [], ops._gmm

    def spy(a, b, group_sizes, tiles, mode="forward"):
        calls.append((mode, b))
        return real(a, b, group_sizes, tiles, mode=mode)

    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_gmm", spy)
        got = torch.autograd.grad(ops.gmm(xk, wk, gs), (xk, wk), dy)
    (_, wt), = [c for c in calls if c[0] == "dx"]
    assert wt.data_ptr() == wk.data_ptr() and wt.shape == (3, 48, 64)
    assert wt.stride() == (64 * 48, 1, 48)
    assert gmm_variant(dy, wt) == "hopper"
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(gmm_plain(xp, wp, gs), (xp, wp), dy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_plain_dx_over_the_view_equals_the_copy(dtype):
    """The plain version over the view of w transposed gives the bits it
    gives over its contiguous copy: dx needs no copy on either path."""
    rng = np.random.default_rng(4)
    dy = torch.from_numpy(rng.standard_normal((300, 96)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((5, 128, 96)).astype(np.float32)).to(dtype)
    gs = torch.tensor([70, 0, 130, 1, 99])
    assert torch.equal(gmm_plain(dy, w.transpose(1, 2), gs),
                       gmm_plain(dy, w.transpose(1, 2).contiguous(), gs))


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_builds_one_tile_plan_per_layer(arch, monkeypatch):
    """A layer's two or three gmm products get the same plan, built once
    from the kept rows per expert at the dtype's row tile; emulated tile by
    tile (as ``test_gmm_tile_plan_covers_each_row_once``) with each product's
    own operands, it gives the plain version's output."""
    _, tcfg, _, tp = _moe_pair(arch)
    _, tx = _moe_input(tcfg, B=2, S=40)
    calls, real = [], ops.gmm

    def gmm(x, w, gs, *, tiles=None):
        calls.append((x, w, gs, tiles))
        return real(x, w, gs, tiles=tiles)

    monkeypatch.setattr(ops, "gmm", gmm)
    TM.moe_block(tx, tp, tcfg)
    n_products = 3 if tcfg.mlp_act == "swiglu" else 2
    assert len(calls) == n_products and all(c[3] is calls[0][3] for c in calls)
    r = TM.route(tx.reshape(-1, tcfg.d_model), tp["router"], tcfg)
    plan = calls[0][3]
    assert torch.equal(plan, gmm_tiles(r.expert_rows, r.n_rows, TILE_ROWS[torch.bfloat16]))
    for x, w, gs, _ in calls:
        assert torch.equal(gs, r.expert_rows) and x.shape[0] == r.n_rows
        out = torch.full((x.shape[0], w.shape[2]), float("nan"), dtype=x.dtype)
        for g, r0, r1 in plan.T.tolist():
            if r1 > r0:
                out[r0:r1] = (x[r0:r1].float() @ w[g].float()).to(x.dtype) if g < len(gs) else 0
        assert torch.equal(out, gmm_plain(x, w, gs))


# ------------------------------------------------------------ moe_block


def _moe_pair(arch, seed=0):
    """(reference cfg, port cfg, one layer's reference params as bf16 jnp,
    the same as bf16 torch): the layer as the model's ``_cast`` gives it."""
    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    rng = np.random.default_rng(seed)
    layer = {}
    for name, spec in JM.moe_schema(jcfg, layers=0).items():
        layer[name] = (rng.standard_normal(spec.shape) / np.sqrt(spec.shape[spec.fan_axis])
                       ).astype(np.float32)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in layer.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in layer.items()}
    return jcfg, tcfg, jp, tp


def _moe_input(cfg, B=2, S=16, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_matches_reference(arch):
    jcfg, tcfg, jp, tp = _moe_pair(arch)
    jx, tx = _moe_input(jcfg)
    want, jaux = JM.moe_block(jx, jp, jcfg)
    got, aux = TM.moe_block(tx, tp, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    _close(got, np.asarray(want, np.float32))
    assert float(aux) == pytest.approx(float(jaux), rel=1e-3)


def _reference_keep(jx, router, cfg, G, C):
    """The reference's drop mask, from its own router ops (f32 logits,
    softmax, ``lax.top_k``) and its capacity rule: an assignment is kept
    when fewer than C earlier assignments (token-major, within its group of
    T*k/G) went to its expert."""
    T = jx.shape[0] * jx.shape[1]
    probs = jax.nn.softmax(jx.reshape(T, -1).astype(jnp.float32) @ router.astype(jnp.float32))
    top_i = np.asarray(jax.lax.top_k(probs, cfg.top_k)[1]).reshape(G, -1)
    keep = np.zeros(top_i.shape, bool)
    for g in range(G):
        seen = np.zeros(cfg.n_experts, int)
        for j, e in enumerate(top_i[g]):
            keep[g, j] = seen[e] < C
            seen[e] += 1
    return keep.reshape(-1)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("groups,capacity", [(1, 2), (4, 1)])
def test_moe_block_drops_as_the_reference(arch, groups, capacity):
    """With a capacity that overflows, the port drops the same assignments
    as the reference (its routing ops and capacity rule), a token whose
    assignments all dropped comes out 0 on both sides, and the outputs
    agree."""
    jcfg, tcfg, jp, tp = _moe_pair(arch, seed=3)
    jx, tx = _moe_input(jcfg, seed=4)
    want, jaux = JM.moe_block(jx, jp, jcfg, capacity=capacity, groups=groups)
    got, aux = TM.moe_block(tx, tp, tcfg, capacity=capacity, groups=groups)
    r = TM.route(tx.reshape(-1, tcfg.d_model), tp["router"], tcfg, capacity=capacity,
                 groups=groups)
    assert (r.groups, r.capacity) == (groups, capacity)
    keep = _reference_keep(jx, jp["router"], jcfg, groups, capacity)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    assert 0 < int((~r.keep).sum()) < keep.size  # some drop, some stay
    dropped = ~keep.reshape(-1, tcfg.top_k).any(axis=1)
    want32 = np.asarray(want, np.float32).reshape(-1, tcfg.d_model)
    got32 = got.float().reshape(-1, tcfg.d_model).numpy()
    assert (want32[dropped] == 0).all() and (got32[dropped] == 0).all()
    _close(got, np.asarray(want, np.float32))
    assert float(aux) == pytest.approx(float(jaux), rel=1e-3)


def _tied_router(kind, jcfg, rng):
    """A router whose experts tie: all zero, or three column patterns on a
    1/8 grid repeated over the experts (expert e takes pattern e % 3)."""
    E = jcfg.n_experts
    if kind == "zero":
        return np.zeros((jcfg.d_model, E), np.float32)
    patterns = rng.integers(-4, 5, size=(jcfg.d_model, 3)) / 8.0
    return patterns[:, np.arange(E) % 3].astype(np.float32)


@pytest.mark.parametrize("kind", ["zero", "eighths"])
def test_router_ties_take_the_lower_expert_as_lax_top_k(kind):
    """Among experts of equal probability the port routes to the lower
    index first, as ``jax.lax.top_k`` does: the indices are equal exactly,
    and so are the outputs (within the file's bound) and the aux loss. The
    input sits on a 1/8 grid, so every logit is exact in fp32 and equal
    columns give equal probabilities bitwise on both sides."""
    jcfg, tcfg, jp, tp = _moe_pair("olmoe-1b-7b", seed=5)
    rng = np.random.default_rng(6)
    router = _tied_router(kind, jcfg, rng)
    jp["router"] = jnp.asarray(router).astype(jnp.bfloat16)
    tp["router"] = torch.from_numpy(router).to(torch.bfloat16)
    x = (rng.integers(-8, 9, size=(2, 16, jcfg.d_model)) / 8.0).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    T = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(jx.reshape(T, -1).astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32))
    want_i = np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])
    assert len(np.unique(np.asarray(probs)[0])) < jcfg.n_experts  # the experts do tie
    r = TM.route(tx.reshape(T, -1), tp["router"], tcfg)
    np.testing.assert_array_equal(r.top_i.numpy(), want_i)
    want, jaux = JM.moe_block(jx, jp, jcfg)
    got, aux = TM.moe_block(tx, tp, tcfg)
    _close(got, np.asarray(want, np.float32))
    assert float(aux) == pytest.approx(float(jaux), rel=1e-3)


def test_moe_block_dispatch_shapes_at_full_width():
    """OLMoE-1B-7B's capacity at a 4 x 2048 prefill and a 4-token decode
    step: 32 dispatch groups of capacity 40 ([64, 1280, d] buffer), and 4
    groups of capacity 8 ([64, 32, d])."""
    cfg = get_config("olmoe-1b-7b")
    assert (cfg.n_experts, cfg.top_k, cfg.capacity_factor) == (64, 8, 1.25)
    assert TM.expert_capacity(cfg, 8192, 32) == 40
    assert TM.expert_capacity(cfg, 4, 4) == 8
    g = torch.Generator().manual_seed(0)
    for T, G, C in ((8192, 32, 40), (4, 4, 8)):
        r = TM.route(torch.randn(T, 4, generator=g), torch.randn(4, 64, generator=g), cfg)
        assert (r.groups, r.capacity) == (G, C)
        assert r.slot.shape == (T * cfg.top_k,)
        kept = r.slot[r.keep]
        assert int(kept.max()) < 64 * G * C and kept.unique().numel() == kept.numel()
        assert torch.equal(r.slot[~r.keep], torch.full_like(r.slot[~r.keep], 64 * G * C))


@pytest.mark.parametrize("T,G,C", [(8192, 32, 40), (4, 4, 8)])
def test_route_compacted_rows_cover_each_kept_assignment_once(T, G, C):
    """OLMoE-1B-7B's routing at a 4 x 2048 prefill and a 4-token decode step:
    every kept assignment has one row of the compacted buffer, the rows run
    expert by expert in the capacity buffer's (group, position) order with
    no gap, ``expert_rows`` counts them, and a drop carries the sentinel
    ``n_rows = min(T*k, E*G*C)``."""
    cfg = get_config("olmoe-1b-7b")
    E, k = cfg.n_experts, cfg.top_k
    g = torch.Generator().manual_seed(T)
    r = TM.route(torch.randn(T, 4, generator=g), torch.randn(4, E, generator=g), cfg)
    assert (r.groups, r.capacity, r.n_rows) == (G, C, min(T * k, E * G * C))
    assert r.row.shape == (T * k,) and r.row.dtype == torch.int64
    assert r.expert_rows.shape == (E,) and r.expert_rows.dtype == torch.int32
    n_kept = int(r.keep.sum())
    assert int(r.expert_rows.sum()) == n_kept and n_kept <= r.n_rows
    assert torch.equal(r.expert_rows.long(),
                       torch.bincount(r.top_i.reshape(-1)[r.keep], minlength=E))
    # the capacity slot grows with (expert, group, position): ordering the
    # kept assignments by it must give rows 0, 1, ..., n_kept - 1
    order = torch.argsort(r.slot[r.keep])
    assert torch.equal(r.row[r.keep][order], torch.arange(n_kept))
    assert torch.equal(r.row[~r.keep], torch.full_like(r.row[~r.keep], r.n_rows))
    if T == 8192:
        assert 0 < n_kept < T * k  # this routing drops some assignments


@pytest.mark.parametrize("arch,capacity,groups", [("olmoe-1b-7b", None, None),
                                                  ("olmoe-1b-7b", 8, 1),
                                                  ("phi3.5-moe-42b-a6.6b", None, None)])
def test_moe_block_compacted_equals_padded_layout(arch, capacity, groups):
    """``moe_block`` (the compacted buffer) against the same routing through
    the reference's capacity-buffer layout, both through ``gmm_plain``:
    within the slice's 2e-2 (the same products over other row blocks)."""
    _, tcfg, _, tp = _moe_pair(arch)
    _, tx = _moe_input(tcfg, B=2, S=32)
    got, aux = TM.moe_block(tx, tp, tcfg, capacity=capacity, groups=groups)
    xf = tx.reshape(-1, tcfg.d_model)
    r = TM.route(xf, tp["router"], tcfg, capacity=capacity, groups=groups)
    E, G, C = tcfg.n_experts, r.groups, r.capacity
    padded = TM.run_experts(xf, tp, tcfg, r, r.slot, E * G * C,
                            torch.full((E,), G * C, dtype=torch.int32))
    assert capacity is None or not bool(r.keep.all())
    assert r.n_rows == min(r.row.shape[0], E * G * C)
    _close(got.reshape(padded.shape), padded.float().numpy())
    assert float(aux) == float(r.aux)


# -------------------------------------------------------------- the LM


def _image_embeds(cfg, B=2, seed=2):
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


def _kw(img, side):
    if img is None:
        return {}
    return {"image_embeds": jnp.asarray(img) if side == "jax" else torch.from_numpy(img)}


@pytest.mark.parametrize("arch", ALL)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    img = _image_embeds(jcfg)
    want, jaux = JT.forward(jcfg, jp, jnp.asarray(toks), **_kw(img, "jax"))
    got, aux = get_model(tcfg).forward(tcfg, tp, torch.from_numpy(toks), **_kw(img, "torch"))
    n_img = 0 if img is None else img.shape[1]
    assert got.dtype == torch.float32 and got.shape == (2, 12 + n_img, jcfg.vocab_size)
    _close(got.numpy(), np.asarray(want))
    if tcfg.is_moe:
        assert float(aux) > 0 and float(aux) == pytest.approx(float(jaux), rel=1e-3)
    else:
        assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ALL)
def test_prefill_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    img = _image_embeds(jcfg)
    want, jcache = JT.prefill(jcfg, jp, jnp.asarray(toks), **_kw(img, "jax"))
    batch = {"tokens": torch.from_numpy(toks), **_kw(img, "torch")}
    got, cache = make_prefill_step(tcfg)(tp, batch)
    assert got.shape == (2, 1, jcfg.vocab_size)
    assert cache.k.dtype == torch.bfloat16 and tuple(cache.k.shape) == jcache.k.shape
    _close(got.numpy(), np.asarray(want))
    _close(_f32(cache.k), _f32(jcache.k))
    _close(_f32(cache.v), _f32(jcache.v))


@pytest.mark.parametrize("arch", ALL)
def test_decode_matches_reference_teacher_forced(arch):
    """Prefill (the image and) 8 tokens, then decode the next 4 fed the same
    tokens on both sides; every step's logits and the final caches agree,
    and the last step agrees with the full forward's last logits."""
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    img = _image_embeds(jcfg)
    n_img = 0 if img is None else img.shape[1]
    _, jc = JT.prefill(jcfg, jp, jnp.asarray(toks[:, :8]), **_kw(img, "jax"))
    _, tc = make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks[:, :8]),
                                         **_kw(img, "torch")})
    jc = JKVCache(*(jnp.pad(a, ((0, 0),) * 3 + ((0, 4), (0, 0))) for a in jc))
    tc = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 4)) for a in tc))
    step = make_decode_step(tcfg)
    for t in range(8, 12):
        want, jc = JT.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                  jnp.int32(n_img + t))
        got, tc = step(tp, {"token": torch.from_numpy(toks[:, t:t + 1])}, tc, n_img + t)
        _close(got.numpy(), np.asarray(want))
    _close(_f32(tc.k), _f32(jc.k))
    full, _ = TT.forward(tcfg, tp, torch.from_numpy(toks), **_kw(img, "torch"))
    _close(got[:, 0].numpy(), full[:, -1].numpy())


def test_reference_init_converts_and_prefill_matches():
    """The reference's own ``T.init`` tree for olmoe-1b-7b's smoke config,
    as numpy, through ``lm_params_from_numpy``: the MoE leaves bit for bit
    (fp32 as stored, bf16 on request), and the prefill agrees."""
    arch = "olmoe-1b-7b"
    jcfg = dataclasses.replace(jget_smoke_config(arch), embedding_mode="dense")
    tcfg = dataclasses.replace(get_smoke_config(arch), embedding_mode="dense")
    jp = JT.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    assert "moe" in tree["layers"] and "mlp" not in tree["layers"]
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    for name in ("router", "wi", "wg", "wo"):
        np.testing.assert_array_equal(tp["layers"]["moe"][name].numpy(),
                                      tree["layers"]["moe"][name])
    tb = lm_params_from_numpy(tcfg, tree, device="cpu", dtype=torch.bfloat16)
    assert tb["layers"]["moe"]["wi"].dtype == torch.bfloat16
    assert torch.equal(tb["layers"]["moe"]["router"], tp["layers"]["moe"]["router"].bfloat16())
    with pytest.raises(ValueError, match="moe"):
        lm_params_from_numpy(get_smoke_config("yi-9b"), tree, device="cpu")
    toks = _tokens(jcfg)
    want, _ = JT.prefill(jcfg, jp, jnp.asarray(toks))
    got, _ = TT.prefill(tcfg, tp, torch.from_numpy(toks))
    _close(got.numpy(), np.asarray(want))


def test_hier_ps_moe_serving_matches_reference(tmp_path):
    """olmoe-1b-7b's smoke config in hier_ps mode: one published ``tok_emb``
    snapshot opened by both packages, ``lookup_device`` -> prefill -> 4
    greedy decode steps, as the dense slice's test: working tables bitwise,
    logits within the tolerance, the port's greedy choice equal wherever
    the reference's top two logits are further apart than that."""
    jcfg, tcfg, jp, tp = _pair("olmoe-1b-7b", embedding_mode="hier_ps")
    d, V = tcfg.d_model, tcfg.vocab_size
    spec = TableSpec("tok_emb", RowSchema.embedding(d))
    rows = (np.random.default_rng(3).normal(size=(V, d)) * 0.5).astype(np.float32)
    publish_arrays(str(tmp_path), n_nodes=2, dim=d,
                   tables={"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)})
    jeng = JServingEngine(JServingCluster(str(tmp_path)), device_hot_rows=64)
    teng = ServingEngine(ServingCluster(str(tmp_path)), device_hot_rows=64, device="cpu")
    prompts = _tokens(tcfg, B=2, S=16, seed=4).astype(np.uint64)

    def lookup(keys):
        js, jwt = jeng.lookup_device("tok_emb", keys)
        ts, twt = teng.lookup_device("tok_emb", keys)
        np.testing.assert_array_equal(ts, js)
        np.testing.assert_array_equal(twt.numpy(), np.asarray(jwt))
        return (jnp.asarray(js), jwt), (torch.from_numpy(ts), twt)

    (js, jwt), (ts, twt) = lookup(prompts)
    want, jc = JT.prefill(jcfg, jp, js, working_table=jwt)
    got, tc = make_prefill_step(tcfg)(tp, {"tokens": ts, "working_table": twt})
    _close(got.numpy(), np.asarray(want))
    jc = JKVCache(*(jnp.pad(a, ((0, 0),) * 3 + ((0, 4), (0, 0))) for a in jc))
    tc = KVCache(*(torch.nn.functional.pad(a, (0, 0, 0, 4)) for a in tc))
    step = make_decode_step(tcfg)
    for i in range(4):
        w = np.asarray(want[:, -1], np.float32)
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * TOL * np.abs(w).max()
        tok = np.asarray(jgreedy_sample(want))
        np.testing.assert_array_equal(greedy_sample(got).numpy()[clear], tok[clear])
        (js, jwt), (ts, twt) = lookup(tok.astype(np.uint64))
        want, jc = JT.decode_step(jcfg, jp, js, jc, jnp.int32(16 + i), working_table=jwt)
        got, tc = step(tp, {"token": ts, "working_table": twt}, tc, 16 + i)
        _close(got.numpy(), np.asarray(want))
    assert teng.counters.snapshot() == jeng.counters.snapshot()


def test_cpu_moe_and_vlm_paths_launch_no_kernel():
    for arch in ALL:
        _, tcfg, _, tp = _pair(arch)
        img = _image_embeds(tcfg)
        ops.reset_launch_counts()
        make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(_tokens(tcfg, S=130)),
                                     **_kw(img, "torch")})
        assert set(ops.launch_counts().values()) == {0}
        assert "moe_gmm" in ops.launch_counts()


def test_full_width_olmoe_shapes_without_allocating():
    """OLMoE-1B-7B at its published widths: the schema's sizes, as the
    reference counts them (no tensor is made)."""
    cfg = get_config("olmoe-1b-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.n_experts, cfg.top_k,
            cfg.embedding_mode) == (16, 2048, 16, 16, 128, 1024, 50304, 64, 8, "hier_ps")
    sch = TT.schema(cfg)
    assert sch["layers"]["moe"]["wi"].shape == (16, 64, 2048, 1024)
    assert sch["layers"]["moe"]["wo"].shape == (16, 64, 1024, 2048)
    n = param_count(sch)  # layers, final_norm and lm_head
    # the reference's count adds the PS-held tok_emb and leaves out final_norm
    assert n + cfg.vocab_size * cfg.d_model - cfg.d_model == cfg.param_count()
    assert cfg.param_count() / 1e9 == pytest.approx(6.92, abs=0.005)
    assert 2 * n / 1e9 == pytest.approx(13.6, abs=0.05)  # bf16 GB without the embedding
