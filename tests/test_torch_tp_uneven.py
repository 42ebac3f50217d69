"""Tensor parallelism at the ``model`` axes where the reference's rules cut
``wq``'s columns inside a head, leave the kv heads replicated for q heads
that start inside a kv group, put ``model`` inside each expert's ``mlp``,
or leave a block's leaves whole, against the JAX reference and the port's
world of one, on the CPU.

* Placement, published configs: ``check_model_parallel`` takes every
  (arch, model axis) pair that it refused before (the table below), and
  ``shard_tree`` gives each rank of a (2, M) mesh the shape the reference's
  ``pspec`` gives it, leaf by leaf (on the ``meta`` device: the published
  widths do not fit a test in memory). xlstm-1.3b at 8, whose rules cut
  inside each mLSTM head, is still refused.
* Placement, smoke configs of each kind, real tensors: each rank's shard is
  the reference's slice, cut independently of ``shard_leaf``, and the
  ranks' shards join back bitwise.
* The kernel's head offset: ``flash_attention_plain`` with ``group`` and
  ``head_offset``, for each local head, equals the reference's Pallas
  kernel (interpret mode) on the whole heads for that global head; the
  naive, blockwise and banded paths of ``ops.attention`` and the flash
  Function's backward agree with the same slice of the whole heads.
* Gradients (``test_torch_tp.check_tp_grads``: hier_ps, fp32 compute,
  every bias and norm drawn, gloo ranks on a (1, M) mesh and for the first
  case also (2, M)): against the reference's GSPMD step on forced host
  devices within ``FP32_TOL``, against the port's world of one within
  ``TP_TOL``. One smoke variant of each placement: q heads cut inside a
  head with a replicated kv group split across ranks (yi-9b, 9 heads over
  3 at 2: 4.5 heads a rank; hymba, 10 over 2 at 4), whisper's 6 heads at 4
  (1.5 a rank) and at 8 (two ranks own no head), ``mlp`` inside each of
  phi3.5-moe's 4 experts at 3, olmoe's experts whole at 3, xlstm's blocks
  whole at 3.
* The dry run traces a rank that owns no head and one that owns one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models.common import block_range, kv_heads_read  # noqa: E402

from test_torch_tp import (  # noqa: E402
    _meshes,
    check_reference_shapes,
    check_reference_slices,
    check_tp_grads,
)

# the (arch, model axis) pairs of the published configs the port refused
# before it cut q heads inside a head, read replicated kv from inside a
# group, cut inside each expert's mlp and ran whole blocks whole
PUBLISHED = [
    ("hymba-1.5b", 2), ("hymba-1.5b", 4), ("hymba-1.5b", 8),  # 25 heads
    ("whisper-tiny", 4), ("whisper-tiny", 8),  # 6 heads
    ("phi3-mini-3.8b", 3), ("phi3-mini-3.8b", 6),  # 32 heads
    ("nemotron-4-340b", 3), ("nemotron-4-340b", 6),  # 96 q heads over 8 kv heads
    ("phi3.5-moe-42b-a6.6b", 5),  # 16 experts of d_ff 6400: model inside each
    ("olmoe-1b-7b", 3), ("olmoe-1b-7b", 5), ("olmoe-1b-7b", 6),  # every expert leaf whole
    ("phi3.5-moe-42b-a6.6b", 3), ("phi3.5-moe-42b-a6.6b", 6),
    ("xlstm-1.3b", 3), ("xlstm-1.3b", 5), ("xlstm-1.3b", 6),  # every mLSTM leaf whole
]


@pytest.mark.parametrize("arch,M", PUBLISHED, ids=[f"{a}-{m}" for a, m in PUBLISHED])
def test_published_pairs_take_the_reference_slices(arch, M):
    on_model = check_reference_shapes(get_config(arch), jget_config(arch), M)
    assert on_model > 0 or arch in ("olmoe-1b-7b", "xlstm-1.3b") and M in (3, 5)


def test_mlstm_cut_inside_its_heads_is_still_refused():
    _, mesh = _meshes(1, 8)
    with pytest.raises(NotImplementedError, match=r"xlstm-1.3b: a model axis of 8 cuts the "
                       r"mLSTM's 4 heads of 1024 inside a head.*ROADMAP §1 item 3"):
        shd.check_model_parallel(get_config("xlstm-1.3b"), mesh)


# (arch, smoke variant, model axis): one of each placement, real tensors
SMOKE = [
    ("yi-9b", {"n_heads": 9, "n_kv_heads": 3, "head_dim": 8}, 2),  # 4.5 heads a rank, g 3
    ("nemotron-4-340b", {}, 4),  # 6 heads over 2 kv heads: 1.5 a rank
    ("hymba-1.5b", {}, 2),  # 5 heads over 1 kv head, mamba over 2
    ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16}, 8),  # two ranks own none
    ("phi3.5-moe-42b-a6.6b", {}, 3),  # 4 experts: model inside each expert's mlp
    ("olmoe-1b-7b", {}, 3),  # 8 experts, d_ff 64: every expert leaf whole
    ("xlstm-1.3b", {}, 3),  # every mLSTM and sLSTM leaf whole
]


def _cfgs(arch, variant):
    return (dataclasses.replace(get_smoke_config(arch), **variant),
            dataclasses.replace(jget_smoke_config(arch), **variant))


@pytest.mark.parametrize("arch,variant,M", SMOKE, ids=[f"{a}-{m}" for a, _, m in SMOKE])
def test_smoke_placements_take_the_reference_slices_and_join_back_bitwise(arch, variant, M):
    check_reference_slices(*_cfgs(arch, variant), M)


@pytest.mark.parametrize("H,M", [(25, 2), (25, 4), (25, 8), (6, 4), (6, 8), (96, 3)])
def test_every_q_head_is_owned_by_one_rank(H, M):
    """``block_range`` hands each rank whole heads, in order, every head to
    one rank; ``kv_heads_read`` covers each rank's heads' kv groups."""
    owned = [block_range(H, r, M) for r in range(M)]
    assert owned[0][0] == 0 and owned[-1][1] == H
    assert all(a[1] == b[0] for a, b in zip(owned, owned[1:]))
    g = {25: 5, 6: 1, 96: 12}[H]
    for lo, hi in owned:
        kv_lo, kv_hi, off = kv_heads_read(lo, hi, g)
        assert [(h + off) // g for h in range(hi - lo)] == [h // g - kv_lo for h in range(lo, hi)]
        assert kv_hi - kv_lo == (len({h // g for h in range(lo, hi)}))


# --------------------------------------------------------------------------
# the kernel's head offset
# --------------------------------------------------------------------------

# (heads, kv heads, this rank's heads [lo, hi), Sq, Skv, Dh, causal, window, q_offset):
# hymba-1.5b's rank 1 of 2 (25 heads over 5, from offset 2 of group 2) and a
# rank inside one group; nemotron's rank 1 of 3 at 96 / 8
OFFSET_CASES = [
    (25, 5, (12, 25), 128, 128, 16, True, 0, 0),
    (25, 5, (12, 25), 128, 128, 16, True, 48, 0),
    (10, 2, (2, 5), 64, 128, 32, False, 0, 0),
    (24, 2, (8, 16), 128, 256, 16, True, 0, 128),
]


def _offset_inputs(case, seed=0):
    Ht, Hkv, (lo, hi), Sq, Skv, Dh = case[:6]
    rng = np.random.default_rng(seed + lo + hi)
    q = rng.normal(size=(2, Ht, Sq, Dh)).astype(np.float32)
    k = rng.normal(size=(2, Hkv, Skv, Dh)).astype(np.float32)
    v = rng.normal(size=(2, Hkv, Skv, Dh)).astype(np.float32)
    g = Ht // Hkv
    kv_lo, kv_hi, off = kv_heads_read(lo, hi, g)
    local = (torch.from_numpy(q[:, lo:hi].copy()), torch.from_numpy(k[:, kv_lo:kv_hi].copy()),
             torch.from_numpy(v[:, kv_lo:kv_hi].copy()))
    return (q, k, v), local, dict(group=g, head_offset=off)


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_flash_plain_with_a_head_offset_matches_pallas_on_the_whole_heads(case):
    causal, window, qoff = case[6:]
    (lo, hi), mask = case[2], dict(causal=causal, window=window, q_offset=qoff)
    (q, k, v), local, groups = _offset_inputs(case)
    want = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             interpret=True, **mask))[:, lo:hi]
    got = flash_attention_plain(*local, **mask, **groups)
    assert groups["head_offset"] > 0 or hi - lo < case[0] // case[1]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert torch.equal(ops.attention(*local, impl="flash", **mask, **groups), got)
    for impl in ("naive", "blockwise"):  # the plain paths pad to the groups and drop the padding
        other = ops.attention(*local, impl=impl, block_k=64, **mask, **groups)
        np.testing.assert_allclose(other.numpy(), want, atol=2e-5, rtol=2e-5)


def test_banded_path_and_flash_backward_with_a_head_offset():
    """The banded path (causal window self attention) and the flash
    Function's backward (the blockwise recompute) on a rank's heads equal
    the whole heads' sliced, gradients included."""
    case = (25, 5, (12, 25), 128, 128, 16, True, 32, 0)
    (q, k, v), local, groups = _offset_inputs(case, seed=4)
    lo, hi = case[2]
    kv_lo, kv_hi, _ = kv_heads_read(lo, hi, 5)
    whole = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    full = ops.attention_banded(*whole, window=32)
    ref = full[:, lo:hi]
    dout = torch.from_numpy(np.random.default_rng(9).normal(size=ref.shape).astype(np.float32))
    dfull = torch.zeros_like(full)
    dfull[:, lo:hi] = dout  # the other ranks' heads add nothing
    want = torch.autograd.grad(full, whole, dfull)
    banded = ops.attention(*local, window=32, impl="naive", **groups)  # S > window: banded
    torch.testing.assert_close(banded, ref.detach(), atol=2e-5, rtol=2e-5)
    mine = [t.requires_grad_() for t in local]
    out = ops.flash_attention(*mine, window=32, **groups)
    got = torch.autograd.grad(out, mine, dout)
    torch.testing.assert_close(out, ref.detach(), atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(got[0], want[0][:, lo:hi], atol=2e-5, rtol=2e-5)
    for g, w in zip(got[1:], want[1:]):  # the kv heads this rank's heads read
        torch.testing.assert_close(g, w[:, kv_lo:kv_hi], atol=2e-5, rtol=2e-5)


def test_flash_rejects_heads_that_miss_their_kv_heads():
    q, k = torch.zeros(1, 3, 4, 8), torch.zeros(1, 1, 4, 8)
    for groups in (dict(group=2), dict(group=3, head_offset=1), dict(group=3, head_offset=3)):
        with pytest.raises(ValueError, match="do not read|do not group"):
            flash_attention_plain(q, k, k, **groups)


# --------------------------------------------------------------------------
# gradients: gloo ranks vs the reference and the world of one
# --------------------------------------------------------------------------

GRAD_CASES = [
    ("yi-9b", {"n_heads": 9, "n_kv_heads": 3, "head_dim": 8}, 2, (1, 2)),
    ("hymba-1.5b", {"n_heads": 10, "n_kv_heads": 2, "head_dim": 8}, 4, (1,)),
    ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16}, 4, (1,)),
    ("whisper-tiny", {"n_heads": 6, "n_kv_heads": 6, "head_dim": 16}, 8, (1,)),
    ("phi3.5-moe-42b-a6.6b", {}, 3, (1,)),
    ("olmoe-1b-7b", {}, 3, (1,)),
    ("xlstm-1.3b", {}, 3, (1,)),
]


@pytest.mark.parametrize("arch,variant,M,data", GRAD_CASES,
                         ids=[f"{a}-{m}" for a, _, m, _ in GRAD_CASES])
def test_uneven_tp_gradients_match_the_reference_and_the_world_of_one(arch, variant, M, data,
                                                                      tmp_path):
    check_tp_grads(arch, tmp_path, variant, drawn_constants=True, model=M, data=data)


# --------------------------------------------------------------------------
# the dry run at the new placements
# --------------------------------------------------------------------------

DRY_SHAPES = {"train": ShapeSpec("train_t", "train", 64, 8),
              "prefill": ShapeSpec("prefill_t", "prefill", 128, 4),
              "decode": ShapeSpec("decode_t", "decode", 128, 8)}


@pytest.mark.parametrize("kind", list(DRY_SHAPES))
@pytest.mark.parametrize("rank", [0, 1])
def test_dry_run_traces_ranks_with_and_without_heads(kind, rank):
    """whisper with 6 heads at a (2, 8) mesh: rank 0 owns no head, rank 1
    one. Both trace every kind of cell; only the rank with a head launches
    flash (the prefill's 128 tokens take it), and the q heads' gathers over
    ``model`` are recorded where the step makes them."""
    cfg = dataclasses.replace(get_smoke_config("whisper-tiny"), n_heads=6, n_kv_heads=6,
                              head_dim=16)
    shape = DRY_SHAPES[kind]
    r = DR.run_cell("whisper-tiny", shape.name, (2, 8), rank=rank, cfg=cfg, shape=shape,
                    verbose=False)
    assert "refused" not in r and r["flops_per_rank"] > 0, r
    assert r["collective_counts"].get("all_gather", 0) > 0
    flash = r["kernel_calls"].get("flash_attention", 0)
    assert (flash > 0) == (kind == "prefill" and rank == 1), r["kernel_calls"]
