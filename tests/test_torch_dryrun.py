"""The dry run (``repro_torch.launch.dryrun``) on the CPU.

* The reference's ``tests/test_dryrun_small.py`` cells — six families x
  train/prefill/decode at the same smoke configs and shapes — trace one
  rank's step on the meta device of a (data 2, model 4) dry mesh: FLOPs,
  argument bytes and collective bytes above 0. xlstm, which the port does
  not place at a model axis of 4 (its rules cut inside each mLSTM head),
  comes back ``refused`` and is traced where the port places it.
* Against the reference (JAX on the CPU): ``model_flops`` and
  ``param_count``; yi-9b's smoke train and prefill FLOPs against the
  reference's ``dot_flops`` of its compiled HLO, each term where the two
  paths differ swapped for its closed form.
* The collectives of yi-9b's smoke training at (1, 2) and (2, 2) (FSDP
  over data: the weights' all-gathers and their gradients'
  reduce-scatters) against closed forms of the config and the port's
  placement.
* The meta branch: a meta input never reaches a plain version, a CPU input
  gives the plain version's bits, and the five kernels' ``cost`` functions
  give ``PERF.md`` §6's bound column.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

import torch

from repro_torch.configs import ARCH_IDS, SHAPES as ARCH_SHAPES, ShapeSpec, get_config, get_smoke_config
from repro_torch.kernels import embedding_lookup as el_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import fused_adagrad as ag_mod
from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels import ops as kops
from repro_torch.kernels import scatter_add as sa_mod
from repro_torch.launch import dryrun as DR
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd

ROOT = Path(__file__).resolve().parents[1]

# the reference's tests/test_dryrun_small.py cells
SHAPES = {
    "train": ShapeSpec("train_t", "train", 64, 8),
    "prefill": ShapeSpec("prefill_t", "prefill", 128, 4),
    "decode": ShapeSpec("decode_t", "decode", 128, 8),
}
FAMILIES = ["yi-9b", "olmoe-1b-7b", "hymba-1.5b", "xlstm-1.3b", "whisper-tiny", "pixtral-12b"]
MESH = (2, 4)
# refused at MESH, with the reason's words, and the mesh the port places them on
REFUSED = {"xlstm-1.3b": ("mLSTM", (4, 2))}


def _cell(arch, kind, mesh):
    return DR.run_cell(arch, SHAPES[kind].name, mesh, cfg=get_smoke_config(arch),
                       shape=SHAPES[kind], verbose=False)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("kind", list(SHAPES))
def test_cell_traces_on_the_meta_device(arch, kind):
    r = _cell(arch, kind, MESH)
    mesh = MESH
    if arch in REFUSED:
        words, mesh = REFUSED[arch]
        assert words in r["refused"], r
        assert "flops_per_rank" not in r  # never traced replicated
        r = _cell(arch, kind, mesh)
    assert r["flops_per_rank"] > 0
    mem = r["memory_per_rank"]
    assert mem["argument_bytes"] > 0 and mem["peak_bytes"] >= mem["argument_bytes"]
    assert r["t_compute"] > 0 and r["t_memory"] > 0
    if mesh[1] > 1 or kind == "train":  # tensor parallelism, or the data-parallel mean
        assert r["collective_bytes_per_rank"] > 0, "a sharded step must communicate"
    else:  # each data rank serves its own rows; FSDP gathers the weights over data
        assert set(r["collective_counts"]) == {"all_gather"} and r["collective_bytes_per_rank"] > 0
        assert set(r["link_bytes_by_axis"]) == {"data"}
    assert "error" not in r


def test_roofline_terms_behave():
    r = _cell("yi-9b", "train", MESH)
    assert r["t_compute"] > 0 and r["t_memory"] > 0 and r["t_collective"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert "roofline_fraction" in r and "useful_flops_ratio" in r
    assert r["n_ranks"] == 8 and r["mesh"] == "2x4"
    # the terms are the totals over the card's rates
    assert r["t_memory"] == pytest.approx(r["bytes_per_rank"] / rl.HBM_BW)
    assert r["t_collective"] == pytest.approx(
        r["link_bytes_by_axis"]["model"] / rl.NVLINK_BW + r["link_bytes_by_axis"]["data"] / rl.NET_BW)


def test_unsupported_cells_are_skipped_and_the_report_renders(tmp_path, capsys):
    from repro_torch.launch import report

    out = tmp_path / "results.json"
    results = {"yi-9b|long_500k|2x4": DR.run_cell("yi-9b", "long_500k", MESH,
                                                  cfg=get_smoke_config("yi-9b"), verbose=False),
               "xlstm-1.3b|train_t|2x4": _cell("xlstm-1.3b", "train", MESH),
               "yi-9b|train_t|2x4": _cell("yi-9b", "train", MESH)}
    assert "skipped" in results["yi-9b|long_500k|2x4"]
    out.write_text(json.dumps(results))
    table = report.render(json.loads(out.read_text()))
    assert "| yi-9b | train_t | 2x4 |" in table
    assert "skipped cells (1)" in table and "refused cells (1)" in table


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_param_count_match_the_reference(arch):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import roofline as ref_rl

    cfg, ref = get_config(arch), ref_config(arch)
    for active in (False, True):
        assert cfg.param_count(active_only=active) == ref.param_count(active_only=active)
    for name, shape in ARCH_SHAPES.items():
        n = cfg.param_count(active_only=True)
        assert rl.model_flops(cfg, shape, n) == ref_rl.model_flops(ref, REF_SHAPES[name], n)


REF_FLOPS = """
    import json, sys
    import jax
    from jax.sharding import AxisType
    jax.devices()  # the backend exists before the reference's dryrun sets its device count
    from repro.configs import ShapeSpec, get_smoke_config
    from repro.launch import dryrun as DR
    from repro.launch import sharding as shd
    from repro.launch.hlo_analysis import analyze_text
    from repro.models.common import set_param_constraint_fn
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:1])
    out = {}
    for kind, args in json.loads(sys.argv[1]).items():
        fn, a, shards = DR.build_cell(get_smoke_config("yi-9b"), ShapeSpec(*args), mesh)
        with mesh:
            compiled = jax.jit(fn, in_shardings=shards).lower(*a).compile()
        shd.clear_constraints()
        set_param_constraint_fn(None)
        out[kind] = analyze_text(compiled.as_text()).dot_flops
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_dot_flops():
    shapes = {k: [s.name, s.kind, s.seq_len, s.global_batch] for k, s in SHAPES.items()
              if k in ("train", "prefill")}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_FLOPS), json.dumps(shapes)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# the port's FLOPs against the reference's HLO dot FLOPs on one device
FLOPS_RTOL = 0.01


def _matmul_flops(counter) -> float:
    """The counted FLOPs outside the kernels: the ops' matmuls."""
    return counter.flops - sum(k["flops"] for k in counter.kernels.values())


def test_train_flops_match_the_reference_dot_flops(ref_dot_flops):
    cfg, shape = get_smoke_config("yi-9b"), SHAPES["train"]
    counter, _ = DR.trace_cell(cfg, shape, DR.DryMesh(1, 1))
    # 64 tokens a row: both steps take naive attention, the kernels add no
    # matmul (lookup, scatter_add, Adagrad); the reference's loss contracts
    # the logits with a one-hot of the targets (2 B S V FLOPs), where the
    # port gathers the target's logit
    B, S = shape.global_batch, shape.seq_len
    port = _matmul_flops(counter) + 2 * B * S * cfg.vocab_size
    assert "flash_attention" not in counter.kernels
    assert port == pytest.approx(ref_dot_flops["train"], rel=FLOPS_RTOL)


def test_prefill_flops_match_the_reference_dot_flops(ref_dot_flops):
    cfg, shape = get_smoke_config("yi-9b"), SHAPES["prefill"]
    counter, _ = DR.trace_cell(cfg, shape, DR.DryMesh(1, 1))
    B, S, H, Dh, L = (shape.global_batch, shape.seq_len, cfg.n_heads, cfg.resolved_head_dim,
                      cfg.n_layers)
    # the port's prefill takes the flash kernel, which does the causal work:
    # two products of 2 Dh FLOPs for each kept (query, key) pair
    causal = L * 4 * Dh * B * H * (S * (S + 1) // 2)
    assert counter.kernels["flash_attention"] == {
        "calls": L, "flops": causal,
        "bytes": L * 2 * (2 * B * H * S * Dh + 2 * B * cfg.n_kv_heads * S * Dh)}
    # the reference's prefill (attn_impl "blockwise") multiplies every
    # (query, key) block: QK^T and PV over the whole S x S square
    square = L * 2 * (2 * B * H * S * S * Dh)
    port = counter.flops - counter.kernels["flash_attention"]["flops"] + square
    assert _matmul_flops(counter) == counter.flops - causal
    assert port == pytest.approx(ref_dot_flops["prefill"], rel=FLOPS_RTOL)


# --------------------------------------------------------------------------
# collectives: closed forms of yi-9b's smoke training under the placement
# --------------------------------------------------------------------------


def _closed_form(cfg, shape, data: int, M: int) -> dict:
    """Each kind's (calls, operand bytes) of one training step of a dense
    model with replicated kv heads (smoke yi-9b: 1 kv head; swiglu), hier_ps,
    remat, fp32 weights, on a (data, M) mesh, M > 1."""
    d, H, Hkv, hd, ff, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                               cfg.d_ff, cfg.vocab_size, cfg.n_layers)
    assert Hkv % M and H % M == 0 and d % M == 0 and V % M == 0 and d % data == 0
    b_local = shape.global_batch // data
    n_micro = DR.microbatches_for(cfg, shape, DR.DryMesh(data, M))
    B, S = b_local // n_micro, shape.seq_len
    act, kv = 4 * B * S * d, 4 * B * S * Hkv * hd  # fp32 all-reduces
    # per layer and microbatch on x-sized activations: the forward's two
    # row-parallel sums (attention, MLP), remat's recompute of the
    # attention's (the checkpoint stops its recompute at the last tensor
    # the backward saved: the MLP's sum is past it), the backward's two
    # column-parallel entries (q heads, MLP); the replicated k and v enter
    # the region once each; then the lm_head's entry, and the loss's max
    # and (sum of exponentials, target logit)
    per_micro = {
        "act": (5 * L + 1, act), "kv": (2 * L, kv),
        "ce_max": (1, 4 * B * S), "ce_sums": (1, 2 * 4 * B * S),
        "gather": (1, 4 * B * S * d // M),  # the embedding's d-slices
    }
    # each layer's seven projections and lm_head, this rank's model shard
    # (whole over data); the norms; the table's d-slice
    layer = d * H * hd // M + 2 * d * Hkv * hd + H * hd * d // M + 3 * d * ff // M
    head, norms = d * V // M, L * 2 * d + d
    table = inp.working_rows(cfg, shape.global_batch * S) * d // M
    reduces = [per_micro[k] for k in ("act", "kv", "ce_max", "ce_sums")]
    act_reduces = (n_micro * sum(n for n, _ in reduces), n_micro * sum(n * b for n, b in reduces))
    n_gather, b_gather = per_micro["gather"]
    if data == 1:
        # the data-parallel mean: every local gradient leaf, the loss
        # metrics, the table's d-slice gradient; the clip norm's sum of
        # squares over model
        n_leaves = 9 + 2 + 2 + 1  # per-layer stacks, final norm and lm_head, metrics, table
        return {
            "all_reduce": (act_reduces[0] + n_leaves + 1,
                           act_reduces[1] + 4 * (L * layer + head + norms + 2 + table) + 4),
            "all_gather": (n_micro * n_gather, n_micro * n_gather * b_gather),
        }
    # FSDP over data: each microbatch gathers every layer's projections in
    # the forward and again in remat's recompute, and lm_head once (this
    # rank's 1/data of each), and its backward reduce-scatters each of
    # their gradients; the data-parallel mean all-reduces the rest (the
    # norms, the metrics, the table), the clip norm sums its squares over
    # data (a pair: the leaves cut on both axes, on data alone) and model
    return {
        "all_reduce": (act_reduces[0] + 2 + 1 + 2 + 1 + 2,
                       act_reduces[1] + 4 * (norms + 2 + table) + 8 + 4),
        "all_gather": (n_micro * (n_gather + 2 * 7 * L + 1),
                       n_micro * (n_gather * b_gather + 4 * (2 * L * layer + head) // data)),
        "reduce_scatter": (n_micro * (7 * L + 1), n_micro * 4 * (L * layer + head)),
    }


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_training_collectives_match_the_closed_form(mesh):
    cfg, shape = get_smoke_config("yi-9b"), SHAPES["train"]
    counter, _ = DR.trace_cell(cfg, shape, DR.DryMesh(*mesh))
    counts, by_kind, link = counter.collective_stats()
    want = _closed_form(cfg, shape, *mesh)
    assert {k: (counts[k], by_kind[k]) for k in counts} == want
    by_axis = {}
    for c in counter.collectives:
        by_axis[(c.kind, c.group.axis)] = by_axis.get((c.kind, c.group.axis), 0) + c.nbytes
        assert c.group.size == dict(zip(("data", "model"), mesh))[c.group.axis]
    # a ring all_reduce sends 2 (n - 1) / n of its operand, a
    # reduce_scatter (n - 1) / n, an all_gather n - 1 parts; the data axis
    # carries the mean and FSDP's gathers, and a group of one moves nothing
    D, M = mesh
    assert link["data"] == pytest.approx(by_axis[("all_reduce", "data")] * 2 * (D - 1) / D
                                         + by_axis.get(("all_gather", "data"), 0) * (D - 1)
                                         + by_axis.get(("reduce_scatter", "data"), 0) * (D - 1) / D)
    assert link["model"] == pytest.approx(by_axis[("all_reduce", "model")] * 2 * (M - 1) / M
                                          + by_axis[("all_gather", "model")] * (M - 1))


def test_refused_cells_name_check_model_parallel():
    r = DR.run_cell("xlstm-1.3b", "train_4k", (32, 8), verbose=False)
    with pytest.raises(NotImplementedError) as e:
        shd.check_model_parallel(get_config("xlstm-1.3b"), DR.DryMesh(32, 8))
    assert r["refused"] == str(e.value)
    for arch, M in (("hymba-1.5b", 8), ("whisper-tiny", 4), ("whisper-tiny", 8)):
        shd.check_model_parallel(get_config(arch), DR.DryMesh(32, M))  # q heads cut inside a head
    r = DR.run_cell("hymba-1.5b", "decode_32k", (8, 5), verbose=False)
    assert "refused" not in r and r["collective_bytes_per_rank"] > 0


# --------------------------------------------------------------------------
# the meta branch of the dispatcher
# --------------------------------------------------------------------------

PLAIN = ("embedding_lookup_plain", "scatter_add_plain_", "adagrad_plain",
         "flash_attention_plain", "gmm_plain")


def test_meta_inputs_never_reach_a_plain_version(monkeypatch):
    from repro_torch.kernels import ref

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta inputs")

    for name in PLAIN:
        monkeypatch.setattr(kops, name, refuse)
    for name in ("embedding_lookup_ref", "scatter_add_ref", "adagrad_ref", "gmm_ref"):
        monkeypatch.setattr(ref, name, refuse)
    for arch in ("yi-9b", "olmoe-1b-7b", "whisper-tiny"):
        for kind in SHAPES:
            r = _cell(arch, kind, (1, 2))
            assert r["flops_per_rank"] > 0
    r = _cell("olmoe-1b-7b", "train", (1, 1))
    assert r["kernel_calls"]["moe_gmm"] > 0 and r["kernel_calls"]["scatter_add"] > 0
    m = lambda *shape: torch.empty(shape, device="meta")
    with pytest.raises(NotImplementedError):
        kops.topk_mips(m(4, 8), m(16, 8), 2)
    with pytest.raises(NotImplementedError):
        kops.embedding_bag(m(16, 8), m(2, 3).long(), m(2, 3).int(), m(2, 3).bool(), 2)
    with pytest.raises(NotImplementedError):
        kops.feature_extract(m(2, 3).long(), m(2, 3).bool(), n_keys=8, n_slots=2)


def test_meta_stand_ins_have_the_kernels_shapes_and_report_their_cost():
    g = torch.Generator().manual_seed(0)
    cpu = {
        "table": torch.randn(20, 16, generator=g), "ids": torch.randint(0, 20, (12,), generator=g),
        "q": torch.randn(2, 4, 128, 8, generator=g).bfloat16(),
        "k": torch.randn(2, 2, 128, 8, generator=g).bfloat16(),
        "x": torch.randn(10, 16, generator=g), "w": torch.randn(3, 16, 8, generator=g),
        "gs": torch.tensor([4, 0, 6]),
    }
    meta = {k: v.to("meta") for k, v in cpu.items()}
    calls = []
    kmeta.set_sink(calls.append)
    try:
        for args in (cpu, meta):
            args["out"] = [
                kops.embedding_lookup(args["table"], args["ids"]),
                kops.scatter_add(args["table"], args["ids"], args["table"][:12]),
                *kops.adagrad_update(args["table"], args["table"].abs(), args["table"], 0.1),
                kops.flash_attention(args["q"], args["k"], args["k"], causal=True),
                kops.gmm(args["x"], args["w"], args["gs"]),
            ]
    finally:
        kmeta.set_sink(None)
    for a, b in zip(cpu["out"], meta["out"]):
        assert b.is_meta and a.shape == b.shape and a.dtype == b.dtype
    assert [c.name for c in calls] == ["embedding_lookup", "scatter_add", "fused_adagrad",
                                       "flash_attention", "moe_gmm"]
    assert calls[0].nbytes == el_mod.cost(12, 16, 4, 12)[1]
    assert (calls[1].flops, calls[1].nbytes) == sa_mod.cost(12, 16, 12)
    assert (calls[2].flops, calls[2].nbytes) == ag_mod.cost(20 * 16)
    assert (calls[3].flops, calls[3].nbytes) == fa_mod.cost(
        2, 4, 2, 128, 128, 8, causal=True, window=0, q_offset=0, elem_bytes=2)
    assert (calls[4].flops, calls[4].nbytes) == gmm_mod.cost(10, 16, 8, 3, 4)
    assert calls[3].dtype == torch.bfloat16


def test_cpu_inputs_give_the_plain_versions_bits():
    g = torch.Generator().manual_seed(1)
    table, ids = torch.randn(20, 16, generator=g), torch.randint(0, 20, (12,), generator=g)
    grads = torch.randn(12, 16, generator=g)
    assert torch.equal(kops.embedding_lookup(table, ids), el_mod.embedding_lookup_plain(table, ids))
    sid, order = torch.sort(ids, stable=True)
    assert torch.equal(kops.scatter_add(table, ids, grads),
                       sa_mod.scatter_add_plain_(table.clone(), sid, grads[order]))
    acc = table.abs()
    for a, b in zip(kops.adagrad_update(table, acc, table, 0.1),
                    ag_mod.adagrad_plain(table, acc, table, 0.1)):
        assert torch.equal(a, b)
    q, k = torch.randn(2, 4, 128, 8, generator=g), torch.randn(2, 2, 128, 8, generator=g)
    assert torch.equal(kops.flash_attention(q, k, k, causal=True, window=16),
                       fa_mod.flash_attention_plain(q, k, k, causal=True, window=16))
    assert torch.equal(kops.attention(q, k, k), kops.attention(q, k, k, impl="naive"))
    x, w, gs = torch.randn(10, 16, generator=g), torch.randn(3, 16, 8, generator=g), \
        torch.tensor([4, 0, 6])
    assert torch.equal(kops.gmm(x, w, gs), gmm_mod.gmm_plain(x, w, gs))


def test_meta_attention_takes_the_flash_kernel_as_the_card_does():
    calls = []
    kmeta.set_sink(calls.append)
    try:
        m = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="meta")
        kops.attention(m(1, 4, 128, 8), m(1, 2, 128, 8), m(1, 2, 128, 8))
        kops.attention(m(1, 4, 127, 8), m(1, 2, 127, 8), m(1, 2, 127, 8))  # naive below 128
        kops.attention(m(1, 4, 1, 8), m(1, 2, 256, 8), m(1, 2, 256, 8), q_offset=255,
                       kv_len=256)  # decode: a kv_len is not static
    finally:
        kmeta.set_sink(None)
    assert [c.name for c in calls] == ["flash_attention"]


# --------------------------------------------------------------------------
# kernel costs against PERF.md §6's bound column
# --------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16


def _flash(B, H, Hkv, Sq, Skv, Dh, causal, window=0):
    return fa_mod.cost(B, H, Hkv, Sq, Skv, Dh, causal=causal, window=window, q_offset=0,
                       elem_bytes=2)


# row: (cost, dtype, bound ms in PERF.md §6)
PERF_ROWS = {
    "3": (el_mod.cost(8192, 4096, 4, 3729), F32, 0.0583),
    "3b": (sa_mod.cost(8192, 4096, 3729), F32, 0.0765),
    "5a": (ag_mod.cost(3729 * 4096), F32, 0.0912),
    "7": (_flash(4, 32, 4, 2048, 2048, 128, True), BF16, 0.139),
    "7a": (_flash(4, 16, 16, 2048, 2048, 128, True), BF16, 0.0695),
    "7b": (_flash(4, 25, 5, 2176, 2176, 64, True, 1024), BF16, 0.0441),
    "7c": (_flash(4, 6, 6, 1500, 1500, 64, False), BF16, 0.0140),
    "7d": (_flash(4, 25, 5, 2176, 2176, 64, True), BF16, 0.0613),
    "7e": (_flash(4, 6, 6, 224, 1500, 64, False), BF16, 0.00316),
    "7f": (_flash(4, 6, 6, 224, 224, 64, True), BF16, 0.00082),
    "8": (gmm_mod.cost(60381, 2048, 1024, 64, 2), BF16, 0.256),
}


@pytest.mark.parametrize("row", list(PERF_ROWS))
def test_cost_functions_give_the_perf_bound_column(row):
    (flops, nbytes), dtype, want_ms = PERF_ROWS[row]
    # the larger of the bytes over HBM's rate and the FLOPs over the dtype's peak
    bound = max(nbytes / rl.HBM_BW, flops / rl.PEAK_FLOPS[dtype])
    assert bound * 1e3 == pytest.approx(want_ms, rel=0.01)
    text = (ROOT / "PERF.md").read_text()
    line = next(ln for ln in text.splitlines() if ln.startswith(f"| {row} |"))
    assert f"{want_ms}" in line.split("|")[7], line.split("|")[7]


def test_flash_cost_counts_the_kept_pairs():
    for Sq, Skv, causal, window, q_offset in ((7, 7, True, 0, 0), (5, 9, False, 0, 0),
                                               (6, 10, True, 3, 4), (4, 12, True, 0, 8)):
        mask = fa_mod.attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                                     device="cpu")
        assert fa_mod.kept_pairs(Sq, Skv, causal=causal, window=window,
                                 q_offset=q_offset) == int(mask.sum())
    assert math.isclose(_flash(1, 1, 1, 4, 4, 2, True)[0], 4 * 2 * 10)
