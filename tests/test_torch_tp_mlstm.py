"""Tensor parallelism over ``model`` with the mLSTM cut inside its heads
(xlstm-1.3b at a model axis of 8: 4 heads of 1,024 over 8 ranks, half a
head a rank), against the JAX reference and the port's world of one, on
the CPU. Smoke xlstm in three variants: ``n_heads`` 2 at M = 4 (half a
head a rank, the small image of xlstm-1.3b at 8), ``n_heads`` 3 at M = 2
(one and a half heads a rank: rank 0's channels run into head 1) and
``n_heads`` 3 at M = 6 (half a head a rank, its head dim of 64 not divided
by 6: the rules leave ``wq``/``wk``/``wv`` whole on every rank).

* Placement: ``check_model_parallel`` takes each; each rank's shard of
  every leaf of seeded weights is the reference's slice, the per-head
  projections' output columns of its channels ``[r dp / M, (r + 1) dp /
  M)`` as [.., dh, dp / M] (built independently of ``shard_leaf``), as
  many elements as the rules' cut; the shards join back bitwise, and
  ``gather_tree`` over gloo ranks gives the whole tree bitwise. Published
  xlstm-1.3b at 8: rank r holds head r // 2's output columns [512 (r mod
  2), +512); at 2 and 4 its heads, the reference's bytes a rank.
* Gradients (``test_torch_tp.check_tp_grads``: hier_ps, fp32 compute,
  every bias and norm drawn): against the reference's GSPMD step on forced
  host devices within ``FP32_TOL`` and the port's world of one within
  ``TP_TOL`` (``mlstm/b_i``, a sum that nearly cancels, within 1e-4).
* The launcher (``test_torch_tp_train.check_tp_launcher``) at
  ``model_parallel=4`` and 2: leaves whole over ``model`` bitwise equal
  across the ranks, a TP checkpoint resumed at M shard for shard and at 1
  bitwise.
* Decode: gloo ranks decode the prompt token by token from ``init_cache``
  (the rank's channels and the heads they touch) and the prefill's last
  logits, against the world of one's, fp32 compute, within ``TP_TOL``.
* The dry run traces every kind of cell on a (2, 4) mesh with model-axis
  gathers.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

from test_torch_launch import _close, _flat  # noqa: E402
from test_torch_sharded_hbm import spawn_ranks  # noqa: E402
from test_torch_tp import (  # noqa: E402
    TP_TOL,
    _meshes,
    check_reference_shapes,
    check_reference_slices,
    check_tp_grads,
)
from test_torch_tp_families import GATHER_SCRIPT, LOOSE  # noqa: E402
from test_torch_tp_train import check_tp_launcher  # noqa: E402

ARCH = "xlstm-1.3b"
# (smoke variant, model axis): the three ways a rank's channels cut inside a head
CUTS = {
    "half-head": ({"n_heads": 2}, 4),
    "head-and-a-half": ({"n_heads": 3, "d_model": 96}, 2),
    "projections-whole": ({"n_heads": 3, "d_model": 96}, 6),
}


def _cfgs(variant):
    return (dataclasses.replace(get_smoke_config(ARCH), **variant),
            dataclasses.replace(jget_smoke_config(ARCH), **variant))


@pytest.mark.parametrize("name", list(CUTS))
def test_placement_takes_the_reference_slices_and_its_bytes(name):
    variant, M = CUTS[name]
    cfg, jcfg = _cfgs(variant)
    check_reference_slices(cfg, jcfg, M)  # on a (2, M) mesh: FSDP over data beside it
    _, mesh = _meshes(1, M)
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
    cuts = dict(_flat(shd.model_cuts(schema, rules, mesh)))
    init = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
    tree, part = dict(_flat(init)), dict(_flat(shd.shard_tree(init, schema, rules, mesh, 1)))
    dh = int(cfg.proj_factor * cfg.d_model) // cfg.n_heads
    for leaf in ("wq", "wk", "wv"):
        whole, cut = tree[f"mlstm/{leaf}"], cuts[f"mlstm/{leaf}"]
        if dh % M:  # the rules leave them whole: every rank holds them
            assert cut is None and part[f"mlstm/{leaf}"] is whole
        else:  # the rules' bytes, [.., dh, dp / M]
            assert cut.heads == cfg.n_heads and part[f"mlstm/{leaf}"].numel() * M == whole.numel()
            assert part[f"mlstm/{leaf}"].shape[-2:] == (dh, cfg.n_heads * dh // M)


@pytest.mark.parametrize("M", [2, 4])
def test_xlstm_1p3b_takes_the_reference_bytes_a_rank_on_whole_heads(M):
    """Where M divides the 4 heads the cut is the heads, as before the cut
    inside a head (at 8: ``test_torch_tp_uneven``)."""
    assert check_reference_shapes(get_config(ARCH), jget_config(ARCH), M) > 0


def test_xlstm_1p3b_at_8_holds_half_a_head_a_rank():
    """Rank r holds head r // 2's output columns [512 (r mod 2), +512) of
    ``wq`` with all 1,024 input rows, on a real tensor of one layer whose
    values name (head, row, column)."""
    cfg = get_config(ARCH)
    _, mesh = _meshes(1, 8)
    schema = get_model(cfg).schema(cfg)
    cut = shd.model_cuts(schema, shd.build_rules(cfg, mesh), mesh)["mlstm"]["wq"]
    H, dh = 4, 1024
    idx = torch.arange(H * dh * dh, dtype=torch.int64).reshape(1, 1, H, dh, dh)
    for r in range(8):
        got = shd.shard_leaf(idx, cut, r, 8)
        assert got.shape == (1, 1, dh, 512)
        h, c0 = r // 2, 512 * (r % 2)
        assert torch.equal(got[0, 0], idx[0, 0, h, :, c0:c0 + 512]), r


@pytest.mark.parametrize("name", ["half-head", "head-and-a-half"])
def test_gather_tree_joins_the_ranks_shards_bitwise(name, tmp_path):
    variant, M = CUTS[name]
    spawn_ranks(GATHER_SCRIPT, M, tmp_path, env_extra={
        "ARCH": ARCH, "MODEL": str(M), "VARIANT": json.dumps(variant), "OUT": str(tmp_path)})
    cfg, _ = _cfgs(variant)
    tree = dict(_flat(get_model(cfg).init(cfg, torch.Generator().manual_seed(3))))
    for r in range(M):
        got = torch.load(tmp_path / f"rank{r}.pt")
        for form in ("all", "dst") if r == 0 else ("all",):
            flat = dict(_flat(got[form]))
            assert sorted(flat) == sorted(tree)
            for leaf, whole in tree.items():
                assert torch.equal(flat[leaf], whole), (r, form, leaf)


# the reference on 4 forced host devices where the cut allows (the third on 6)
GRADS = {"half-head": (1,), "head-and-a-half": (1, 2), "projections-whole": (1,)}


@pytest.mark.parametrize("name", list(CUTS))
def test_gradients_match_the_reference_and_the_world_of_one(name, tmp_path):
    variant, M = CUTS[name]
    check_tp_grads(ARCH, tmp_path, variant, LOOSE[ARCH], drawn_constants=True, model=M,
                   data=GRADS[name])


@pytest.mark.parametrize("name", ["half-head", "head-and-a-half"])
def test_launcher_keeps_replicated_leaves_equal_and_resumes_at_tp1(name, tmp_path):
    variant, M = CUTS[name]
    check_tp_launcher(ARCH, 1, tmp_path, variant, model=M)


DECODE_SCRIPT = """
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    import repro_torch.models.xlstm
    for name, mod in list(sys.modules.items()):  # fp32 compute in every model module
        if name.startswith("repro_torch.models") and hasattr(mod, "COMPUTE_DTYPE"):
            setattr(mod, "COMPUTE_DTYPE", torch.float32)
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.common import gather_from_model
    from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), **json.loads(os.environ["VARIANT"]))
    M = int(os.environ["MODEL"])
    mesh = make_host_mesh(model=M)
    rules = shd.build_rules(cfg, mesh)
    shd.install_constraints(mesh, rules, cfg)
    model = get_model(cfg)
    tree = model.init(cfg, torch.Generator().manual_seed(3))
    params = shd.shard_tree(tree, model.schema(cfg), rules, mesh, mesh.get_local_rank("model"))
    rng = np.random.default_rng(11)
    d, B, S, N = cfg.d_model, 2, 16, 48
    wt = torch.from_numpy((rng.standard_normal((N, d)) * 0.5).astype(np.float32))
    r = mesh.get_local_rank("model")
    if d % M == 0:  # the working table's d-slice
        wt = wt[:, r * d // M:(r + 1) * d // M].contiguous()
    toks = torch.from_numpy(rng.integers(0, N, (B, S)).astype(np.int32))
    whole = lambda x: gather_from_model(x, -1) if x.shape[-1] < cfg.vocab_size else x
    with torch.no_grad():
        last, _ = make_prefill_step(cfg)(params, {"tokens": toks, "working_table": wt})
        cache = model.init_cache(cfg, B, device="cpu")
        step = make_decode_step(cfg)
        steps = []
        for t in range(S):
            logits, cache = step(params, {"token": toks[:, t:t + 1], "working_table": wt}, cache,
                                 None)
            steps.append(whole(logits))
    out = {"prefill": whole(last).numpy(), "decode": torch.cat(steps, 1).numpy(),
           "C": np.array(cache.mlstm.C.shape)}
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("name", ["half-head", "head-and-a-half"])
def test_decode_matches_the_world_of_one(name, tmp_path):
    variant, M = CUTS[name]
    runs = {}
    for world in (1, M):
        out = tmp_path / f"m{world}"
        out.mkdir()
        spawn_ranks(DECODE_SCRIPT, world, out, env_extra={
            "MODEL": str(world), "VARIANT": json.dumps(variant), "OUT": str(out)})
        runs[world] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    one = runs[1][0]
    cfg, _ = _cfgs(variant)
    dp = int(cfg.proj_factor * cfg.d_model)
    assert list(one["C"][-3:]) == [cfg.n_heads, dp // cfg.n_heads, dp // cfg.n_heads]
    _close(one["decode"][:, -1:], one["prefill"], TP_TOL, "one: decode vs prefill")
    for r, got in enumerate(runs[M]):
        assert list(got["C"][-2:]) == [dp // cfg.n_heads, dp // M], r  # [.., dh, channels]
        for key in ("prefill", "decode"):
            _close(got[key], one[key], TP_TOL, f"rank {r} {key} vs the world of one")


SHAPES = {"train": ShapeSpec("train_t", "train", 64, 8),
          "prefill": ShapeSpec("prefill_t", "prefill", 128, 4),
          "decode": ShapeSpec("decode_t", "decode", 128, 8)}


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("rank", [0, 1])
def test_dry_run_traces_the_cut_inside_a_head(kind, rank):
    """Smoke xlstm at a (2, 4) mesh (half of one of its 2 heads a rank):
    every kind of cell traces, and the step gathers over ``model`` (c and
    z, then q and k)."""
    r = DR.run_cell(ARCH, SHAPES[kind].name, (2, 4), rank=rank, cfg=get_smoke_config(ARCH),
                    shape=SHAPES[kind], verbose=False)
    assert "refused" not in r and r["flops_per_rank"] > 0, r
    assert r["collective_counts"].get("all_gather", 0) > 0 and r["link_bytes_by_axis"]["model"] > 0
