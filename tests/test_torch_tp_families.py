"""Tensor parallelism over ``model`` for the hybrid, SSM and audio families
(hymba and its mamba mixer, xlstm's mLSTM and sLSTM, whisper) against the
JAX reference and the port's world of one, on the CPU.

* Placement: ``shard_tree`` cuts each leaf the reference's rules put on
  ``model`` and no other; a fused leaf (``sharding.FUSED_BLOCKS``: mamba's
  ``in_proj``, the mLSTM's ``w_up``, the sLSTM's ``w_zifo``, ``b_zifo`` and
  ``ffn_up``) holds piece r of each of its blocks, the mLSTM's
  ``wq``/``wk``/``wv`` their heads r*H/M..(r+1)*H/M, every other sharded
  leaf its contiguous 1/M; each rank's parameter count is the whole tree's
  less 1 - 1/M of every leaf the rules put on ``model``; ``gather_tree``
  of the ranks' shards (gloo ranks, both forms) is the whole tree bitwise.
  At model axis 2 for the three families and 5 for hymba.
* Refusals: mamba's inner width and the sLSTM's ``d_model`` not dividing
  (their fused blocks) and xlstm-1.3b's mLSTM at 8 (cut inside its heads),
  with their messages; published hymba-1.5b at 2 (25 heads) and smoke
  xlstm at 3 (every leaf whole), refused before, placed.
* Gradients (``test_torch_tp.check_tp_grads``: hier_ps, fp32 compute, gloo
  ranks on (1, 2) and (2, 2) meshes, gathered): against the reference's
  GSPMD step on 4 forced host devices within ``FP32_TOL``, against the
  port's world of one within ``TP_TOL`` (xlstm's ``mlstm/b_i``, a sum that
  nearly cancels, within 1e-4: ``LOOSE``). Smoke configs whose heads divide
  over 2 (hymba: 4 q heads over 2 kv heads, and over 1 replicated kv
  head), every bias and norm drawn
  (``init`` makes them zeros and ones, under which a bias added once per
  rank would not show).
* The launcher (``test_torch_tp_train.check_tp_launcher``): two steps at
  ``model_parallel=2``, replicated leaves bitwise equal across the ranks, a
  TP = 2 checkpoint resumed at TP = 2 shard for shard and at TP = 1
  bitwise.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train.train_step import replicated_leaves  # noqa: E402

from test_torch_launch import _flat, _specs  # noqa: E402
from test_torch_sharded_hbm import spawn_ranks  # noqa: E402
from test_torch_tp import (  # noqa: E402
    _meshes,
    check_reference_shapes,
    check_reference_slices,
    check_tp_grads,
    expected_shard,
)
from test_torch_tp_train import check_tp_launcher  # noqa: E402

# the smoke configs whose heads divide over a model axis of 2 (hymba's 5
# heads do not), and hymba's at 5 (d_model 80: mamba's inner width 160)
VARIANTS = {"hymba-1.5b": {"n_heads": 4, "n_kv_heads": 2}, "xlstm-1.3b": {}, "whisper-tiny": {}}
PLACEMENTS = [(a, 2, v) for a, v in VARIANTS.items()] + [("hymba-1.5b", 5, {"d_model": 80})]
# xlstm's mlstm/b_i gradient nearly cancels (test_torch_lm_train's BF16_LOOSE
# holds it apart in bf16 for the same reason): the last-bit differences of
# the row-parallel gate sums leave it 2.0e-5 of its largest from the world
# of one's, where every other leaf of the three families is within 1.3e-6
LOOSE = {"xlstm-1.3b": {"g/mlstm/b_i": 1e-4}}


def _cfgs(arch, variant):
    return (dataclasses.replace(get_smoke_config(arch), **variant),
            dataclasses.replace(jget_smoke_config(arch), **variant))


@pytest.mark.parametrize("arch,M,variant", PLACEMENTS)
def test_shard_tree_places_fused_and_per_head_leaves(arch, M, variant):
    cfg, jcfg = _cfgs(arch, variant)
    jmesh, mesh = _meshes(1, M)
    shd.check_model_parallel(cfg, mesh)
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
    jrules = jshd.build_rules(jcfg, jmesh)
    jspecs = {"/".join(path): tuple(jshd.pspec(shape, logical, jrules, jmesh))
              for path, shape, logical in _specs(jget_model(jcfg).schema(jcfg), jcommon.ParamSpec)}
    tree = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
    parts = [dict(_flat(shd.shard_tree(tree, schema, rules, mesh, r))) for r in range(M)]
    mask = dict(_flat(replicated_leaves(cfg, shd.shard_tree(tree, schema, rules, mesh, 0))))
    cuts = dict(_flat(shd.model_cuts(schema, rules, mesh)))
    whole_n = on_model = 0
    fused = heads = 0
    for name, whole in _flat(tree):
        spec, key = jspecs[name], tuple(name.split("/")[-2:])
        whole_n += whole.numel()
        assert mask[name] == ("model" not in spec) == (cuts[name] is None), name
        if "model" not in spec:
            for part in parts:
                assert part[name] is whole, name
            continue
        on_model += whole.numel()
        fused += key in shd.FUSED_BLOCKS
        heads += key in shd.HEAD_CUT
        for r, part in enumerate(parts):
            want = expected_shard(whole, key, spec, r, M)
            assert part[name].is_contiguous() and torch.equal(part[name], want), (name, r)
        joined = shd.join_shards([part[name] for part in parts], cuts[name])
        assert joined.dtype == whole.dtype and torch.equal(joined, whole), name
    for part in parts:  # the whole tree's count less 1 - 1/M of every leaf on model
        assert sum(t.numel() for t in part.values()) * M == whole_n * M - on_model * (M - 1)
    assert fused == {"hybrid": 2, "ssm": 4, "audio": 0}[cfg.family]
    assert heads == (3 if cfg.family == "ssm" else 0)


GATHER_SCRIPT = """
    import dataclasses, json, os
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import get_model
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = dataclasses.replace(get_smoke_config(os.environ["ARCH"]),
                              **json.loads(os.environ["VARIANT"]))
    mesh = make_host_mesh(model=int(os.environ["MODEL"]))
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
    tree = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
    local = shd.shard_tree(tree, schema, rules, mesh, mesh.get_local_rank("model"))
    out = {"all": shd.gather_tree(local, schema, rules, mesh),
           "dst": shd.gather_tree(local, schema, rules, mesh, dst=0)}
    torch.save(out, os.path.join(os.environ["OUT"], f"rank{info.rank}.pt"))
    torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("arch,M,variant", [PLACEMENTS[0], PLACEMENTS[-1]])
def test_gather_tree_joins_the_ranks_shards_bitwise(arch, M, variant, tmp_path):
    spawn_ranks(GATHER_SCRIPT, M, tmp_path, env_extra={
        "ARCH": arch, "MODEL": str(M), "VARIANT": json.dumps(variant), "OUT": str(tmp_path)})
    cfg, _ = _cfgs(arch, variant)
    tree = dict(_flat(get_model(cfg).init(cfg, torch.Generator().manual_seed(3))))
    for r in range(M):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert all(t is None for _, t in _flat(got["dst"])) == (r > 0)
        for form in ("all", "dst") if r == 0 else ("all",):
            flat = dict(_flat(got[form]))
            assert sorted(flat) == sorted(tree)
            for name, whole in tree.items():
                assert torch.equal(flat[name], whole), (r, form, name)


@pytest.mark.parametrize("cfgs,M,match", [
    ((get_config("hymba-1.5b"), jget_config("hymba-1.5b")), 2, None),
    ((get_smoke_config("xlstm-1.3b"), jget_smoke_config("xlstm-1.3b")), 3, None),
    (_cfgs("hymba-1.5b", {"d_model": 65, "n_heads": 4, "n_kv_heads": 2}), 4,
     "swa_layers/ssm/in_proj's 2 fused blocks unevenly"),
    (_cfgs("xlstm-1.3b", {"d_model": 65, "proj_factor": 4.0}), 2,
     "slstm/w_zifo's 4 fused blocks unevenly"),
    ((get_config("xlstm-1.3b"), jget_config("xlstm-1.3b")), 8,
     "mLSTM's 4 heads of 1024 inside a head"),
], ids=["hymba-1.5b-heads", "xlstm-smoke-mlstm-heads", "hymba-din", "xlstm-slstm-d",
        "xlstm-1.3b-8"])
def test_family_specs_the_port_does_not_place_raise(cfgs, M, match):
    """The refusals left (``match``): a fused leaf whose blocks the axis
    does not divide, and the mLSTM cut inside its heads. Published
    hymba-1.5b's 25 heads over 2 (a cut inside a head) and smoke xlstm's 2
    mLSTM heads over 3 (every mLSTM and sLSTM leaf whole), refused before,
    are placed on the reference's shapes and slices."""
    cfg, jcfg = cfgs
    _, mesh = _meshes(1, M)
    if match is None:
        if cfg.n_layers > 2:  # published widths: shapes on the meta device
            assert check_reference_shapes(cfg, jcfg, M) > 0
        else:
            check_reference_slices(cfg, jcfg, M)
        return
    with pytest.raises(NotImplementedError, match=f"{cfg.name}: a model axis of {M} .*{match}"
                       r".*ROADMAP §1 item 3"):
        shd.check_model_parallel(cfg, mesh)


@pytest.mark.parametrize("arch,M", [("hymba-1.5b", 5), ("xlstm-1.3b", 2), ("whisper-tiny", 2),
                                    ("xlstm-1.3b", 4)])
def test_published_family_configs_are_placed(arch, M):
    """The chip's cells (and xlstm-1.3b at 4): no refusal; hymba's MLP and
    ``lm_head`` and whisper's ``lm_head`` stay whole where they do not
    divide."""
    cfg = get_config(arch)
    _, mesh = _meshes(1, M)
    shd.check_model_parallel(cfg, mesh)
    cuts = dict(_flat(shd.model_cuts(get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh),
                                     mesh)))
    assert (cuts["lm_head"] is None) == (cfg.vocab_size % M != 0)
    if arch == "hymba-1.5b":
        assert cuts["swa_layers/mlp/wi"] is None and cuts["swa_layers/ssm/in_proj"].blocks == 2


# and hymba's kv heads replicated (4 q heads over 1 kv head): the layer's one
# region entry leaves the replicated wk's and wv's gradients to be summed
GRAD_CASES = [(a, v) for a, v in VARIANTS.items()] + [
    ("hymba-1.5b", {"n_heads": 4, "n_kv_heads": 1})]


@pytest.mark.parametrize("arch,variant", GRAD_CASES,
                         ids=list(VARIANTS) + ["hymba-1.5b-replicated-kv"])
def test_family_tp_gradients_match_the_reference_and_the_world_of_one(arch, variant, tmp_path):
    check_tp_grads(arch, tmp_path, variant, LOOSE.get(arch), drawn_constants=True)


@pytest.mark.parametrize("arch", list(VARIANTS))
def test_family_tp_launcher_keeps_replicated_leaves_equal_and_resumes_at_tp1(arch, tmp_path):
    check_tp_launcher(arch, 1, tmp_path, VARIANTS[arch])
