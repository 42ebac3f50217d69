"""FSDP over ``data`` (the reference's ``embed`` rule) against the JAX
reference and the port's world of one, on the CPU.

* Placement, for the ten archs' smoke configs at meshes (2, 1), (2, 2) and
  (4, 2) (smoke hymba with 4 heads over 2 kv heads where the model axis is
  2: its 5 heads do not divide): each rank's shard of a leaf the
  reference's ``pspec`` puts on ``data`` is the contiguous 1/D of that dim
  of its ``model`` shard, every ``embed`` dim is cut, and
  ``gather_tree(shard_tree(x))`` is ``x`` bitwise on gloo ranks (to every
  rank and to rank 0's host). For yi-9b and olmoe-1b-7b at (2, 2), each
  rank's shard of every leaf equals, bitwise, the reference's addressable
  shard at the same mesh coordinates (``jax.device_put`` with
  ``schema_shardings`` on an Auto-axes mesh of 4 forced host devices, a
  subprocess).
* Gradients of yi-9b, olmoe-1b-7b and whisper-tiny (fp32 compute, hier_ps,
  2 microbatches of the global batch): gloo ranks on meshes (2, 1) and
  (2, 2), one process each with one CPU thread, run ``make_lm_grads`` on
  their FSDP shards and ``gather_tree`` the result. Against
  ``jax.value_and_grad`` of the reference's ``_make_loss_fn`` on the same
  Auto-axes mesh, its parameters placed by ``schema_shardings`` and each
  microbatch's gradients constrained to them as its dry run constrains
  them: every leaf within ``FP32_TOL`` of its largest magnitude and the
  loss within 1e-5. Against the port's world of one: every leaf within
  ``TP_TOL`` = 1e-5.
* AdamW under FSDP, on seeded gradients that the clip scales down: the
  clip norm equals the world of one's within 1e-6 relative, and one step
  on the shards (parameters, m and v), put back together, equals the
  world of one's within 1e-6 of each leaf's largest magnitude.
* The launcher, fp32 compute: ``launch.train.run`` on four gloo ranks at
  (2, 2), 2 steps (``test_torch_tp_train.check_tp_launcher``: equal losses
  on every rank,
  the leaves whole over ``model`` equal across the ranks holding the same
  data shard, a (2, 2) checkpoint resumed at (2, 2) shard for shard and at
  (1, 1) bitwise); the losses within 1e-5 of the world of one's; and the
  world of one's checkpoint resumed at (2, 2) gathers back to its tensors
  bitwise.
* The dry run: yi-9b's smoke training at (2, 4) holds as many argument
  bytes a rank as the reference's compiled cell on 8 forced host devices
  (``memory_analysis().argument_size_in_bytes``), within 2%.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeSpec, get_smoke_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.common import ParamSpec  # noqa: E402

from test_torch_launch import _close, _flat, _specs  # noqa: E402
from test_torch_lm import _np_params  # noqa: E402
from test_torch_lm_train import FP32_TOL, np_batch  # noqa: E402
from test_torch_sharded_hbm import ROOT, spawn_ranks  # noqa: E402
from test_torch_tp import N_WORKING, TP_TOL, _meshes  # noqa: E402
from test_torch_tp_train import (  # noqa: E402
    FP32_PREFIX,
    LAUNCH_SCRIPT,
    SETTINGS,
    check_tp_launcher,
)

MESHES = [(2, 1), (2, 2), (4, 2)]
HYMBA_TP = {"n_heads": 4, "n_kv_heads": 2}  # smoke hymba's 5 heads do not divide by 2
ADAM_TOL = 1e-6  # AdamW on the shards vs the world of one


def _variant(arch: str, M: int) -> dict:
    return HYMBA_TP if arch == "hymba-1.5b" and M > 1 else {}


def _data_axis(part) -> bool:
    return part in ("data", ("data",))


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_each_rank_holds_the_contiguous_data_piece_of_its_model_shard(arch, mesh):
    D, M = mesh
    variant = _variant(arch, M)
    cfg = dataclasses.replace(get_smoke_config(arch), **variant)
    jcfg = dataclasses.replace(jget_smoke_config(arch), **variant)
    jmesh, tmesh = _meshes(D, M)
    _, row_mesh = _meshes(1, M)  # the model cut alone
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, tmesh)
    jrules = jshd.build_rules(jcfg, jmesh)
    jspecs = {"/".join(path): tuple(jshd.pspec(shape, logical, jrules, jmesh))
              for path, shape, logical in _specs(jget_model(jcfg).schema(jcfg), jcommon.ParamSpec)}
    embed = {"/".join(path) for path, _, logical in _specs(schema, ParamSpec)
             if "embed" in logical}
    tree = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
    row_rules = shd.build_rules(cfg, row_mesh)
    cuts = dict(_flat(shd.model_cuts(schema, rules, tmesh)))
    for m in range(M):
        model_only = dict(_flat(shd.shard_tree(tree, schema, row_rules, row_mesh, m)))
        for d in range(D):
            local = dict(_flat(shd.shard_tree(tree, schema, rules, tmesh, m, d)))
            for name, want in model_only.items():
                spec = jspecs[name]
                on_data = [i for i, part in enumerate(spec) if _data_axis(part)]
                assert (cuts[name] is not None and cuts[name].data is not None) == bool(on_data)
                if on_data:
                    (dim,) = on_data
                    n = want.shape[dim] // D
                    want = want.narrow(dim, d * n, n)
                assert local[name].is_contiguous() and torch.equal(local[name], want), (
                    name, d, m)
    # every embed dim divides at these sizes, so every one is cut over data
    assert {name for name, cut in cuts.items() if cut is not None and cut.data is not None} \
        == embed


ROUND_TRIP_SCRIPT = """
    import dataclasses, json, os
    import torch
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import get_model
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    M = int(os.environ["MODEL"])
    mesh = make_host_mesh(model=M)
    mr, dr = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    leaves = lambda tree, path=(): (
        [x for k, v in tree.items() for x in leaves(v, path + (k,))] if isinstance(tree, dict)
        else [("/".join(path), tree)])
    bad, n = [], 0
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        if arch == "hymba-1.5b" and M > 1:
            cfg = dataclasses.replace(cfg, **json.loads(os.environ["HYMBA"]))
        schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
        tree = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
        local = shd.shard_tree(tree, schema, rules, mesh, mr, dr)
        for form, dst in (("all", None), ("dst", 0)):
            got = shd.gather_tree(local, schema, rules, mesh, dst=dst)
            mine = dst is None or info.rank == dst
            if not mine:
                bad += [f"{arch} {form} {name}" for name, t in leaves(got) if t is not None]
                continue
            for (name, want), (_, t) in zip(leaves(tree), leaves(got)):
                n += 1
                if not (t.dtype == want.dtype and torch.equal(t, want)):
                    bad.append(f"{arch} {form} {name}")
    with open(os.path.join(os.environ["OUT"], f"rank{info.rank}.json"), "w") as f:
        json.dump({"bad": bad, "n": n}, f)
    torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_gather_tree_of_shard_tree_is_the_tree_bitwise(mesh, tmp_path):
    D, M = mesh
    spawn_ranks(ROUND_TRIP_SCRIPT, D * M, tmp_path, env_extra={
        "MODEL": str(M), "OUT": str(tmp_path), "HYMBA": json.dumps(HYMBA_TP)})
    for r in range(D * M):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got["bad"] == [], (r, got["bad"][:5])
        assert got["n"] > (0 if r else 100), r  # rank 0 checks both forms


REF_SHARDS_SCRIPT = """
    import json, sys
    import numpy as np
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_smoke_config
    from repro.launch import sharding as jshd
    from repro.models import get_model
    assert len(jax.devices()) == 4, jax.devices()
    z = np.load(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in json.loads(sys.argv[3]):
        cfg = get_smoke_config(arch)
        shardings = jshd.schema_shardings(get_model(cfg).schema(cfg), jshd.build_rules(cfg, mesh),
                                          mesh)
        for path, sharding in jax.tree_util.tree_leaves_with_path(shardings):
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            x = jax.device_put(z[f"{arch}/{name}"], sharding)
            for shard in x.addressable_shards:
                d, m = np.argwhere(mesh.devices == shard.device)[0]
                out[f"{arch}/{name}/{d}{m}"] = np.asarray(shard.data)
    np.savez(sys.argv[2], **out)
"""


def test_shards_equal_the_reference_addressable_shards_at_2x2(tmp_path):
    archs = ["yi-9b", "olmoe-1b-7b"]
    trees = {a: get_model(get_smoke_config(a)).init(get_smoke_config(a),
                                                    torch.Generator().manual_seed(3))
             for a in archs}
    np.savez(tmp_path / "whole.npz", **{f"{a}/{name}": t.numpy() for a in archs
                                        for name, t in _flat(trees[a])})
    path = tmp_path / "ref_shards.py"
    path.write_text(textwrap.dedent(REF_SHARDS_SCRIPT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, str(path), str(tmp_path / "whole.npz"),
                          str(tmp_path / "ref.npz"), json.dumps(archs)],
                         env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = dict(np.load(tmp_path / "ref.npz"))
    _, mesh = _meshes(2, 2)
    n = 0
    for arch in archs:
        cfg = get_smoke_config(arch)
        schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
        for d in range(2):
            for m in range(2):
                for name, t in _flat(shd.shard_tree(trees[arch], schema, rules, mesh, m, d)):
                    assert np.array_equal(t.numpy(), ref[f"{arch}/{name}/{d}{m}"]), (
                        arch, name, d, m)
                    n += 1
    assert n == len(ref)


# --------------------------------------------------------------------------
# gradients and AdamW: gloo ranks vs the reference and the world of one
# --------------------------------------------------------------------------

JAX_GRAD_SCRIPT = """
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    import repro.models.hymba, repro.models.moe, repro.models.whisper, repro.models.xlstm
    from repro.configs import get_smoke_config
    from repro.launch import sharding as jshd
    from repro.models.common import constrain_like_params, set_param_constraint_fn
    from repro.models import get_model
    from repro.train.train_step import TrainSettings, _make_loss_fn
    for name, mod in list(sys.modules.items()):  # fp32 compute in every model module
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if name.startswith("repro.models") and hasattr(mod, attr):
                setattr(mod, attr, jnp.float32)
    assert len(jax.devices()) == 4, jax.devices()
    z = np.load(sys.argv[1])
    cfg = get_smoke_config(sys.argv[3])
    params = {}
    for k in z.files:
        if k.startswith("p/"):
            d = params
            *head, last = k[2:].split("/")
            for h in head:
                d = d.setdefault(h, {})
            d[last] = jnp.asarray(z[k])
    out = {}
    for data, model in json.loads(sys.argv[4]):
        # Auto axes: with the default Explicit ones with_sharding_constraint refuses
        mesh = jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2,
                             devices=jax.devices()[:data * model])
        rules = jshd.build_rules(cfg, mesh)
        jshd.install_constraints(mesh, rules)
        shardings = jshd.schema_shardings(get_model(cfg).schema(cfg), rules, mesh)
        set_param_constraint_fn(lambda g: jax.tree.map(jax.lax.with_sharding_constraint, g,
                                                       shardings))
        placed = jax.device_put(params, shardings)
        loss_fn = _make_loss_fn(cfg, TrainSettings(microbatches=2), True)

        def vg(p, wt, micro):
            (_, (loss, _)), (gp, gt) = jax.value_and_grad(loss_fn, argnums=(0, 1),
                                                          has_aux=True)(p, wt, micro)
            return loss, constrain_like_params(gp), gt

        vg = jax.jit(vg)
        n = z["tokens"].shape[0] // 2
        acc, losses = None, []
        for i in range(2):
            micro = {k: jnp.asarray(z[k][i * n:(i + 1) * n]) for k in ("tokens", "targets")}
            for extra in ("image_embeds", "frames"):
                if extra in z.files:
                    micro[extra] = jnp.asarray(z[extra][i * n:(i + 1) * n], jnp.bfloat16)
            loss, gp, gt = vg(placed, jnp.asarray(z["wt"]), micro)
            acc = (gp, gt) if acc is None else jax.tree.map(jnp.add, acc, (gp, gt))
            losses.append(float(loss))
        jshd.clear_constraints()
        set_param_constraint_fn(None)
        pg, tg = jax.tree.map(lambda a: np.asarray(a) / 2, acc)
        tag = f"{data}x{model}/"
        out[tag + "loss"] = np.mean(losses)
        out[tag + "t"] = tg
        out.update({tag + "g/" + "/".join(str(getattr(p, "key", p)) for p in path): leaf
                    for path, leaf in jax.tree_util.tree_leaves_with_path(pg)})
    np.savez(sys.argv[2], **out)
"""

FSDP_GRAD_SCRIPT = """
    import json, os, sys
    import numpy as np
    import torch
    import repro_torch.models.hymba, repro_torch.models.moe, repro_torch.models.whisper
    import repro_torch.models.xlstm
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.common import data_group, gather_from_model
    from repro_torch.train.optim import AdamW, global_norm, tree_map
    from repro_torch.train.train_step import TrainSettings, make_lm_grads, replicated_leaves
    for name, mod in list(sys.modules.items()):  # fp32 compute in every model module
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if name.startswith("repro_torch.models") and hasattr(mod, attr):
                setattr(mod, attr, torch.float32)
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = get_smoke_config(os.environ["ARCH"])
    z = np.load(os.environ["INPUTS"])
    tree, gtree = {}, {}
    for k in z.files:
        for prefix, t in (("p/", tree), ("sg/", gtree)):
            if k.startswith(prefix):
                d = t
                *head, last = k[len(prefix):].split("/")
                for h in head:
                    d = d.setdefault(h, {})
                d[last] = z[k]
    mesh = make_host_mesh(model=int(os.environ["MODEL"]))
    rules = shd.build_rules(cfg, mesh)
    shd.install_constraints(mesh, rules, cfg)
    assert (data_group() is not None) == (mesh.size(0) > 1)
    schema = get_model(cfg).schema(cfg)
    mr, nd, dr = mesh.get_local_rank("model"), mesh.size(0), mesh.get_local_rank("data")
    place = lambda t: shd.shard_tree(t, schema, rules, mesh, mr, dr)
    params = place(lm_params_from_numpy(cfg, tree, device="cpu"))
    B = z["tokens"].shape[0] // nd
    batch = {k: torch.from_numpy(z[k][dr * B:(dr + 1) * B]) for k in ("tokens", "targets")}
    for extra in ("image_embeds", "frames"):
        if extra in z.files:
            batch[extra] = torch.from_numpy(z[extra][dr * B:(dr + 1) * B]).to(torch.bfloat16)
    M, d = mesh.size(1), cfg.d_model
    wt = torch.from_numpy(z["wt"][:, mr * d // M:(mr + 1) * d // M].copy())
    g, tg, metrics = make_lm_grads(cfg, TrainSettings(microbatches=2 // nd), hier=True)(
        params, batch, wt)
    whole = lambda t: shd.gather_tree(t, schema, rules, mesh)
    out = {"loss": float(metrics["loss"]), "t": gather_from_model(tg, -1).numpy()}
    # AdamW on seeded gradients of the parameters' shapes, cut as they are
    sg = place(tree_map(torch.from_numpy, gtree))
    mask = {axis: replicated_leaves(cfg, params, axis) for axis in ("model", "data")}
    opt = AdamW(lr=1e-2)
    new, state = opt.update(sg, opt.init(params), params, replicated=mask)
    out["norm"] = float(global_norm(sg, mask))
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = node.numpy()
    for name, t in (("g", g), ("n", new), ("m", state.m), ("v", state.v)):
        walk(whole(t), (name,))
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
"""

REF_MESHES = [(2, 1), (2, 2)]


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b", "whisper-tiny"])
def test_fsdp_gradients_and_adamw_match_the_reference_and_the_world_of_one(arch, tmp_path):
    jcfg = jget_smoke_config(arch)
    params = _np_params(jcfg, 0)
    inputs = {"p/" + k: v for k, v in _flat(params)}
    rng = np.random.default_rng(11)  # gradients whose norm the clip (1.0) scales down
    inputs.update({"sg/" + k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
                   for k, v in _flat(params)})
    inputs.update(np_batch(jcfg, n_working=N_WORKING), wt=(np.random.default_rng(5).standard_normal(
        (N_WORKING, jcfg.d_model)) * 0.02).astype(np.float32))
    np.savez(tmp_path / "inputs.npz", **inputs)
    path = tmp_path / "jax_fsdp.py"
    path.write_text(textwrap.dedent(JAX_GRAD_SCRIPT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen([sys.executable, str(path), str(tmp_path / "inputs.npz"),
                                 str(tmp_path / "jax.npz"), arch, json.dumps(REF_MESHES)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    runs = {}
    for data, model in [(1, 1)] + REF_MESHES:
        mesh = f"{data}x{model}"
        out = tmp_path / mesh
        out.mkdir()
        spawn_ranks(FSDP_GRAD_SCRIPT, data * model, out, env_extra={
            "ARCH": arch, "MODEL": str(model), "INPUTS": str(tmp_path / "inputs.npz"),
            "OUT": str(out)})
        runs[mesh] = [dict(np.load(out / f"rank{r}.npz")) for r in range(data * model)]
    _, err = jax_proc.communicate(timeout=240)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp_path / "jax.npz"))
    one = runs["1x1"][0]
    names = sorted(k for k in one if k.startswith("g/"))
    assert len(names) > 5
    for mesh in ("2x1", "2x2"):
        for rank in runs[mesh]:  # every rank gathers the same whole tensors
            for name in rank:
                assert np.array_equal(rank[name], runs[mesh][0][name]), (mesh, name)
        got = runs[mesh][0]
        assert sorted(k for k in ref if k.startswith(mesh + "/g/")) == [
            f"{mesh}/{n}" for n in names]
        assert abs(got["loss"] - ref[mesh + "/loss"]) <= 1e-5 * abs(ref[mesh + "/loss"]), mesh
        assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"]), mesh
        for name in names + ["t"]:
            _close(got[name], ref[f"{mesh}/{name}"], FP32_TOL, f"{mesh} {name} vs the reference")
            _close(got[name], one[name], TP_TOL, f"{mesh} {name} vs the world of one")
        # AdamW on the same seeded gradients: the clip norm, and one step
        assert one["norm"] > 1.0
        assert abs(got["norm"] - one["norm"]) <= ADAM_TOL * one["norm"], (mesh, got["norm"])
        for name in one:
            if name[:2] in ("n/", "m/", "v/"):
                _close(got[name], one[name], ADAM_TOL, f"{mesh} AdamW {name}")


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

RESUME_SCRIPT = """
    import os
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.train.optim import AdamW
    from repro_torch.train.train_step import TrainSettings
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = get_smoke_config(os.environ["ARCH"])
    settings = TrainSettings(optimizer=AdamW(lr=float(os.environ["LR"])), microbatches=1)
    res = launch.run(cfg, settings, steps=0, model_parallel=2, resume=True,
                     base=os.environ["BASE"], ckpt_every=0, device="cpu")
    out = {"step": res.opt_state.step.numpy()}
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = node.float().numpy()
    for name, tree in (("whole", res.params), ("whole_m", res.opt_state.m),
                       ("whole_v", res.opt_state.v)):
        walk(res.whole(tree), (name,))
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
"""


def test_fsdp_launcher_tracks_the_world_of_one_and_resumes_across_meshes(tmp_path):
    arch = "yi-9b"
    # (2, 2), fp32 compute: equal losses and shards, resumed at (2, 2) and (1, 1)
    (tmp_path / "2x2").mkdir()
    check_tp_launcher(arch, 2, tmp_path / "2x2", fp32=True)
    fsdp = dict(np.load(tmp_path / "2x2" / "rank0.npz"))
    # the world of one, on the same global batch in the same two microbatches
    one_dir = tmp_path / "1x1"
    one_dir.mkdir()
    spawn_ranks(textwrap.dedent(FP32_PREFIX) + textwrap.dedent(LAUNCH_SCRIPT), 1, one_dir,
                env_extra={"ARCH": arch, "MODEL": "1", "BASE": str(one_dir / "run"),
                           "OUT": str(one_dir), "LR": str(SETTINGS["lr"]),
                           "MICRO": str(SETTINGS["microbatches"]), "VARIANT": "{}"})
    one = dict(np.load(one_dir / "rank0.npz"))
    np.testing.assert_allclose(fsdp["losses"], one["losses"], rtol=TP_TOL)
    # the world of one's step-2 checkpoint resumed on four ranks at (2, 2)
    res_dir = tmp_path / "resume"
    res_dir.mkdir()
    spawn_ranks(RESUME_SCRIPT, 4, res_dir, env_extra={
        "ARCH": arch, "BASE": str(one_dir / "run"), "OUT": str(res_dir),
        "LR": str(SETTINGS["lr"])})
    names = [k for k in one if k.split("/")[0] in ("whole", "whole_m", "whole_v")]
    assert len(names) > 10
    for r in range(4):
        got = dict(np.load(res_dir / f"rank{r}.npz"))
        assert int(got["step"]) == 2
        assert sorted(k for k in got if k != "step") == sorted(names)
        for name in names:
            assert np.array_equal(got[name], one[name]), (r, name)


# --------------------------------------------------------------------------
# the dry run's argument bytes against the reference's compiled cell
# --------------------------------------------------------------------------

REF_ARGS_SCRIPT = """
    import json, sys
    import jax
    from jax.sharding import AxisType
    jax.devices()  # the backend exists before the reference's dryrun sets its device count
    from repro.configs import ShapeSpec, get_smoke_config
    from repro.launch import dryrun as DR
    from repro.launch import sharding as shd
    from repro.models.common import set_param_constraint_fn
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    fn, a, shards = DR.build_cell(get_smoke_config("yi-9b"), ShapeSpec(*json.loads(sys.argv[1])),
                                  mesh)
    with mesh:
        compiled = jax.jit(fn, in_shardings=shards).lower(*a).compile()
    shd.clear_constraints()
    set_param_constraint_fn(None)
    print(json.dumps(compiled.memory_analysis().argument_size_in_bytes))
"""

ARGS_RTOL = 0.02


def test_dry_run_argument_bytes_match_the_reference_at_2x4():
    shape = ShapeSpec("train_t", "train", 64, 8)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_ARGS_SCRIPT),
                          json.dumps([shape.name, shape.kind, shape.seq_len, shape.global_batch])],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    r = DR.run_cell("yi-9b", shape.name, (2, 4), cfg=get_smoke_config("yi-9b"), shape=shape,
                    verbose=False)
    got = r["memory_per_rank"]["argument_bytes"]
    assert abs(got - ref) <= ARGS_RTOL * ref, (got, ref)
