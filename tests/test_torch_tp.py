"""Tensor parallelism over the ``model`` axis (the transformer family)
against the JAX reference and the port's world of one, on the CPU.

* Placement: ``shard_tree`` gives each rank of a (2, M) mesh the slice of
  every leaf that the reference's ``pspec`` puts on ``model`` and on
  ``data`` (the ``embed`` rule's FSDP), contiguous on each, and the ranks'
  shards put back together along ``model_cuts``' dims are the whole tree
  bitwise, for the seven archs of the family at model axes 2 and 4; the
  train step's ``replicated_leaves`` marks the leaves with no ``model``
  (and, over ``data``, no ``data``) in their spec.
* The specs refused before this port cut q heads inside a head, read
  replicated kv from inside a group and cut inside each expert's ``mlp``
  are placed on the reference's slices (``tests/test_torch_tp_uneven.py``
  has every published pair and their gradients; the refusals left:
  ``tests/test_torch_tp_families.py``).
* With no ``model`` group installed the three operators, the cross
  entropy and the clip norm are what they were.
* Gradients (this file: the dense archs with replicated kv, yi-9b and
  granite-20b; ``tests/test_torch_tp_train.py``: MoE and VLM): gloo ranks
  on meshes (1, 2) and (2, 2) (the latter FSDP over ``data`` too), one
  process each with one CPU thread, compute ``make_lm_grads`` (hier_ps,
  fp32 compute, 2 microbatches of the global batch) on their shards and
  ``gather_tree`` the result. Against
  ``jax.value_and_grad`` of the reference's ``_make_loss_fn`` under
  ``install_constraints`` on a (2, 2) mesh of 4 forced host devices with
  Auto axes (a subprocess): every leaf within ``FP32_TOL`` of its largest
  magnitude and the loss within 1e-5. Against the port's world of one (one
  process, one thread): every leaf within ``TP_TOL`` = 1e-5.

Gradients are compared, never the table after a step: the first
row-Adagrad step moves each element by ``row_lr * g / |g|``, so a gradient
near zero that flips sign moves it by ``2 * row_lr``.
"""

import dataclasses
import json
import math
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
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models import common, get_model  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402
from repro_torch.train.optim import global_norm  # noqa: E402
from repro_torch.train.train_step import cross_entropy, replicated_leaves  # noqa: E402

from test_torch_launch import _close, _flat, _specs  # noqa: E402
from test_torch_launch import _meshes as _shape_meshes  # noqa: E402
from test_torch_lm import _np_params  # noqa: E402
from test_torch_lm_train import FP32_TOL, np_batch  # noqa: E402
from test_torch_sharded_hbm import ROOT, spawn_ranks  # noqa: E402

TP_TOL = 1e-5  # tensor parallel vs one process: max |diff| <= TP_TOL * max |ref|
TRANSFORMERS = ["yi-9b", "granite-20b", "nemotron-4-340b", "phi3-mini-3.8b", "olmoe-1b-7b",
                "phi3.5-moe-42b-a6.6b", "pixtral-12b"]
N_WORKING = 64


def _meshes(data, model):
    """(the reference's mesh stand-in, the port's) of a (data, model) mesh."""
    return _shape_meshes((data, model), ("data", "model"))


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


def expected_shard(whole: torch.Tensor, key: tuple, spec: tuple, r: int, M: int):
    """Rank ``r``'s shard as the placement states it, built independently
    of ``shard_leaf``: the fused blocks' pieces, the heads, the output
    columns (head, column) r n .. (r + 1) n - 1 of a per-head leaf whose
    heads M does not divide (n = H dh / M), or a contiguous 1/M of the dim
    the reference's spec puts ``model`` on."""
    if key in shd.HEAD_CUT:
        H, dh = whole.shape[-3], whole.shape[-1]
        if H % M == 0:
            return whole[..., r * H // M:(r + 1) * H // M, :, :]
        n = H * dh // M
        return torch.stack([whole[..., j // dh, :, j % dh] for j in range(r * n, (r + 1) * n)], -1)
    dim = spec.index("model")
    k = shd.FUSED_BLOCKS.get(key, 1)
    blocks = torch.chunk(whole, k, dim)
    return torch.cat([torch.chunk(b, M, dim)[r] for b in blocks], dim)


def reference_specs(jcfg, jmesh) -> dict:
    """{leaf path: the reference's ``pspec``} of ``jcfg``'s schema on
    ``jmesh``."""
    jrules = jshd.build_rules(jcfg, jmesh)
    return {"/".join(path): tuple(jshd.pspec(shape, logical, jrules, jmesh))
            for path, shape, logical in _specs(jget_model(jcfg).schema(jcfg), jcommon.ParamSpec)}


def _axes(spec: tuple, ndim: int) -> list:
    return [spec[i] if i < len(spec) else None for i in range(ndim)]


def check_reference_shapes(cfg, jcfg, M: int, D: int = 2) -> int:
    """``check_model_parallel`` takes ``cfg`` at a (D, M) mesh and
    ``shard_tree`` gives each rank, on the ``meta`` device, the shape of every
    leaf that the reference's ``pspec`` gives it (the mLSTM's per-head
    leaves, ``HEAD_CUT``: as many elements, on the port's cut, its heads
    [.., H / M, dh, dh] or its output columns [.., dh, H dh / M]);
    ``model_cuts`` cuts over ``model`` exactly the leaves the spec puts on
    it. -> the leaves on ``model``."""
    jmesh, mesh = _meshes(D, M)
    shd.check_model_parallel(cfg, mesh)
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
    jspecs = reference_specs(jcfg, jmesh)
    tree = abstract_params(schema)
    cuts = dict(_flat(shd.model_cuts(schema, rules, mesh)))
    whole = dict(_flat(tree))
    for m in range(M):
        for dr in range(D):
            part = dict(_flat(shd.shard_tree(tree, schema, rules, mesh, m, dr)))
            for name, t in whole.items():
                axes = _axes(jspecs[name], t.dim())
                want = [n // M if ax == "model" else n // D if ax in ("data", ("data",)) else n
                        for ax, n in zip(axes, t.shape)]
                if tuple(name.split("/")[-2:]) in shd.HEAD_CUT and "model" in axes:
                    assert part[name].numel() == math.prod(want), (name, jspecs[name])
                    *lead, H, dh, _ = t.shape
                    want = lead + ([H // M, dh, dh] if H % M == 0 else [dh, H * dh // M])
                assert list(part[name].shape) == want, (name, jspecs[name])
                assert (cuts[name] is None or cuts[name].dim is None) == ("model" not in axes)
    return sum("model" in jspecs[name] for name in whole)


def check_reference_slices(cfg, jcfg, M: int, D: int = 2) -> None:
    """``check_model_parallel`` takes ``cfg`` at a (D, M) mesh, each rank's
    shard of every leaf of seeded weights is the reference's slice
    (:func:`expected_shard` over ``model``, then its contiguous 1/D over
    ``data``), contiguous, and the ranks' shards join back bitwise."""
    jmesh, mesh = _meshes(D, M)
    shd.check_model_parallel(cfg, mesh)
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
    jspecs = reference_specs(jcfg, jmesh)
    tree = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
    cuts = dict(_flat(shd.model_cuts(schema, rules, mesh)))
    parts = {(m, dr): dict(_flat(shd.shard_tree(tree, schema, rules, mesh, m, dr)))
             for m in range(M) for dr in range(D)}
    for name, whole in _flat(tree):
        spec, key = jspecs[name], tuple(name.split("/")[-2:])
        axes = _axes(spec, whole.dim())
        ddim = next((i for i, ax in enumerate(axes) if ax in ("data", ("data",))), None)
        for (m, dr), part in parts.items():
            want = whole if "model" not in axes else expected_shard(whole, key, axes, m, M)
            if ddim is not None:
                want = torch.chunk(want, D, ddim)[dr]
            assert part[name].is_contiguous() and torch.equal(part[name], want), (name, m, dr)
        rows = [parts[(0, dr)][name] if cuts[name] is None or cuts[name].dim is None
                else shd.join_shards([parts[(m, dr)][name] for m in range(M)], cuts[name])
                for dr in range(D)]
        joined = rows[0] if ddim is None else torch.cat(rows, ddim)
        assert joined.dtype == whole.dtype and torch.equal(joined, whole), name


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_shard_tree_takes_the_reference_slices_and_joins_back_bitwise(arch, M):
    cfg, jcfg = get_smoke_config(arch), jget_smoke_config(arch)
    D = 2
    jmesh, mesh = _meshes(D, M)
    schema, rules = get_model(cfg).schema(cfg), shd.build_rules(cfg, mesh)
    jrules = jshd.build_rules(jcfg, jmesh)
    jspecs = {"/".join(path): tuple(jshd.pspec(shape, logical, jrules, jmesh))
              for path, shape, logical in _specs(jget_model(jcfg).schema(jcfg), jcommon.ParamSpec)}
    tree = get_model(cfg).init(cfg, torch.Generator().manual_seed(3))
    data_dims = shd.data_dims(schema, rules, mesh)
    parts = {(d, m): dict(_flat(shd.shard_tree(tree, schema, rules, mesh, m, d)))
             for d in range(D) for m in range(M)}
    local = shd.shard_tree(tree, schema, rules, mesh, 0, 0)
    whole_over = {axis: dict(_flat(replicated_leaves(cfg, local, axis, data_dims)))
                  for axis in ("model", "data")}
    cuts = dict(_flat(shd.model_cuts(schema, rules, mesh)))
    n_sharded = n_data = 0
    for name, whole in _flat(tree):
        spec = jspecs[name]
        axes = [spec[i] if i < len(spec) else None for i in range(whole.dim())]
        want = [n // M if ax == "model" else n // D if ax in ("data", ("data",)) else n
                for ax, n in zip(axes, whole.shape)]
        mdim = None if cuts[name] is None else cuts[name].dim
        ddim = None if cuts[name] is None else cuts[name].data
        assert whole_over["model"][name] == ("model" not in axes) == (mdim is None), name
        assert whole_over["data"][name] == (ddim is None) == (
            "data" not in axes and ("data",) not in axes), name
        n_sharded += "model" in axes
        n_data += ddim is not None
        for part in parts.values():
            assert list(part[name].shape) == want and part[name].is_contiguous(), (name, spec)
        rows = [parts[(d, 0)][name] if mdim is None
                else torch.cat([parts[(d, m)][name] for m in range(M)], mdim) for d in range(D)]
        joined = rows[0] if ddim is None else torch.cat(rows, ddim)
        assert joined.dtype == whole.dtype and torch.equal(joined, whole), name
    assert n_sharded >= 5  # q heads, the MLP or experts, lm_head at least
    assert n_data >= 7  # every layer's projections and lm_head: the embed rule over data


@pytest.mark.parametrize("arch,M,heads,match", [
    ("nemotron-4-340b", 4, None, "inside a head"),
    ("olmoe-1b-7b", 3, None, "experts"),
    ("phi3.5-moe-42b-a6.6b", 8, None, "experts"),
    ("yi-9b", 2, (12, 3), "unevenly"),  # 6 local q heads over kv groups of 4
])
def test_specs_the_port_does_not_place_raise(arch, M, heads, match):
    """The specs the port refused before it placed them (``match``: what
    the refusal said) are placed on the reference's slices: q heads cut
    inside a head (nemotron's 6 over 4 ranks), every expert leaf whole
    (olmoe's 8 experts and d_ff 64 over 3), ``model`` inside each expert's
    ``mlp`` (phi3.5-moe's 4 experts over 8), q heads reading replicated kv
    from inside a group (``tests/test_torch_tp_uneven.py`` has the rest)."""
    variant = {"n_heads": heads[0], "n_kv_heads": heads[1]} if heads else {}
    cfg = dataclasses.replace(get_smoke_config(arch), **variant)
    jcfg = dataclasses.replace(jget_smoke_config(arch), **variant)
    check_reference_slices(cfg, jcfg, M)


@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_every_transformer_arch_is_placed_at_model_axis_2(arch):
    _, mesh = _meshes(1, 2)
    shd.check_model_parallel(get_smoke_config(arch), mesh)


def test_operators_are_the_identity_without_a_model_group():
    assert common.model_group() is None and common.model_rank_and_size() == (0, 1)
    x = torch.randn(3, 4, requires_grad=True)
    for op in (common.copy_to_model, common.reduce_from_model,
               lambda t: common.gather_from_model(t, -1)):
        assert op(x) is x
    assert common.local_range(8, 8) == (0, 8)
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 33)).astype(np.float32) * 4)
    targets = torch.from_numpy(rng.integers(0, 33, (2, 5)))
    assert torch.equal(cross_entropy(logits, targets, 33), cross_entropy(logits, targets))
    tree = {"a": torch.randn(4, 3), "b": {"c": torch.randn(5)}}
    flags = {"a": False, "b": {"c": True}}
    assert torch.equal(global_norm(tree, flags), global_norm(tree))


# --------------------------------------------------------------------------
# gradients: gloo ranks vs the reference on a (2, 2) mesh and the world of one
# --------------------------------------------------------------------------

JAX_SCRIPT = """
    import dataclasses, json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import AxisType
    import repro.models.hymba, repro.models.moe, repro.models.whisper, repro.models.xlstm
    from repro.configs import get_smoke_config
    from repro.launch import sharding as jshd
    from repro.train.train_step import TrainSettings, _make_loss_fn
    for name, mod in list(sys.modules.items()):  # fp32 compute in every model module
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if name.startswith("repro.models") and hasattr(mod, attr):
                setattr(mod, attr, jnp.float32)
    shape = tuple(int(n) for n in sys.argv[5].split("x"))  # (data, model)
    assert len(jax.devices()) == shape[0] * shape[1], jax.devices()
    z = np.load(sys.argv[1])
    cfg = dataclasses.replace(get_smoke_config(sys.argv[3]), **json.loads(sys.argv[4]))
    params = {}
    for k in z.files:
        if k.startswith("p/"):
            d = params
            *head, last = k[2:].split("/")
            for h in head:
                d = d.setdefault(h, {})
            d[last] = jnp.asarray(z[k])
    # Auto axes: with the default Explicit ones with_sharding_constraint refuses
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jshd.install_constraints(mesh, jshd.build_rules(cfg, mesh))
    loss_fn = _make_loss_fn(cfg, TrainSettings(microbatches=2), True)
    vg = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    n = z["tokens"].shape[0] // 2
    acc, losses = None, []
    for i in range(2):
        micro = {k: jnp.asarray(z[k][i * n:(i + 1) * n]) for k in ("tokens", "targets")}
        for extra in ("image_embeds", "frames"):
            if extra in z.files:
                micro[extra] = jnp.asarray(z[extra][i * n:(i + 1) * n], jnp.bfloat16)
        (_, (loss, _)), g = vg(params, jnp.asarray(z["wt"]), micro)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        losses.append(float(loss))
    pg, tg = jax.tree.map(lambda a: np.asarray(a) / 2, acc)
    out = {"loss": np.mean(losses), "t": tg}
    out.update({"g/" + "/".join(str(getattr(p, "key", p)) for p in path): leaf
                for path, leaf in jax.tree_util.tree_leaves_with_path(pg)})
    np.savez(sys.argv[2], **out)
"""

GRAD_SCRIPT = """
    import dataclasses, json, os, sys
    import numpy as np
    import torch
    import repro_torch.models.hymba, repro_torch.models.moe, repro_torch.models.whisper
    import repro_torch.models.xlstm
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.models.common import gather_from_model
    from repro_torch.train.train_step import TrainSettings, make_lm_grads
    for name, mod in list(sys.modules.items()):  # fp32 compute in every model module
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if name.startswith("repro_torch.models") and hasattr(mod, attr):
                setattr(mod, attr, torch.float32)
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = dataclasses.replace(get_smoke_config(os.environ["ARCH"]),
                              **json.loads(os.environ["VARIANT"]))
    z = np.load(os.environ["INPUTS"])
    tree = {}
    for k in z.files:
        if k.startswith("p/"):
            d = tree
            *head, last = k[2:].split("/")
            for h in head:
                d = d.setdefault(h, {})
            d[last] = z[k]
    mesh = make_host_mesh(model=int(os.environ["MODEL"]))
    rules = shd.build_rules(cfg, mesh)
    shd.install_constraints(mesh, rules, cfg)
    schema = get_model(cfg).schema(cfg)
    mr, nd, dr = mesh.get_local_rank("model"), mesh.size(0), mesh.get_local_rank("data")
    params = shd.shard_tree(lm_params_from_numpy(cfg, tree, device="cpu"), schema, rules, mesh, mr,
                            dr)
    B = z["tokens"].shape[0] // nd
    batch = {k: torch.from_numpy(z[k][dr * B:(dr + 1) * B]) for k in ("tokens", "targets")}
    for extra in ("image_embeds", "frames"):
        if extra in z.files:
            batch[extra] = torch.from_numpy(z[extra][dr * B:(dr + 1) * B]).to(torch.bfloat16)
    M, d = mesh.size(1), cfg.d_model
    cut = d % M == 0  # the working table's d-slice on model, else whole
    wt = torch.from_numpy(z["wt"][:, mr * d // M:(mr + 1) * d // M].copy() if cut else z["wt"])
    g, tg, metrics = make_lm_grads(cfg, TrainSettings(microbatches=2 // nd), hier=True)(
        params, batch, wt)
    g = shd.gather_tree(g, schema, rules, mesh)
    out = {"loss": float(metrics["loss"]), "t": (gather_from_model(tg, -1) if cut else tg).numpy()}
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["g/" + "/".join(path)] = node.numpy()
    walk(g, ())
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
"""


def _jax_grads(inputs, arch, tmp_path, variant: str, mesh: tuple) -> subprocess.Popen:
    path = tmp_path / "jax_tp.py"
    path.write_text(textwrap.dedent(JAX_SCRIPT))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={mesh[0] * mesh[1]}")
    return subprocess.Popen([sys.executable, str(path), str(inputs), str(tmp_path / "jax.npz"),
                             arch, variant, f"{mesh[0]}x{mesh[1]}"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def check_tp_grads(arch, tmp_path, variant: dict | None = None, loose: dict | None = None,
                   drawn_constants: bool = False, model: int = 2, data: tuple = (1, 2)):
    """The module docstring's gradient checks for ``arch``'s smoke config
    (with ``variant``'s fields replaced, on both sides); ``loose`` maps a
    leaf to the tolerance that replaces ``TP_TOL`` for it;
    ``drawn_constants``: the leaves ``init`` makes constant (biases of
    zeros, norms of ones) get seeded noise of 0.1 on top, so that a bias
    counted once per rank shows in the loss. The port's ranks run on a
    (D, ``model``) mesh for each D of ``data``, the reference on the
    largest."""
    variant = json.dumps(variant or {})
    jcfg = dataclasses.replace(jget_smoke_config(arch), **json.loads(variant))
    batch = np_batch(jcfg, n_working=N_WORKING)
    inputs = {"p/" + k: v for k, v in _flat(_np_params(jcfg, 0))}
    if drawn_constants:
        rng = np.random.default_rng(7)
        inputs = {k: v + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
                  if np.all(v == v.flat[0]) else v for k, v in inputs.items()}
    inputs.update(batch, wt=(np.random.default_rng(5).standard_normal(
        (N_WORKING, jcfg.d_model)) * 0.02).astype(np.float32))
    np.savez(tmp_path / "inputs.npz", **inputs)
    jax_proc = _jax_grads(tmp_path / "inputs.npz", arch, tmp_path, variant, (max(data), model))
    meshes = [f"{D}x{model}" for D in data]
    runs = {}
    for mesh, world, M in [("one", 1, 1)] + [(m, D * model, model) for m, D in zip(meshes, data)]:
        out = tmp_path / mesh
        out.mkdir()
        spawn_ranks(GRAD_SCRIPT, world, out, env_extra={
            "ARCH": arch, "MODEL": str(M), "INPUTS": str(tmp_path / "inputs.npz"),
            "OUT": str(out), "VARIANT": variant})
        runs[mesh] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    _, err = jax_proc.communicate(timeout=240)
    assert jax_proc.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp_path / "jax.npz"))
    one = runs["one"][0]
    names = sorted(k for k in ref if k.startswith("g/"))
    assert names == sorted(k for k in one if k.startswith("g/")) and len(names) > 5
    assert abs(one["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    for mesh in meshes:
        for rank in runs[mesh]:  # every rank gathers the same whole gradients
            assert abs(rank["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]), mesh
            for name in names + ["t"]:
                assert np.array_equal(rank[name], runs[mesh][0][name]), (mesh, name)
        got = runs[mesh][0]
        for name in names + ["t"]:
            _close(got[name], ref[name], FP32_TOL, f"{mesh} {name} vs the reference")
            _close(got[name], one[name], (loose or {}).get(name, TP_TOL),
                   f"{mesh} {name} vs the world of one")


@pytest.mark.parametrize("arch", ["yi-9b", "granite-20b"])
def test_tp_gradients_match_the_reference_and_the_world_of_one(arch, tmp_path):
    check_tp_grads(arch, tmp_path)
