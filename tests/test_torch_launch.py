"""The port's launcher (``repro_torch.launch``) against the JAX reference and
itself, on the CPU.

* Sharding rules: ``build_rules`` and ``pspec`` equal the reference's, entry
  for entry, for all ten archs (smoke and full) on meshes ``(16, 16)``,
  ``(2, 16, 16)``, ``(8, 1)`` and ``(2, 4)`` (namespaces with a mesh's
  shape and axis names: no devices).
* Hooks: ``logical_specs`` and ``abstract_params`` match the reference's
  shapes and logical names; with no hook installed the train step is
  bitwise what it was, and an installed ``constrain_like_params`` sees the
  summed gradient tree once per step.
* ``launch.train.run`` (2 steps, smoke yi-9b and olmoe-1b-7b, from converted
  reference weights) against a loop of the reference's jitted
  ``make_lm_train_step_hier`` over the reference's ``Cluster`` and
  ``PSClient`` on the same token stream, both computing in fp32 (AdamW with
  ``eps`` 1: see below): losses within 1e-5, each parameter leaf's update
  within ``FP32_TOL`` of the reference's largest, the committed PS rows'
  change within ``FP32_TOL`` of its largest, as
  ``tests/test_torch_lm_train.py`` states them.
* Data parallelism: two gloo ranks with ``m`` microbatches each against one
  process with ``2m`` on the same global batch (so every microbatch is the
  same slice of tokens, and MoE routes alike): losses, each parameter
  leaf's update and the committed PS rows within 1e-5 of the largest
  magnitude; the two ranks' parameters (each holds its FSDP shards over
  ``data``, gathered whole) equal bitwise. AdamW runs without its clip
  here: the two ranks sum the clip norm's squares shard by shard, the one
  process leaf by leaf, so the two norms differ in their last bit and a
  clipped step moves a few weights by one fp32 ulp, which is above this
  tolerance on updates; ``tests/test_torch_fsdp.py`` holds the clip norm
  and a clipped step under FSDP against the world of one.
* Resume: the restored state equals the saved one bitwise, and two resumed
  runs equal each other bitwise.
* Loud failures: a model axis the world cannot hold, tensor parallelism of
  the families still to place, CUDA without a card.

AdamW's first step from a zero state is ``lr * sign(g)`` where ``|g| >>
eps``: a gradient that rounds near zero would decide a full-size update by
its sign. ``eps`` 1 keeps the update linear in small gradients, so the
comparisons measure the steps and not that sign. Row-Adagrad starts from
the PS's zero accumulators all the same; its first step is ``row_lr *
sign(g)`` and agrees where the two sides' gradients share their signs,
which fp32 compute keeps.
"""

import shutil
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke_config  # noqa: E402
from repro.core.client import PSClient as JPSClient  # noqa: E402
from repro.core.node import Cluster as JCluster  # noqa: E402
from repro.core.tables import RowSchema as JRowSchema  # noqa: E402
from repro.core.tables import TableSpec as JTableSpec  # noqa: E402
from repro.data.tokens import TokenStream as JTokenStream  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro.train.optim import AdamW as JAdamW  # noqa: E402
from repro.train.train_step import TrainSettings as JTrainSettings  # noqa: E402
from repro.train.train_step import make_lm_train_step_hier as jmake_step  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import init_distributed  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train.checkpoint import restore as ckpt_restore  # noqa: E402
from repro_torch.train.optim import AdamW, tree_leaves, tree_map  # noqa: E402
from repro_torch.train.train_step import TrainSettings, make_lm_grads  # noqa: E402

from test_torch_lm import _pair  # noqa: E402
from test_torch_lm_train import FP32_TOL, fp32_compute, np_batch, torch_batch  # noqa: E402
from test_torch_sharded_hbm import spawn_ranks  # noqa: E402

DP_TOL = 1e-5  # data parallel vs one process: max |diff| <= DP_TOL * max |ref|
MESHES = {"(16, 16)": ((16, 16), ("data", "model")),
          "(2, 16, 16)": ((2, 16, 16), ("pod", "data", "model")),
          "(8, 1)": ((8, 1), ("data", "model")),
          "(2, 4)": ((2, 4), ("data", "model"))}


@pytest.fixture(autouse=True)
def _no_group_or_hooks_left():
    """The launcher's process group and hooks are process-global."""
    yield
    shd.clear_constraints()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _meshes(shape, names):
    """(the reference's mesh stand-in, the port's)."""
    return (types.SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names),
            types.SimpleNamespace(shape=shape, mesh_dim_names=names))


def _specs(schema, spec_type):
    """[(path, shape, logical)] of a schema's leaves."""
    out = []

    def go(node, path):
        if isinstance(node, spec_type):
            out.append((path, tuple(node.shape), tuple(node.logical)))
        else:
            for k in sorted(node):
                go(node[k], path + (k,))

    go(schema, ())
    return out


# --------------------------------------------------------------------------
# sharding rules and hooks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scale", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_rules_and_pspec_match_reference(arch, scale):
    jcfg = (jget_smoke_config if scale == "smoke" else jget_config)(arch)
    tcfg = (get_smoke_config if scale == "smoke" else get_config)(arch)
    jspecs = _specs(jget_model(jcfg).schema(jcfg), jcommon.ParamSpec)
    tspecs = _specs(get_model(tcfg).schema(tcfg), common.ParamSpec)
    assert tspecs == jspecs
    for shape, names in MESHES.values():
        jmesh, tmesh = _meshes(shape, names)
        jrules, trules = jshd.build_rules(jcfg, jmesh), shd.build_rules(tcfg, tmesh)
        assert trules == jrules
        assert shd.data_axes(tmesh) == jshd.data_axes(jmesh)
        for path, shp, logical in tspecs:
            want = tuple(jshd.pspec(shp, logical, jrules, jmesh))
            assert shd.pspec(shp, logical, trules, tmesh) == want, (path, names)
        # an activation and a working-table spec
        for shp, logical in (((64, 4096, tcfg.d_model), ("batch", "seq_act", "embed_act")),
                             ((1000, tcfg.d_model), ("working_rows", "working_dim"))):
            assert shd.pspec(shp, logical, trules, tmesh) == tuple(
                jshd.pspec(shp, logical, jrules, jmesh))


def test_schema_shardings_and_replicated():
    cfg, jcfg = get_smoke_config("olmoe-1b-7b"), jget_smoke_config("olmoe-1b-7b")
    jmesh, tmesh = _meshes(*MESHES["(2, 4)"])
    tree = shd.schema_shardings(get_model(cfg).schema(cfg), shd.build_rules(cfg, tmesh), tmesh)
    jrules = jshd.build_rules(jcfg, jmesh)
    want = {"/".join(path): tuple(jshd.pspec(shp, logical, jrules, jmesh))
            for path, shp, logical in _specs(jget_model(jcfg).schema(jcfg), jcommon.ParamSpec)}
    assert dict(_flat(tree)) == want
    assert any(v for v in want.values())  # the (2, 4) mesh shards something
    one = jax.make_mesh((1, 1), ("data", "model"))
    assert shd.replicated(tmesh) == tuple(jshd.replicated(one).spec) == ()


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_specs_and_abstract_params_match_reference(arch):
    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    jschema, tschema = jget_model(jcfg).schema(jcfg), get_model(tcfg).schema(tcfg)
    jlog = dict(_flat(jcommon.logical_specs(jschema)))
    assert dict(_flat(common.logical_specs(tschema))) == jlog
    jabs = jax.tree.map(lambda s: (tuple(s.shape), np.dtype(s.dtype).name),
                        jcommon.abstract_params(jschema),
                        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    tabs = common.abstract_params(tschema)
    assert all(t.device.type == "meta" for t in tree_leaves(tabs))
    got = {k: (tuple(t.shape), str(t.dtype).removeprefix("torch.")) for k, t in _flat(tabs)}
    assert got == dict(_flat(jabs)) and set(got) == set(jlog)


def test_hooks_default_to_the_identity_and_the_kernel_call():
    x = torch.arange(6.0).reshape(2, 3)
    assert common.with_logical_constraint(x, "batch", None) is x
    tree = {"a": x}
    assert common.constrain_like_params(tree) is tree
    table, ids = torch.randn(10, 4), torch.tensor([[1, 3], [9, 0]])
    assert torch.equal(common.embed_gather(table, ids), table[ids])
    seen = []
    common.set_logical_constraint_fn(lambda t, logical: seen.append(logical) or t * 2)
    common.set_embed_gather_fn(lambda t, i: seen.append("gather") or t[i] + 1)
    assert torch.equal(common.with_logical_constraint(x, "batch", None), x * 2)
    assert torch.equal(common.embed_gather(table, ids), table[ids] + 1)
    assert seen == [("batch", None), "gather"]
    shd.clear_constraints()
    assert common.with_logical_constraint(x, "batch") is x
    assert torch.equal(common.embed_gather(table, ids), table[ids])


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_grads_call_the_param_hook_once_and_are_unchanged_without_it(arch):
    _, tcfg, _, tp = _pair(arch, embedding_mode="hier_ps")
    batch = torch_batch(np_batch(tcfg, n_working=64))
    wt = torch.from_numpy((np.random.default_rng(5).standard_normal((64, tcfg.d_model)) * 0.02)
                          .astype(np.float32))
    grads = make_lm_grads(tcfg, TrainSettings(microbatches=2), hier=True)
    base = grads(tp, batch, wt)
    again = grads(tp, batch, wt)
    for a, b in zip(tree_leaves(base[0]) + [base[1]], tree_leaves(again[0]) + [again[1]]):
        assert torch.equal(a, b)
    calls = []
    common.set_param_constraint_fn(lambda tree: calls.append(sorted(tree)) or tree)
    hooked = grads(tp, batch, wt)
    assert calls == [["metrics", "params", "working_table"]]
    for a, b in zip(tree_leaves(base[0]) + [base[1], base[2]["loss"]],
                    tree_leaves(hooked[0]) + [hooked[1], hooked[2]["loss"]]):
        assert torch.equal(a, b)


def test_the_installed_hook_averages_over_the_data_group():
    init_distributed("cpu")
    mesh = launch.make_host_mesh()
    cfg = get_smoke_config("yi-9b")
    shd.install_constraints(mesh, shd.build_rules(cfg, mesh), cfg)
    tree = {"params": {"w": torch.full((3,), 6.0)}, "metrics": {"loss": torch.tensor(2.0)},
            "working_table": None}
    out = common.constrain_like_params(tree)
    assert torch.equal(out["params"]["w"], torch.full((3,), 6.0))  # world of one: the mean
    table, ids = torch.randn(10, 4), torch.tensor([1, 3, 3])
    assert torch.equal(common.embed_gather(table, ids), table[ids])


# --------------------------------------------------------------------------
# the launcher against the reference's loop
# --------------------------------------------------------------------------

LB, LS = 4, 32  # the launcher comparisons' global batch and sequence


def _rows(client, vocab):
    """[emb | adagrad] rows of every vocab id, read without pinning."""
    with client.session("tok_emb", np.arange(vocab, dtype=np.uint64), read_only=True) as s:
        slots = np.asarray(s.slots)
        return np.concatenate([np.asarray(s.params)[slots], np.asarray(s.opt_state)[slots]], 1)


def _jax_loop(jcfg, jp, settings, tmp_path, steps):
    """The reference launcher's loop (``src/repro/launch/train.py``)."""
    d = jcfg.d_model
    cluster = JCluster(2, str(tmp_path / "jps"), dim=d * 2, cache_capacity=max(4096, 4 * LB * LS),
                       file_capacity=1024, init_scale=0.02)
    client = JPSClient(cluster, [JTableSpec("tok_emb", JRowSchema.with_adagrad(d))])
    step = jax.jit(jmake_step(jcfg, settings))
    params, opt_state = jp, settings.optimizer.init(jp)
    stream = JTokenStream(jcfg.vocab_size, LB, LS, seed=0)
    losses = []
    for _ in range(steps):
        toks = stream.next_batch()
        with client.session("tok_emb", toks[:, :-1].astype(np.uint64)) as s:
            batch = {"tokens": jnp.asarray(s.slots), "targets": jnp.asarray(toks[:, 1:])}
            params, opt_state, m, new_t, new_acc = step(
                params, opt_state, batch, jnp.asarray(s.params), jnp.asarray(s.opt_state))
            s.commit(np.asarray(new_t), np.asarray(new_acc))
        losses.append(float(m["loss"]))
    return losses, params, _rows(client, jcfg.vocab_size)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), what
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} * max |ref| {scale}"


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_launcher_matches_the_reference_loop(arch, tmp_path):
    jcfg, tcfg, jp, tp = _pair(arch, embedding_mode="hier_ps")
    js = JTrainSettings(optimizer=JAdamW(lr=1e-2, eps=1.0), microbatches=2)
    ts = TrainSettings(optimizer=AdamW(lr=1e-2, eps=1.0), microbatches=2)
    with fp32_compute():
        jlosses, jparams, jrows = _jax_loop(jcfg, jp, js, tmp_path, 2)
        res = launch.run(tcfg, ts, steps=2, batch=LB, seq=LS, base=str(tmp_path / "port"),
                         ckpt_every=0, device="cpu", params=tp)
    assert res.start == 0 and len(res.losses) == 2
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-5)
    jflat = dict(_flat(jax.tree.map(np.asarray, jparams)))
    p0 = dict(_flat(tree_map(lambda t: t.numpy(), tp)))
    for name, t in _flat(res.params):
        _close(t.numpy() - p0[name], jflat[name] - p0[name], FP32_TOL, name)
    rows = _rows(res.client, tcfg.vocab_size)
    d = tcfg.d_model
    fresh = launch.Cluster(2, str(tmp_path / "fresh"), dim=2 * d, cache_capacity=4096,
                           file_capacity=1024, init_scale=0.02)
    init = _rows(launch.PSClient(fresh, [launch.TableSpec(
        "tok_emb", launch.RowSchema.with_adagrad(d))]), tcfg.vocab_size)
    assert not init[:, d:].any()  # the accumulators start at zero
    _close(rows[:, :d] - init[:, :d], jrows[:, :d] - init[:, :d], FP32_TOL, "PS rows")
    _close(rows[:, d:], jrows[:, d:], 2 * FP32_TOL, "PS row accumulators")
    assert res.stats["hits"] + res.stats["misses"] > 0


# --------------------------------------------------------------------------
# data parallelism: two gloo ranks vs one process
# --------------------------------------------------------------------------

DP_SCRIPT = """
    import os
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.train.optim import AdamW
    from repro_torch.train.train_step import TrainSettings
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = get_smoke_config(os.environ["ARCH"])
    settings = TrainSettings(optimizer=AdamW(lr=1e-2, eps=1.0, clip_norm=0.0),
                             microbatches=int(os.environ["MICRO"]))
    res = launch.run(cfg, settings, steps=2, batch=8, seq=16, base=os.environ["BASE"],
                     ckpt_every=0, device="cpu")
    out = {"losses": np.array(res.losses)}
    out.update({"p/" + k: v for k, v in
                launch.ckpt._flatten(launch.ckpt.tree_map(lambda t: t.numpy(),
                                                          res.whole(res.params))).items()})
    if info.rank == 0:
        with res.client.session("tok_emb", np.arange(cfg.vocab_size, dtype=np.uint64),
                                read_only=True) as s:
            sl = np.asarray(s.slots)
            out["rows"] = np.concatenate([np.asarray(s.params)[sl], np.asarray(s.opt_state)[sl]], 1)
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    import torch.distributed as dist
    dist.destroy_process_group()
"""


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_two_data_ranks_match_one_process(arch, tmp_path):
    """Each side in its own processes, one CPU thread each: a multithreaded
    CPU GEMM blocks its sums by the thread count, and smoke olmoe's router
    then decides a near-tie the other way (one row's accumulator off by
    3.5e-4 with the one-process run on 8 threads)."""
    m = 2
    runs = []
    for name, world, micro in (("dp", 2, m), ("one", 1, 2 * m)):
        out = tmp_path / name
        out.mkdir()
        spawn_ranks(DP_SCRIPT, world, out, env_extra={
            "ARCH": arch, "MICRO": str(micro), "BASE": str(out / "run"), "OUT": str(out)})
        runs.append([dict(np.load(out / f"rank{r}.npz")) for r in range(world)])
    (r0, r1), (one,) = runs
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=DP_TOL)
    assert np.array_equal(r0["losses"], r1["losses"])
    names = [k for k in one if k.startswith("p/")]
    assert len(names) > 5 and sorted(names) == sorted(k for k in r0 if k.startswith("p/"))
    cfg = get_smoke_config(arch)
    p0 = dict(_flat(get_model(cfg).init(cfg, torch.Generator().manual_seed(0))))
    for name in names:
        assert np.array_equal(r0[name], r1[name]), name
        start = p0[name[2:]].numpy()
        _close(r0[name] - start, one[name] - start, DP_TOL, name)  # each leaf's update
    _close(r0["rows"], one["rows"], DP_TOL, "PS rows")


# --------------------------------------------------------------------------
# resume, the CLI, loud failures
# --------------------------------------------------------------------------


def _state(res, vocab):
    leaves = [t.clone() for t in tree_leaves(res.params)]
    opt = [res.opt_state.step.clone()] + [t.clone() for t in tree_leaves(res.opt_state.m)] + [
        t.clone() for t in tree_leaves(res.opt_state.v)]
    return leaves, opt, _rows(res.client, vocab)


def _assert_same(a, b):
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert np.array_equal(a[2], b[2])


def test_resume_restores_bitwise_and_resumed_runs_agree(tmp_path):
    cfg = get_smoke_config("yi-9b")
    settings = TrainSettings(optimizer=AdamW(lr=1e-2), microbatches=2)
    kw = dict(batch=4, seq=16, device="cpu")
    saved = launch.run(cfg, settings, steps=4, ckpt_every=2, base=str(tmp_path / "a"), **kw)
    saved_state = _state(saved, cfg.vocab_size)
    tree, step, _, manifest = ckpt_restore(str(tmp_path / "a" / "ckpt"),
                                           {"params": saved.params, "opt": saved.opt_state})
    assert step == 4 and manifest is not None
    for t, a in zip(saved_state[0], tree_leaves(tree["params"])):
        assert np.array_equal(t.numpy(), a)
    for copy in ("b1", "b2"):
        shutil.copytree(tmp_path / "a", tmp_path / copy)
    restored = launch.run(cfg, settings, steps=0, resume=True, base=str(tmp_path / "a"), **kw)
    assert restored.start == 4 and restored.losses == []
    _assert_same(_state(restored, cfg.vocab_size), saved_state)
    runs = [launch.run(cfg, settings, steps=2, resume=True, ckpt_every=0,
                       base=str(tmp_path / copy), **kw) for copy in ("b1", "b2")]
    assert runs[0].start == runs[1].start == 4 and runs[0].losses == runs[1].losses
    _assert_same(_state(runs[0], cfg.vocab_size), _state(runs[1], cfg.vocab_size))
    # the resumed stream restarts at seed=start, as the reference's does
    fresh = launch.TokenStream(cfg.vocab_size, 4, 16, seed=4).next_batch()
    assert not np.array_equal(fresh, launch.TokenStream(cfg.vocab_size, 4, 16,
                                                        seed=0).next_batch())


def test_cli_trains_checkpoints_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "olmoe-1b-7b", "--scale", "smoke", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    launch.main(argv + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "2 steps in" in out and "embedding cache hit rate" in out
    assert not torch.distributed.is_initialized()
    launch.main(argv + ["--steps", "1", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "1 steps in" in out


@pytest.mark.parametrize("arch,scale,M", [("hymba-1.5b", "full", 2), ("xlstm-1.3b", "smoke", 3),
                                          ("whisper-tiny", "full", 4)],
                         ids=["hymba-1.5b", "xlstm-1.3b", "whisper-tiny"])
def test_model_parallel_raises(arch, scale, M):
    """A world of one cannot hold a model axis of 2. The specs refused
    before the port cut q heads inside a head and ran whole blocks whole
    are installed: published hymba-1.5b's 25 heads and whisper-tiny's 6
    over a model axis of 2 and 4, smoke xlstm's 2 mLSTM heads over 3 (every
    leaf whole), each rank's shards of the reference's shapes
    (``tests/test_torch_tp_families.py`` has the refusals left)."""
    from test_torch_tp import check_reference_shapes

    with pytest.raises(ValueError, match="model axis 2"):
        launch.run(get_smoke_config(arch), TrainSettings(), steps=1, model_parallel=2,
                   device="cpu")
    cfg = get_config(arch) if scale == "full" else get_smoke_config(arch)
    jcfg = jget_config(arch) if scale == "full" else jget_smoke_config(arch)
    _, tmesh = _meshes((1, M), ("data", "model"))
    tmesh.get_group = lambda axis: None
    try:
        shd.install_constraints(tmesh, shd.build_rules(cfg, tmesh), cfg)
        assert common._PARAM_CONSTRAINT_FN is not None
    finally:
        shd.clear_constraints()
    assert common.model_group() is None and common._PARAM_CONSTRAINT_FN is None
    check_reference_shapes(cfg, jcfg, M)


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        launch.run(get_smoke_config("yi-9b"), TrainSettings(), steps=1)
    assert not torch.distributed.is_initialized()


def test_batch_must_split_over_ranks_and_microbatches():
    with pytest.raises(ValueError, match="does not split"):
        launch.run(get_smoke_config("yi-9b"), TrainSettings(microbatches=3), steps=1, batch=8,
                   device="cpu")
