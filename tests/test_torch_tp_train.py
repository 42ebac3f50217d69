"""Tensor parallelism over ``model`` through the launcher, and the MoE and
VLM gradients, on the CPU (``tests/test_torch_tp.py`` has the placement and
the dense archs' gradients).

* Gradients of olmoe-1b-7b (experts over ``model``: rank r holds experts
  ``[r*E/M, (r+1)*E/M)``) and pixtral-12b (the image prefix after the
  embedding's gather), as ``test_torch_tp.check_tp_grads`` states them:
  gloo ranks on meshes (1, 2) and (2, 2) against the reference under
  ``install_constraints`` on an Auto-axes (2, 2) mesh (``FP32_TOL``) and the
  port's world of one (1e-5).
* ``launch.train.run(..., model_parallel=2)`` trains each of the seven
  transformer-family archs for two steps on two gloo ranks (and olmoe on a
  (2, 2) mesh, data and model): each rank holds only its shards of the
  leaves the rules put on ``model`` (and, at (2, 2), on ``data``: FSDP),
  the leaves whole over ``model`` (norms, the router, replicated kv) are
  bitwise equal across the ranks that hold the same shard of them after
  the two steps, and so are the losses. The step-2 checkpoint holds whole tensors:
  resumed at ``model_parallel=1`` it restores params and AdamW state
  bitwise equal to the run's gathered ones, and resumed at
  ``model_parallel=2`` each rank's shards bitwise equal to the run's.
"""

import dataclasses
import json
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.common import abstract_params  # noqa: E402
from repro_torch.train.optim import AdamW  # noqa: E402
from repro_torch.train.train_step import TrainSettings, replicated_leaves  # noqa: E402

from test_torch_sharded_hbm import spawn_ranks  # noqa: E402
from test_torch_tp import TRANSFORMERS, _flat, _meshes, check_tp_grads  # noqa: E402


@pytest.fixture(autouse=True)
def _no_group_or_hooks_left():
    """The launcher's process group and hooks are process-global."""
    yield
    shd.clear_constraints()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "pixtral-12b"])
def test_tp_gradients_match_the_reference_and_the_world_of_one(arch, tmp_path):
    check_tp_grads(arch, tmp_path)


SETTINGS = dict(lr=1e-2, microbatches=2)

LAUNCH_SCRIPT = """
    import dataclasses, json, os
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.train.optim import AdamW
    from repro_torch.train.train_step import TrainSettings
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    cfg = dataclasses.replace(get_smoke_config(os.environ["ARCH"]),
                              **json.loads(os.environ["VARIANT"]))
    settings = TrainSettings(optimizer=AdamW(lr=float(os.environ["LR"])),
                             microbatches=int(os.environ["MICRO"]))
    res = launch.run(cfg, settings, steps=2, batch=4, seq=16,
                     model_parallel=int(os.environ["MODEL"]), base=os.environ["BASE"],
                     ckpt_every=2, device="cpu")
    out = {"losses": np.array(res.losses), "step": res.opt_state.step.numpy()}
    # the step-2 checkpoint resumed at the same model axis: this rank's shards
    again = launch.run(cfg, settings, steps=0, model_parallel=int(os.environ["MODEL"]),
                       resume=True, base=os.environ["BASE"], ckpt_every=0, device="cpu")
    trees = {"local": res.params, "whole": res.whole(res.params),
             "whole_m": res.whole(res.opt_state.m), "whole_v": res.whole(res.opt_state.v),
             "local_m": res.opt_state.m, "local_v": res.opt_state.v, "again": again.params,
             "again_m": again.opt_state.m, "again_v": again.opt_state.v}
    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = node.float().numpy()
    for name, tree in trees.items():
        walk(tree, (name,))
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
"""


FP32_PREFIX = """
    import sys
    import torch
    import repro_torch.models.hymba, repro_torch.models.moe, repro_torch.models.whisper
    import repro_torch.models.xlstm
    for name, mod in list(sys.modules.items()):  # fp32 compute in every model module
        for attr in ("COMPUTE_DTYPE", "DISPATCH_DTYPE"):
            if name.startswith("repro_torch.models") and hasattr(mod, attr):
                setattr(mod, attr, torch.float32)
"""


def check_tp_launcher(arch, data, tmp_path, variant: dict | None = None, fp32: bool = False):
    """The module docstring's launcher checks for ``arch``'s smoke config
    (with ``variant``'s fields replaced) on a (data, 2) mesh; ``fp32``: the
    models compute in fp32 (:data:`FP32_PREFIX`)."""
    M, world = 2, 2 * data
    base = tmp_path / "run"
    script = textwrap.dedent(FP32_PREFIX) + textwrap.dedent(LAUNCH_SCRIPT) if fp32 else LAUNCH_SCRIPT
    spawn_ranks(script, world, tmp_path, env_extra={
        "ARCH": arch, "MODEL": str(M), "BASE": str(base), "OUT": str(tmp_path),
        "LR": str(SETTINGS["lr"]), "MICRO": str(SETTINGS["microbatches"] // data),
        "VARIANT": json.dumps(variant or {})})
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
    cfg = dataclasses.replace(get_smoke_config(arch), **(variant or {}))
    schema = get_model(cfg).schema(cfg)
    _, mesh = _meshes(data, M)  # the rules' stand-in mesh
    rules = shd.build_rules(cfg, mesh)
    dims = shd.data_dims(schema, rules, mesh)
    local = shd.shard_tree(abstract_params(schema), schema, rules, mesh, 0, 0)
    mask = dict(_flat(replicated_leaves(cfg, local, "model", dims)))
    on_data = dict(_flat(replicated_leaves(cfg, local, "data", dims)))
    assert any(mask.values()) and not all(mask.values())
    assert all(on_data.values()) == (data == 1)
    r0 = ranks[0]
    assert r0["losses"].shape == (2,) and np.isfinite(r0["losses"]).all()
    for r, got in enumerate(ranks):
        assert np.array_equal(got["losses"], r0["losses"]), r
        for name, replicated in mask.items():
            local, whole = got["local/" + name], got["whole/" + name]
            if replicated and on_data[name]:  # bitwise equal on every rank after two steps
                assert np.array_equal(local, r0["local/" + name]), (r, name)
            elif replicated:  # equal across the model ranks holding the same data shard
                assert np.array_equal(local, ranks[r - r % M]["local/" + name]), (r, name)
            # only this rank's shard (FSDP over data on top of the model cut)
            cut = (1 if replicated else M) * (1 if on_data[name] else data)
            assert local.size * cut == whole.size, (r, name, local.shape, whole.shape)
            for tree in ("whole/", "whole_m/", "whole_v/"):
                assert np.array_equal(got[tree + name], r0[tree + name]), (r, tree, name)
            for tree in ("/", "_m/", "_v/"):  # resumed at model_parallel=2: the same shards
                assert np.array_equal(got["again" + tree + name], got["local" + tree + name]), (
                    r, tree, name)

    # the step-2 checkpoint resumes at model_parallel=1, bitwise
    settings = TrainSettings(optimizer=AdamW(lr=SETTINGS["lr"]),
                             microbatches=SETTINGS["microbatches"])
    res = launch.run(cfg, settings, steps=0, resume=True, base=str(base), device="cpu")
    assert res.start == 2 and int(res.opt_state.step) == int(r0["step"]) == 2
    for tree, got in (("whole/", res.params), ("whole_m/", res.opt_state.m),
                      ("whole_v/", res.opt_state.v)):
        for name, t in _flat(got):
            assert np.array_equal(t.float().numpy(), r0[tree + name]), (tree, name)


@pytest.mark.parametrize("arch,data", [(a, 1) for a in TRANSFORMERS] + [("olmoe-1b-7b", 2)])
def test_tp_launcher_keeps_replicated_leaves_equal_and_resumes_at_tp1(arch, data, tmp_path):
    check_tp_launcher(arch, data, tmp_path)
