"""Dry run: one rank's step of every (arch x shape x mesh) cell on the
``meta`` device -> per-rank memory and the H100 roofline terms.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell with XLA against abstract inputs. PyTorch
has no HLO; here each cell's real step — ``make_lm_train_step(_hier)``
with AdamW, remat and microbatches for ``train_*`` shapes,
``make_prefill_step`` and ``make_decode_step`` with its cache for the
others — runs once, for one rank of a :class:`~repro_torch.launch.mesh.DryMesh`,
on meta tensors (this rank's shards over ``data`` and ``model`` of the
parameters and optimizer state, ``launch/inputs.py``'s batch) under
``op_analysis.OpCounter``. The port's
kernels report their own cost from their meta stand-ins, and its
collectives are recorded where the port makes them
(``repro_torch.collectives``). No card is needed.

A cell is ``skipped`` where the config does not support the shape, and
``refused`` (with ``check_model_parallel``'s reason, never traced
replicated) where the port does not place the config at the mesh's
``model`` axis. Results stream into a JSON file, keyed
``arch|shape|mesh`` (a completed cell is kept on rerun unless
``--force``).

The default mesh is 32 x 8 (256 ranks; ``--multi-pod``: 64 x 8, 512),
the reference's (16, 16) and (2, 16, 16) with ``model`` inside one
8-card NVLink node.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import threading
import time
import traceback

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, ArchConfig, ShapeSpec, get_config
from repro_torch.launch import inputs as inp
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import DryMesh
from repro_torch.launch.op_analysis import OpCounter
from repro_torch.models import get_model
from repro_torch.models.common import abstract_params, stored_as
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optim import AdamW
from repro_torch.train.train_step import TrainSettings, make_lm_train_step, make_lm_train_step_hier

DEFAULT_OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                           "dryrun_results.json")
MESHES = {False: (32, 8), True: (64, 8)}


def microbatches_for(cfg: ArchConfig, shape: ShapeSpec, mesh) -> int:
    """Pick grad-accum factor so per-microbatch activations fit HBM."""
    dp = math.prod(dict(zip(mesh.mesh_dim_names, mesh.shape))[a] for a in shd.data_axes(mesh))
    per_shard = shape.global_batch // max(1, dp)
    if per_shard <= 1:
        return 1
    if cfg.d_model >= 8192:
        return per_shard  # largest models: microbatch of 1 sequence/shard
    if cfg.d_model >= 4096:
        return max(1, per_shard // 2)
    return max(1, per_shard // 4) if per_shard >= 4 else 1


def rank_params(cfg: ArchConfig, mesh, rules: dict, dtype: torch.dtype = torch.float32):
    """This rank's shards of the parameters, on meta: the schema's leaves
    (those the model stores in ``dtype``, as its ``init`` does) cut over
    ``model`` and ``data`` by ``shard_tree``."""
    model = get_model(cfg)
    schema = model.schema(cfg)
    params = abstract_params(stored_as(schema, dtype, model.stored))
    return shd.shard_tree(params, schema, rules, mesh, mesh.get_local_rank("model"),
                          mesh.get_local_rank("data"))


def decode_pos(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """The position of the decoded token: the last of a context of
    ``seq_len`` (after hymba's meta tokens and a VLM's image)."""
    extra = cfg.n_meta_tokens if cfg.family == "hybrid" else (
        cfg.n_image_tokens if cfg.family == "vlm" else 0)
    return extra + shape.seq_len - 1


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, settings_overrides=None, *,
               working: int | None = None):
    """-> (fn, args): the cell's step and this rank's meta inputs. Installs
    the launcher's hooks for ``mesh`` (``clear_constraints`` removes them);
    raises ``NotImplementedError`` where the port does not place ``cfg``.
    ``working``: the working table's rows (default the MEM-PS capacity,
    ``inputs.working_rows``)."""
    rules = shd.build_rules(cfg, mesh)
    shd.install_constraints(mesh, rules, cfg)

    if shape.kind == "train":
        settings = TrainSettings(
            optimizer=AdamW(),
            microbatches=microbatches_for(cfg, shape, mesh),
            attn_impl="blockwise" if shape.seq_len > 8192 else "auto",
            remat=True,
        )
        if settings_overrides:
            settings = dataclasses.replace(settings, **settings_overrides)
        params = rank_params(cfg, mesh, rules)
        opt_state = settings.optimizer.init(params)
        batch = inp.train_batch(cfg, shape, mesh)
        if cfg.embedding_mode == "hier_ps":
            wt, acc = inp.hier_tables(cfg, shape.global_batch * shape.seq_len, mesh, rules,
                                      rows=working)
            return make_lm_train_step_hier(cfg, settings), (params, opt_state, batch, wt, acc)
        return make_lm_train_step(cfg, settings), (params, opt_state, batch)

    params = rank_params(cfg, mesh, rules, torch.bfloat16)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, inp.prefill_batch(cfg, shape, mesh, rules))

    batch = inp.decode_batch(cfg, shape, mesh, rules)
    cache = inp.decode_cache(cfg, shape, mesh, mesh.get_local_rank("model"))
    return make_decode_step(cfg, attn_impl="naive"), (params, batch, cache, decode_pos(cfg, shape))


def _storage_bytes(tree, exclude=frozenset()) -> int:
    seen, total = set(exclude), 0
    for t in torch.utils._pytree.tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                total += st.nbytes()
    return total


# the stack of the thread a cell is traced on: autograd's backward over a
# long recurrence (xlstm's sLSTM loop at train_4k, 4,096 steps a block)
# recurses past a main thread's usual 8 MiB
TRACE_STACK_BYTES = 1 << 30


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, settings_overrides=None, *,
               working: int | None = None):
    """Run the cell's step once on meta under an ``OpCounter`` -> (counter,
    memory_per_rank): ``argument_bytes`` (the step's inputs),
    ``output_bytes`` (what it returns that is not an input's storage),
    ``peak_bytes`` (the most the step holds at once, its inputs included)
    and ``temp_bytes`` (the peak beyond the inputs). The step runs on a
    thread of its own with a stack of ``TRACE_STACK_BYTES``."""
    result = []

    def run():
        try:
            result.append(_trace(cfg, shape, mesh, settings_overrides, working))
        except BaseException as e:  # raised again on the caller's thread
            result.append(e)

    old = threading.stack_size(TRACE_STACK_BYTES)
    try:
        t = threading.Thread(target=run, name="dryrun-trace")
        t.start()
        t.join()
    finally:
        threading.stack_size(old)
    if isinstance(result[0], BaseException):
        raise result[0]
    return result[0]


def _trace(cfg: ArchConfig, shape: ShapeSpec, mesh, settings_overrides, working):
    try:
        fn, args = build_cell(cfg, shape, mesh, settings_overrides, working=working)
        counter = OpCounter()
        arg_bytes = counter.track(args)
        with counter:
            out = fn(*args)
        arg_storages = {t.untyped_storage()._cdata
                        for t in torch.utils._pytree.tree_flatten(args)[0]
                        if isinstance(t, torch.Tensor)}
        out_bytes = _storage_bytes(out, arg_storages)
    finally:
        shd.clear_constraints()
    mem = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
           "temp_bytes": counter.peak_bytes - arg_bytes, "peak_bytes": counter.peak_bytes}
    return counter, mem


def run_cell(arch: str, shape_name: str, mesh_shape: tuple[int, int] = MESHES[False], *,
             rank: int = 0, cfg: ArchConfig | None = None, shape: ShapeSpec | None = None,
             settings_overrides=None, working: int | None = None, verbose: bool = True) -> dict:
    """One cell's record: the ``Roofline`` dict with ``memory_per_rank``,
    ``trace_seconds`` and the kernels' calls; or ``skipped``; or
    ``refused``. ``cfg``/``shape`` replace the registry's (a cut config, a
    custom shape)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if not cfg.supports(shape):
        return {"arch": arch, "shape": shape_name, "skipped": "unsupported (see DESIGN.md)"}
    mesh = DryMesh(*mesh_shape, rank)
    try:
        shd.check_model_parallel(cfg, mesh)
    except NotImplementedError as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh.name, "refused": str(e)}
    counter, mem = trace_cell(cfg, shape, mesh, settings_overrides, working=working)
    mf = rl.model_flops(cfg, shape, cfg.param_count(active_only=True))
    roof = rl.analyze(arch, shape_name, mesh.name, counter, mf, mesh.data * mesh.model, mem)
    if verbose:
        print(
            f"[{arch} x {shape_name} @ {mesh.name}] trace {roof.trace_seconds:.1f}s | "
            f"args {mem['argument_bytes'] / 2**30:.2f} GiB peak {mem['peak_bytes'] / 2**30:.2f} "
            f"GiB | flops/rank {roof.flops_per_rank:.3e} bytes/rank {roof.bytes_per_rank:.3e} "
            f"coll/rank {roof.collective_bytes_per_rank:.3e} | t_comp {roof.t_compute * 1e3:.1f}ms "
            f"t_mem {roof.t_memory * 1e3:.1f}ms t_coll {roof.t_collective * 1e3:.1f}ms -> "
            f"{roof.bottleneck} | useful {roof.useful_flops_ratio:.2f} roofline "
            f"{roof.roofline_fraction:.2%}", flush=True)
    return roof.to_dict()


def parse_mesh(text: str) -> tuple[int, int]:
    data, model = (int(x) for x in text.lower().split("x"))
    return data, model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    help="DATAxMODEL, default 32x8 (--multi-pod: 64x8)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(DEFAULT_OUT))
    args = ap.parse_args(argv)
    mesh_shape = args.mesh or MESHES[args.multi_pod]
    mesh_name = f"{mesh_shape[0]}x{mesh_shape[1]}"

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for arch, shape_name in cells:
        key = f"{arch}|{shape_name}|{mesh_name}"
        if key in results and not args.force and "error" not in results[key]:
            print(f"skip {key} (cached)")
            continue
        try:
            results[key] = run_cell(arch, shape_name, mesh_shape)
        except Exception as e:  # record failures — they are bugs to fix
            traceback.print_exc()
            results[key] = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                            "error": repr(e)}
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    n_err = sum(1 for v in results.values() if "error" in v)
    print(f"\n{len(results)} cells recorded, {n_err} errors -> {args.out}")


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(f"{time.perf_counter() - t0:.0f}s")
