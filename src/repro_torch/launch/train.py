"""Training launcher: any arch of the zoo, the token table in the PS.

Trains ``--arch`` with the paper's embedding path: token rows pulled per
batch from a PS cluster (MEM-PS/SSD-PS), row-Adagrad state on the rows,
AdamW on the backbone, async checkpoints, deterministic resume — the
reference's ``launch/train.py`` on PyTorch, one process per device.

Data parallelism over ``torch.distributed``: rank 0 owns the PS (the
``Cluster``, the ``PSClient`` session over the global ``[batch, seq]``
tokens, the commit and the checkpoints) and broadcasts each batch's slots,
working-table rows and Adagrad accumulators, so every rank holds the
replicated table; each rank trains its ``batch / data`` rows, and the
gradients are averaged over the ``data`` group inside the step
(``launch/sharding.py``).

Tensor parallelism (``--model-parallel M``, every family: dense, MoE, VLM,
hybrid, SSM and audio) and FSDP: the world is a ``(world / M, M)`` mesh,
each rank holds its local shards over ``model`` and ``data`` of the
weights and of AdamW's state (the parameters are made whole, as in a
world of one, then cut by ``launch/sharding.py``'s placement: the
reference's ``embed`` rule over ``data`` wherever the data axis divides),
and its contiguous d-slice of each batch's working rows and accumulators;
the commit gathers the new rows over ``model`` to rank 0. Checkpoints hold
whole tensors, so a run resumes at any mesh.

Usage (one process; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --scale smoke \\
      --steps 50 --batch 8 --seq 128 [--ckpt-dir DIR] [--resume]
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train ...
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
      --model-parallel 2 ...
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, ArchConfig, get_config, get_smoke_config
from repro_torch.core.client import PSClient
from repro_torch.core.node import Cluster
from repro_torch.core.tables import RowSchema, TableSpec
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models import get_model
from repro_torch.models.common import gather_from_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamW
from repro_torch.train.train_step import TrainSettings, make_lm_train_step_hier


@dataclass
class RunResult:
    """What :func:`run` returns. ``cluster``, ``client`` and ``stats`` are
    rank 0's (``None`` elsewhere); the per-step lists hold host seconds
    (``step_s`` ends when the step's loss is on the host). ``params`` and
    ``opt_state`` are this rank's local shards (``whole`` gathers a tree of
    them over ``data`` and ``model``: a collective, every rank calls it)."""

    start: int
    losses: list[float]
    params: dict
    opt_state: object
    base: str
    cluster: Cluster | None
    client: PSClient | None
    stats: dict | None  # {"hits", "misses", "hit_rate"} of the MEM-PS caches
    init_s: float = 0.0
    pull_s: list[float] = field(default_factory=list)
    step_s: list[float] = field(default_factory=list)
    d2h_s: list[float] = field(default_factory=list)
    commit_s: list[float] = field(default_factory=list)
    n_working: list[int] = field(default_factory=list)
    whole: object = None


def _to_device(a, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements="C")).to(device)


def _share_rows(sess, shape: tuple[int, int], d: int, cols: tuple[int, int], device):
    """Rank 0's session slots [B, S], and columns ``cols`` of its rows and
    accumulators [n_working, d] (contiguous), on every rank."""
    if sess is not None:
        n = torch.tensor([sess.n_working], dtype=torch.int64, device=device)
        slots = _to_device(sess.slots.astype(np.int32), device)
        rows, acc = _to_device(sess.params, device), _to_device(sess.opt_state, device)
    else:
        n = torch.empty(1, dtype=torch.int64, device=device)
    dist.broadcast(n, src=0)
    if sess is None:
        slots = torch.empty(shape, dtype=torch.int32, device=device)
        rows = torch.empty((int(n), d), dtype=torch.float32, device=device)
        acc = torch.empty_like(rows)
    for t in (slots, rows, acc):
        dist.broadcast(t, src=0)
    if cols != (0, d):
        rows, acc = rows[:, cols[0]:cols[1]].contiguous(), acc[:, cols[0]:cols[1]].contiguous()
    return slots, rows, acc


def _meta(tree):
    return ckpt.tree_map(lambda t: t.to("meta"), tree)


def _share_tree(tree, template, device, cuts, rank: int, M: int, data_rank: int, D: int):
    """Rank 0's ``tree`` (numpy leaves, as ``ckpt.restore`` gives them;
    ``None`` elsewhere) on every rank, leaf by leaf, as tensors of
    ``template``'s (meta) leaves' shapes and dtypes, each cut to this
    rank's shard over ``model`` (index ``rank`` of ``M``) and ``data``
    (``data_rank`` of ``D``) as soon as it arrives (``cuts``: the
    ``sharding.Cut`` of each flattened leaf, ``None`` where whole)."""
    leaves = ckpt._flatten(template)
    flat = ckpt._flatten(tree) if tree is not None else None
    out = {}
    for k, t in leaves.items():
        x = (_to_device(flat[k], device).to(t.dtype) if flat is not None
             else torch.empty(t.shape, dtype=t.dtype, device=device))
        dist.broadcast(x, src=0)
        out[k] = shd.shard_leaf(x, cuts.get(k), rank, M, data_rank, D)
    return ckpt._unflatten_into(template, out)


def _on_trees(state, fn):
    """An optimizer state (a NamedTuple) with ``fn`` applied to its
    parameter-shaped fields (the dicts: AdamW's m and v, Adagrad's accum)."""
    return type(state)(*(fn(f) if isinstance(f, dict) else f for f in state))


def run(cfg: ArchConfig, settings: TrainSettings, *, steps: int, batch: int = 8,
        seq: int = 128, model_parallel: int = 1, nodes: int = 2, base: str | None = None,
        ckpt_every: int = 20, resume: bool = False, device="cuda", backend: str | None = None,
        params=None, step_hook=None) -> RunResult:
    """Train ``steps`` steps of ``make_lm_train_step_hier(cfg, settings)``
    over the ranks of this process group (:func:`init_distributed`, with
    ``backend``: its default, or ``"gloo"`` for several ranks on one card).

    ``params`` (default: ``init`` from a generator seeded 0 on ``device``)
    must be the same on every rank; rank 0's are broadcast. ``base`` (rank
    0's; default a fresh temporary directory) holds the PS (``ps/``) and
    the checkpoints (``ckpt/``, every ``ckpt_every`` steps; 0 for none).
    ``resume`` restores params, optimizer state and the PS from the latest
    checkpoint and restarts the token stream at ``seed=start``, as the
    reference does. ``step_hook(i, step, args)`` (default ``step(*args)``)
    runs step ``i`` and returns its outputs: a caller that times, profiles
    or records one step."""
    info = init_distributed(device, backend=backend)
    dev, root = info.device, info.rank == 0
    mesh = make_host_mesh(model=model_parallel)
    rules = shd.build_rules(cfg, mesh)
    shd.install_constraints(mesh, rules, cfg)
    try:
        n_data = mesh.size(0)
        if batch % (n_data * settings.microbatches):
            raise ValueError(f"batch {batch} does not split into {n_data} data ranks x "
                             f"{settings.microbatches} microbatches")
        b_local = batch // n_data
        lo = mesh.get_local_rank("data") * b_local
        schema = get_model(cfg).schema(cfg)
        m_rank, d_rank = mesh.get_local_rank("model"), mesh.get_local_rank("data")
        whole = lambda tree: shd.gather_tree(tree, schema, rules, mesh)
        d = cfg.d_model
        tp_rows = model_parallel > 1 and shd.pspec((1, d), ("working_rows", "working_dim"),
                                                   rules, mesh) == (None, "model")
        cols = ((m_rank * d // model_parallel, (m_rank + 1) * d // model_parallel) if tp_rows
                else (0, d))
        t0 = time.perf_counter()
        if params is None:
            params = get_model(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0))
        template = {"params": _meta(params), "opt": settings.optimizer.init(_meta(params))}
        step = make_lm_train_step_hier(cfg, settings)
        base = base or (tempfile.mkdtemp(prefix=f"train_{cfg.name.replace('/', '_')}_")
                        if root else "")
        cluster = client = checkpointer = None
        tok_table = TableSpec("tok_emb", RowSchema.with_adagrad(d))
        start, restored = 0, None
        if root:
            cluster = Cluster(nodes, os.path.join(base, "ps"), dim=d * 2,
                              cache_capacity=max(4096, 4 * batch * seq), file_capacity=1024,
                              init_scale=0.02)
            client = PSClient(cluster, [tok_table])
            checkpointer = ckpt.AsyncCheckpointer(os.path.join(base, "ckpt"))
            if resume:
                restored, start, _, manifest = ckpt.restore(os.path.join(base, "ckpt"), template)
                if manifest is not None:
                    cluster = Cluster.restore(manifest, cluster.base_dir, **{
                        **cluster.ctor_kwargs(), "tables": None,  # manifest's specs win
                    })
                    client = PSClient(cluster, [tok_table])
                print(f"resumed from step {start}", flush=True)
        shared = [start, restored is not None]
        dist.broadcast_object_list(shared, src=0)
        start, resumed = shared
        if resumed:  # each whole leaf cut to this rank's shard as it arrives
            cuts = shd.model_cuts(schema, rules, mesh)
            flat_cuts = ckpt._flatten({"params": cuts, "opt": type(template["opt"])(*(
                cuts if isinstance(f, dict) else None for f in template["opt"]))})
            tree = _share_tree(restored, template, dev, flat_cuts, m_rank, model_parallel,
                               d_rank, n_data)
            params, opt_state = tree["params"], tree["opt"]
            del tree, restored
        else:  # AdamW's state is made on the shards, alike on every rank
            for t in shd.tensor_leaves(params):
                dist.broadcast(t, src=0)
            params = shd.shard_tree(params, schema, rules, mesh, m_rank, d_rank)
            opt_state = settings.optimizer.init(params)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # params and opt_state are filled in at the end: holding the initial
        # ones through the steps would keep a second model and AdamW state
        out = RunResult(start, [], None, None, base, cluster, client, None,
                        init_s=time.perf_counter() - t0, whole=whole)

        stream = TokenStream(cfg.vocab_size, batch, seq, seed=start)
        step_hook = step_hook or (lambda i, fn, args: fn(*args))
        t_run = time.perf_counter()
        for i in range(start, start + steps):
            toks = stream.next_batch()
            inputs, targets = toks[:, :-1], toks[:, 1:]
            t0 = time.perf_counter()
            sess = client.session("tok_emb", inputs.astype(np.uint64)) if root else None
            out.pull_s.append(time.perf_counter() - t0)
            with sess if root else contextlib.nullcontext():
                slots, rows, acc = _share_rows(sess, (batch, seq), d, cols, dev)
                micro = {"tokens": slots[lo:lo + b_local],
                         "targets": _to_device(targets[lo:lo + b_local].astype(np.int32), dev)}
                if cfg.family == "audio":
                    micro["frames"] = torch.zeros((b_local, cfg.n_frames, d),
                                                  dtype=torch.bfloat16, device=dev)
                if cfg.family == "vlm":
                    micro["image_embeds"] = torch.zeros((b_local, cfg.n_image_tokens, d),
                                                        dtype=torch.bfloat16, device=dev)
                t0 = time.perf_counter()
                params, opt_state, metrics, new_t, new_acc = step_hook(
                    i, step, (params, opt_state, micro, rows, acc))
                out.losses.append(float(metrics["loss"]))
                out.step_s.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                if tp_rows:  # the new rows' d-slices, whole for the commit
                    new_t, new_acc = gather_from_model(new_t, -1), gather_from_model(new_acc, -1)
                if root:
                    new_rows, new_accs = new_t.cpu().numpy(), new_acc.cpu().numpy()
                    out.d2h_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    sess.commit(new_rows, new_accs)
                    out.commit_s.append(time.perf_counter() - t0)
                    out.n_working.append(sess.n_working)
            if root and (i + 1) % 10 == 0:
                print(f"step {i + 1}: loss {np.mean(out.losses[-10:]):.4f}", flush=True)
            if ckpt_every and (i + 1) % ckpt_every == 0:
                # whole tensors, so a checkpoint resumes at any mesh: every
                # rank joins the gather to rank 0's host, leaf by leaf
                to_root = lambda tree: shd.gather_tree(tree, schema, rules, mesh, dst=0)
                tree = {"params": to_root(params), "opt": _on_trees(opt_state, to_root)}
                if root:
                    checkpointer.save(i + 1, tree, ps_manifest=cluster.manifest())
                del tree
        if root:
            checkpointer.wait()
            dt = time.perf_counter() - t_run
            if steps:
                print(f"{steps} steps in {dt:.0f}s ({steps * batch * seq / dt:,.0f} tok/s); "
                      f"loss {out.losses[0]:.3f} -> {np.mean(out.losses[-5:]):.3f}", flush=True)
            hits = sum(n.mem.stats.hits for n in cluster.nodes)
            misses = sum(n.mem.stats.misses for n in cluster.nodes)
            out.stats = {"hits": hits, "misses": misses, "hit_rate": hits / max(1, hits + misses)}
            print(f"embedding cache hit rate {out.stats['hit_rate']:.1%}; "
                  f"checkpoints in {base}/ckpt", flush=True)
        out.params, out.opt_state = params, opt_state
        return out
    finally:
        shd.clear_constraints()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--scale", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor parallelism: the size of the mesh's model axis (every family)")
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.scale == "smoke" else get_config(args.arch)
    settings = TrainSettings(optimizer=AdamW(lr=args.lr), microbatches=1)
    try:
        run(cfg, settings, steps=args.steps, batch=args.batch, seq=args.seq,
            model_parallel=args.model_parallel, nodes=args.nodes, base=args.ckpt_dir or None,
            ckpt_every=args.ckpt_every, resume=args.resume, device=args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
