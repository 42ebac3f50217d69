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
(``launch/sharding.py``). A ``--model-parallel`` above 1 raises: tensor
parallelism is ROADMAP §1 slice 9.

Usage (one process; ``--device cpu`` runs the plain versions on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --scale smoke \\
      --steps 50 --batch 8 --seq 128 [--ckpt-dir DIR] [--resume]
  PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train ...
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
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamW
from repro_torch.train.train_step import TrainSettings, make_lm_train_step_hier


@dataclass
class RunResult:
    """What :func:`run` returns. ``cluster``, ``client`` and ``stats`` are
    rank 0's (``None`` elsewhere); the per-step lists hold host seconds
    (``step_s`` ends when the step's loss is on the host)."""

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


def _to_device(a, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements="C")).to(device)


def _share_rows(sess, shape: tuple[int, int], d: int, device):
    """Rank 0's session slots [B, S], rows and accumulators [n_working, d]
    on every rank."""
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
    return slots, rows, acc


def run(cfg: ArchConfig, settings: TrainSettings, *, steps: int, batch: int = 8,
        seq: int = 128, model_parallel: int = 1, nodes: int = 2, base: str | None = None,
        ckpt_every: int = 20, resume: bool = False, device="cuda", params=None,
        step_hook=None) -> RunResult:
    """Train ``steps`` steps of ``make_lm_train_step_hier(cfg, settings)``
    over the ranks of this process group (:func:`init_distributed`).

    ``params`` (default: ``init`` from a generator seeded 0 on ``device``)
    must be the same on every rank; rank 0's are broadcast. ``base`` (rank
    0's; default a fresh temporary directory) holds the PS (``ps/``) and
    the checkpoints (``ckpt/``, every ``ckpt_every`` steps; 0 for none).
    ``resume`` restores params, optimizer state and the PS from the latest
    checkpoint and restarts the token stream at ``seed=start``, as the
    reference does. ``step_hook(i, step, args)`` (default ``step(*args)``)
    runs step ``i`` and returns its outputs: a caller that times, profiles
    or records one step."""
    info = init_distributed(device)
    dev, root = info.device, info.rank == 0
    mesh = make_host_mesh(model=model_parallel)
    shd.install_constraints(mesh, shd.build_rules(cfg, mesh))
    try:
        n_data = mesh.size(0)
        if batch % (n_data * settings.microbatches):
            raise ValueError(f"batch {batch} does not split into {n_data} data ranks x "
                             f"{settings.microbatches} microbatches")
        b_local = batch // n_data
        lo = mesh.get_local_rank("data") * b_local
        t0 = time.perf_counter()
        if params is None:
            params = get_model(cfg).init(cfg, torch.Generator(device=dev).manual_seed(0))
        opt_state = settings.optimizer.init(params)
        step = make_lm_train_step_hier(cfg, settings)
        base = base or (tempfile.mkdtemp(prefix=f"train_{cfg.name.replace('/', '_')}_")
                        if root else "")
        cluster = client = checkpointer = None
        tok_table = TableSpec("tok_emb", RowSchema.with_adagrad(cfg.d_model))
        start = 0
        if root:
            cluster = Cluster(nodes, os.path.join(base, "ps"), dim=cfg.d_model * 2,
                              cache_capacity=max(4096, 4 * batch * seq), file_capacity=1024,
                              init_scale=0.02)
            client = PSClient(cluster, [tok_table])
            checkpointer = ckpt.AsyncCheckpointer(os.path.join(base, "ckpt"))
            if resume:
                tree, start, _, manifest = ckpt.restore(
                    os.path.join(base, "ckpt"), {"params": params, "opt": opt_state})
                tree = ckpt.tree_map(lambda a: _to_device(a, dev), tree)
                params, opt_state = tree["params"], tree["opt"]
                if manifest is not None:
                    cluster = Cluster.restore(manifest, cluster.base_dir, **{
                        **cluster.ctor_kwargs(), "tables": None,  # manifest's specs win
                    })
                    client = PSClient(cluster, [tok_table])
                print(f"resumed from step {start}", flush=True)
        shared = [start]
        dist.broadcast_object_list(shared, src=0)
        start = shared[0]
        for t in shd.tensor_leaves((params, opt_state)):
            dist.broadcast(t, src=0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # params and opt_state are filled in at the end: holding the initial
        # ones through the steps would keep a second model and AdamW state
        out = RunResult(start, [], None, None, base, cluster, client, None,
                        init_s=time.perf_counter() - t0)

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
                slots, rows, acc = _share_rows(sess, (batch, seq), cfg.d_model, dev)
                micro = {"tokens": slots[lo:lo + b_local],
                         "targets": _to_device(targets[lo:lo + b_local].astype(np.int32), dev)}
                if cfg.family == "audio":
                    micro["frames"] = torch.zeros((b_local, cfg.n_frames, cfg.d_model),
                                                  dtype=torch.bfloat16, device=dev)
                if cfg.family == "vlm":
                    micro["image_embeds"] = torch.zeros((b_local, cfg.n_image_tokens, cfg.d_model),
                                                        dtype=torch.bfloat16, device=dev)
                t0 = time.perf_counter()
                params, opt_state, metrics, new_t, new_acc = step_hook(
                    i, step, (params, opt_state, micro, rows, acc))
                out.losses.append(float(metrics["loss"]))
                out.step_s.append(time.perf_counter() - t0)
                if root:
                    t0 = time.perf_counter()
                    new_rows, new_accs = new_t.cpu().numpy(), new_acc.cpu().numpy()
                    out.d2h_s.append(time.perf_counter() - t0)
                    t0 = time.perf_counter()
                    sess.commit(new_rows, new_accs)
                    out.commit_s.append(time.perf_counter() - t0)
                    out.n_working.append(sess.n_working)
            if root and (i + 1) % 10 == 0:
                print(f"step {i + 1}: loss {np.mean(out.losses[-10:]):.4f}", flush=True)
            if root and ckpt_every and (i + 1) % ckpt_every == 0:
                checkpointer.save(i + 1, {"params": params, "opt": opt_state},
                                  ps_manifest=cluster.manifest())
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
    ap.add_argument("--model-parallel", type=int, default=1)
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
