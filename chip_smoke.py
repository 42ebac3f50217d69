#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's ad-serving path and its CTR training path
(``repro_torch``) at the full width of ``ctr-C-scaled`` — emb_dim 8, 500
nonzeros per example over 125 slots, 600,000 keys, tower (96, 48), batch
2048 in 4 mini-batches, ``[emb | adagrad]`` rows 16 floats wide — through
the entry points a user calls, and holds every kernel of those paths
against its plain PyTorch version on the card. Phases, one line each:

1. build    — compile the CUDA kernels from ``src/repro_torch/csrc``.
2. publish  — seeded dyadic rows for all 600k keys into a 2-node Cluster,
              one published snapshot version.
3. serve    — ServingCluster -> ServingEngine -> RetrievalEngine: search
              k=10 and k=100 (topk_mips kernel), rerank (embedding_bag
              kernel), lookup_device with device residency; launch counts
              read from this run, results equal to the same path on the
              plain versions, bitwise.
4. train    — CTRTrainer over PSClient / hier_ps / MEM-PS / SSD-PS on a
              fresh 2-node cluster: 6 batches serial and the same 6
              pipelined, equal bitwise (losses and all 600k flushed rows);
              embedding_bag, scatter_add (the bag's backward) and
              fused_adagrad launched 4 times per batch; a 2-batch run on
              the plain versions within a stated tolerance.
5. kernels  — each kernel against its plain version at the main-path
              shapes and on edge cases; kernel, plain, library times and
              the bound.
6. device   — the card's name and power limit (nvidia-smi).

Then one JSON line with the per-kernel record, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: non-zero exit, no
result. Without a card it exits non-zero at once.

Run:  python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores

N_KEYS = 600_000
BATCH = 256
TOPK = (10, 100)
TRAIN_BATCHES = 6
TRAIN_STREAM_SEED = 3


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def dyadic(rng, shape, lo=-8, hi=8):
    """Values on a 1/16 grid: every sum the path forms is exact in fp32."""
    import numpy as np

    return (rng.integers(lo, hi, size=shape) / 16.0).astype(np.float32)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls, CUDA
    events around the whole run (warm L2, as repeated serving calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernel_ms(fn, names: tuple[str, ...], iters: int = 20) -> dict[str, float]:
    """Device milliseconds per call of each CUDA kernel whose name contains
    one of ``names``, from torch.profiler; empty when the profiler sees no
    device time on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                us = getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
                out[n] = out.get(n, 0.0) + us / iters / 1e3
    return out if sum(out.values()) > 0 else {}


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


@contextlib.contextmanager
def plain_kernels(kops, topk_plain, bag_plain, adagrad_plain):
    """Route the dispatcher to the plain versions (the comparison runs of the
    same paths; kernel launch counters stay untouched). With the plain bag
    its backward is autograd's own, so scatter_add is not called."""
    saved = kops.topk_mips, kops.embedding_bag, kops.adagrad_update
    kops.topk_mips = lambda q, c, k, *, n_valid=None: topk_plain(q, c, k, n_valid=n_valid)
    kops.embedding_bag = bag_plain
    kops.adagrad_update = lambda p, a, g, lr, *, eps=1e-8: adagrad_plain(p, a, g, lr, eps)
    try:
        yield
    finally:
        kops.topk_mips, kops.embedding_bag, kops.adagrad_update = saved


def bag_library_call(table, ids, slot_of, valid, n_slots: int):
    """The library yardstick of the bag: ``F.embedding_bag`` over the
    nonzeros pre-sorted into (example, slot) bags (the sort is set-up, not
    timed). Returns (call, n_kept, n_rows_read)."""
    import torch

    B, nnz = ids.shape
    kept = (valid & (slot_of >= 0) & (slot_of < n_slots)).reshape(-1)
    seg = (torch.arange(B, device=ids.device).repeat_interleave(nnz) * n_slots
           + slot_of.reshape(-1).long())[kept]
    order = torch.sort(seg, stable=True).indices
    lib_in = ids.reshape(-1)[kept][order].long()
    offsets = torch.searchsorted(seg[order], torch.arange(B * n_slots, device=ids.device))
    call = lambda: torch.nn.functional.embedding_bag(lib_in, table, offsets, mode="sum")
    n_rows_read = int(torch.unique(ids.reshape(-1)[kept]).numel())
    return call, int(kept.sum()), n_rows_read


def train_phase(cfg, width: int, base: Path, seed: int, plain) -> tuple[dict, str]:
    """CTRTrainer at ``cfg`` on the card, in the reference pipeline bench's
    DRAM-resident setting (a 2-node cluster whose MEM-PS holds twice the key
    space). Returns the pipelined run's launch counts and the phase's line."""
    import numpy as np
    import torch

    from repro_torch.core.node import Cluster
    from repro_torch.data.synthetic_ctr import SyntheticCTRStream
    from repro_torch.train.trainer import CTRTrainer, TrainerConfig

    kops = plain[0]
    keys = np.arange(cfg.n_sparse_keys, dtype=np.uint64)

    def cluster(tag):
        return Cluster(2, str(base / tag), dim=width, cache_capacity=2 * cfg.n_sparse_keys,
                       file_capacity=4096, init_cols=cfg.emb_dim)

    def train(tag, n, pipelined):
        cl = cluster(tag)
        tr = CTRTrainer(cfg, cl, TrainerConfig(), device="cuda", seed=seed)
        stream = SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots,
                                    cfg.batch_size, seed=TRAIN_STREAM_SEED)
        t0 = time.perf_counter()
        losses = [r["loss"] for r in tr.run(stream, n, pipelined=pipelined)]
        secs = time.perf_counter() - t0  # run() returns with every loss on the host
        cl.flush_all()
        return np.array(losses), cl.pull(keys, pin=False), tr, secs

    kops.reset_launch_counts()
    s_loss, s_rows, s_tr, s_secs = train("serial", TRAIN_BATCHES, False)
    s_launches = kops.launch_counts()
    kops.reset_launch_counts()
    p_loss, p_rows, p_tr, p_secs = train("pipelined", TRAIN_BATCHES, True)
    launches = kops.launch_counts()
    per_run = cfg.minibatches_per_batch * TRAIN_BATCHES
    for name in ("embedding_bag", "scatter_add", "fused_adagrad"):
        check(s_launches[name] == launches[name] == per_run,
              f"{name}: {s_launches[name]} serial / {launches[name]} pipelined launches, "
              f"want {cfg.minibatches_per_batch} per batch")
    check(np.isfinite(p_loss).all() and np.isfinite(p_rows).all(), "non-finite loss or row")
    check(np.array_equal(p_loss, s_loss), f"pipelined losses {p_loss} != serial {s_loss}")
    check(np.array_equal(p_rows, s_rows), "pipelined flushed rows != serial, bitwise")
    check(p_tr.dev_ws.stats.rows_reused > 0, "no working row stayed on the device")
    moved = int((p_rows != cluster("init").pull(keys, pin=False)).any(axis=1).sum())
    check(moved > 0, "training changed no row")

    # the same path on the plain versions, on the card. Their sums run in
    # another order (index_add_ with atomics, autograd's index_put), so the
    # gradients differ in the last bits, and Adagrad's first step on an
    # element, lr*g/(|g|+eps) ~ lr*sign(g), turns a gradient within rounding
    # of zero into a step of either sign: such an element ends up to 2*lr
    # apart (0.15% of the elements, 0.099 at most, in a measured run).
    # Tolerance: losses rtol 1e-5; rows within 1e-5 for 99% of the
    # elements, and every element within 2*lr per step taken
    k_loss, k_rows, _, _ = train("kernel2", 2, True)
    before = kops.launch_counts()
    with plain_kernels(*plain):
        q_loss, q_rows, _, _ = train("plain2", 2, True)
    check(kops.launch_counts() == before, "the plain run launched a kernel")
    loss_rel = float(np.max(np.abs(q_loss - k_loss) / np.abs(k_loss)))
    row_diff = np.abs(q_rows - k_rows)
    row_err = float(row_diff.max())
    n_over = int((row_diff > 1e-5).sum())
    step_bound = 2 * TrainerConfig().row_lr * 2 * cfg.minibatches_per_batch
    check(loss_rel <= 1e-5 and n_over <= 0.01 * row_diff.size and row_err <= step_bound,
          f"plain run vs kernels: loss rel diff {loss_rel}, row max |diff| {row_err}, "
          f"{n_over} of {row_diff.size} row elements beyond 1e-5")
    emb_err = float(row_diff[:, : cfg.emb_dim].max())
    acc_err = float(row_diff[:, cfg.emb_dim:].max())

    stage_busy = {name: round(st["busy_s"], 4) for name, st in p_tr.last_pipeline.report().items()}
    ex = cfg.batch_size * TRAIN_BATCHES
    line = (f"train: {cfg.name} batches={TRAIN_BATCHES}x{cfg.batch_size} "
            f"launches={launches} losses={p_loss.tolist()} "
            f"card examples/s: pipelined={ex / p_secs:.1f} serial={ex / s_secs:.1f} "
            f"(run s: {p_secs:.3f} / {s_secs:.3f}) card pipeline busy_s={stage_busy} "
            f"n_working={[r['n_working'] for r in p_tr._results.values()]} "
            f"rows_reused={p_tr.dev_ws.stats.rows_reused} "
            f"rows_transferred={p_tr.dev_ws.stats.rows_transferred} "
            f"conflict_rows={p_tr.ps.stats.conflict_rows} rows_moved={moved} "
            f"pipelined==serial bitwise (losses, {len(keys)} flushed rows); "
            f"plain run: loss rel diff {loss_rel:.3e}, row max |diff| {row_err:.3e} "
            f"(emb {emb_err:.3e}, accum {acc_err:.3e}), {n_over} of {row_diff.size} "
            f"elements beyond 1e-5")
    torch.cuda.synchronize()
    return launches, line


def training_kernels_phase(cfg, seed: int) -> tuple[dict, dict, str]:
    """The training path's kernels (scatter_add, fused_adagrad, the bag and
    its backward) against their plain versions at the shapes of one
    ctr-C-scaled mini-batch and on edge cases, and their times there.
    Returns (timing, max_abs_err, line)."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic_ctr import SyntheticCTRStream
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
    from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_plain
    from repro_torch.kernels.scatter_add import scatter_add_cuda_, scatter_add_plain_

    dev = torch.device("cuda")
    same = torch.equal
    g = torch.Generator().manual_seed(seed)
    dy = lambda *shape: (torch.randint(-128, 128, shape, generator=g) / 16.0).to(dev)
    rn = lambda *shape: torch.randn(shape, generator=g).to(dev)
    # the first mini-batch of the train phase's first batch, its keys
    # renumbered to working slots as the session renumbers them (sorted
    # unique keys of the whole batch)
    batch = SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots,
                               cfg.batch_size, seed=TRAIN_STREAM_SEED).next_batch()
    uniq, inv = np.unique(batch.keys, return_inverse=True)
    n_working, D, S = len(uniq), cfg.emb_dim, cfg.n_slots
    mb = cfg.batch_size // cfg.minibatches_per_batch
    nnz = cfg.nnz_per_example
    ids = torch.from_numpy(inv.reshape(batch.keys.shape)[:mb].astype(np.int32)).to(dev)
    slot_of = torch.from_numpy(batch.slot_of[:mb].astype(np.int32)).to(dev)
    valid = torch.from_numpy(batch.valid[:mb]).to(dev)

    def backward_inputs(cot):
        """What the bag's backward hands scatter_add: each nonzero's pooled
        gradient times its mask, ordered by a stable sort of the ids."""
        idx = slot_of.long().unsqueeze(-1).expand(mb, nnz, D)
        rows = torch.gather(cot, 1, idx) * valid.unsqueeze(-1).float()
        sid, order = torch.sort(ids.reshape(-1), stable=True)
        return sid, rows.reshape(-1, D)[order].contiguous()

    edge = []
    zeros = torch.zeros(n_working, D, device=dev)
    # scatter_add, dyadic: every sum exact, so equal to the plain version
    # (index_add_, atomics) bitwise
    sid, g_dy = backward_inputs(dy(mb, S, D))
    counts = np.bincount(sid.cpu().numpy())
    longest_run, touched = int(counts.max()), int((counts > 0).sum())
    k_dy = scatter_add_cuda_(zeros.clone(), sid, g_dy)
    p_dy = scatter_add_plain_(zeros.clone(), sid, g_dy)
    check(same(k_dy, p_dy), "scatter_add main shape, dyadic: kernel != plain")
    max_err = {"scatter_add": float((k_dy - p_dy).abs().max())}
    # random normal: the kernel sums each run in position order, as the plain
    # version does on the CPU (bitwise) and the same bits every launch; the
    # plain version on the card reorders, within 1e-5 of the run's sum of
    # magnitudes
    _, g_rn = backward_inputs(torch.randn(mb, S, D, generator=g).to(dev))
    k_rn = scatter_add_cuda_(zeros.clone(), sid, g_rn)
    check(same(k_rn, scatter_add_cuda_(zeros.clone(), sid, g_rn)), "scatter_add: launches differ")
    cpu = scatter_add_plain_(torch.zeros(n_working, D), sid.cpu(), g_rn.cpu())
    check(same(k_rn.cpu(), cpu), "scatter_add random normal != position-order sum on the CPU")
    diff = (k_rn - scatter_add_plain_(zeros.clone(), sid, g_rn)).abs()
    scale = scatter_add_plain_(zeros.clone(), sid, g_rn.abs())
    check(bool((diff <= 1e-5 * scale + 1e-6).all()), "scatter_add random normal vs card plain")
    rn_err = float(diff.max())

    def scatter_case(name, table, ids_, grads_, assume_sorted=True):
        got = kops.scatter_add(table, ids_, grads_, assume_sorted=assume_sorted)
        want = scatter_add_plain_(table.cpu(), ids_.cpu(), grads_.cpu())  # position order
        check(same(got.cpu(), want), f"scatter_add edge case {name}")
        edge.append(name)

    i32 = dict(dtype=torch.int32, device=dev)
    t0 = dy(500, 8)  # a nonzero starting table in every case
    scatter_case("B=0", t0, torch.zeros(0, **i32), torch.zeros(0, 8, device=dev))
    scatter_case("one_run_of_4096", t0, torch.full((4096,), 7, **i32), rn(4096, 8))
    scatter_case("all_distinct", t0, torch.arange(0, 500, 2, **i32), rn(250, 8))
    for d in (4, 12):
        ids_d = torch.randint(0, 700, (20_000,), generator=g, dtype=torch.int32).sort().values
        scatter_case(f"D={d}", dy(700, d), ids_d.to(dev), rn(20_000, d))
    scatter_case("unsorted_ids", t0, torch.randint(0, 500, (30_000,), generator=g,
                                                   dtype=torch.int32).to(dev),
                 rn(30_000, 8), assume_sorted=False)

    # fused_adagrad at the working set's shape: bitwise, the plain version's
    # sqrt and division being correctly rounded on the card
    p, a, gr = rn(n_working, D), rn(n_working, D).abs(), rn(n_working, D)
    kp, ka = adagrad_cuda(p, a, gr, 0.05)
    pp, pa = adagrad_plain(p, a, gr, 0.05)
    check(same(kp, pp) and same(ka, pa), "fused_adagrad main shape != plain")
    max_err["fused_adagrad"] = max(float((kp - pp).abs().max()), float((ka - pa).abs().max()))
    for name, shape in (("n=0", (0, 8)), ("odd_n=3003", (1001, 3))):
        x, y, z = rn(*shape), rn(*shape).abs(), rn(*shape)
        kx, ky = adagrad_cuda(x, y, z, 0.05)
        px, py = adagrad_plain(x, y, z, 0.05)
        check(same(kx, px) and same(ky, py) and kx.shape == shape, f"fused_adagrad {name}")
        edge.append(f"adagrad_{name}")
    zp, za = adagrad_cuda(p, a, torch.zeros_like(gr), 0.05)
    check(same(zp, p) and same(za, a), "fused_adagrad: zero grads changed the params")
    edge.append("adagrad_zero_grads")

    # the bag forward at the mini-batch's shape, and its backward (the
    # autograd Function through scatter_add) against plain autograd, dyadic
    tbl = dy(n_working, D)
    kb = embedding_bag_cuda(tbl, ids, slot_of, valid, S)
    pb = embedding_bag_plain(tbl, ids, slot_of, valid, S)
    check(same(kb, pb), "embedding_bag training shape != plain")
    max_err["embedding_bag"] = float((kb - pb).abs().max())
    cot = dy(mb, S, D)
    t_k, t_p = tbl.clone().requires_grad_(), tbl.clone().requires_grad_()
    (kops.embedding_bag(t_k, ids, slot_of, valid, S) * cot).sum().backward()
    (embedding_bag_plain(t_p, ids, slot_of, valid, S) * cot).sum().backward()
    check(same(t_k.grad, t_p.grad), "bag backward: kernel path != plain autograd")
    edge.append("bag_backward_main_shape")

    # times at the main-path shapes (in place into one table for scatter_add)
    work = zeros.clone()
    run_sc = lambda: scatter_add_cuda_(work, sid, g_rn)
    sid64 = sid.long()
    sc = (cuda_ms(run_sc), device_kernel_ms(run_sc, ("scatter_add_kernel",)),
          cuda_ms(lambda: scatter_add_plain_(work, sid, g_rn), iters=10),
          cuda_ms(lambda: work.index_add_(0, sid64, g_rn)),
          *bound_ms(nbytes=sid.numel() * 4 + g_rn.numel() * 4 + 2 * touched * D * 4,
                    flops=float(g_rn.numel())))
    run_ag = lambda: adagrad_cuda(p, a, gr, 0.05)
    lib_p, lib_a, lib_g = p.clone(), a.clone(), gr.clone()
    lib_step = torch.zeros((), device=dev)
    lib_ag = lambda: torch._fused_adagrad_([lib_p], [lib_g], [lib_a], [lib_step], lr=0.05,
                                           lr_decay=0.0, weight_decay=0.0, eps=1e-8,
                                           maximize=False)
    try:  # the yardstick only: a build without the fused CUDA Adagrad has no single call
        lib_ag()
        ag_lib_ms = cuda_ms(lib_ag)
    except (AttributeError, RuntimeError, TypeError) as e:
        ag_lib_ms = None
        edge.append(f"no_single_library_adagrad({type(e).__name__})")
    ag = (cuda_ms(run_ag, iters=50),
          device_kernel_ms(run_ag, ("adagrad_vec4_kernel", "adagrad_scalar_kernel"), iters=50),
          cuda_ms(lambda: adagrad_plain(p, a, gr, 0.05)), ag_lib_ms,
          *bound_ms(nbytes=5.0 * p.numel() * 4, flops=7.0 * p.numel()))
    run_bag = lambda: embedding_bag_cuda(tbl, ids, slot_of, valid, S)
    lib_bag, n_kept, n_rows_read = bag_library_call(tbl, ids, slot_of, valid, S)
    check(same(lib_bag().reshape(kb.shape), kb), "library embedding_bag != kernel")
    bag = (cuda_ms(run_bag, iters=50), device_kernel_ms(run_bag, ("bag_kernel",), iters=50),
           cuda_ms(lambda: embedding_bag_plain(tbl, ids, slot_of, valid, S)),
           cuda_ms(lib_bag, iters=50),
           *bound_ms(nbytes=ids.numel() * (4 + 4 + 1) + n_rows_read * D * 4 + kb.numel() * 4,
                     flops=float(n_kept * D)))
    timing = {"embedding_bag": bag, "scatter_add": sc, "fused_adagrad": ag}
    fmt = lambda x: "null" if x is None else f"{x:.5f}"
    line = (
        "kernels (training shapes): "
        + "; ".join(f"{n} call_ms={t[0]:.5f} device_ms={t[1]} plain_ms={t[2]:.5f} "
                    f"library_ms={fmt(t[3])} bound_ms={t[4]:.6f} ({t[5]})"
                    for n, t in timing.items())
        + f"; mini-batch B={mb} nnz={nnz} n_slots={S} D={D} n_working={n_working} "
        f"kept={n_kept} rows_read={n_rows_read} scatter rows_touched={touched} "
        f"longest_run={longest_run} randn max|kernel-card plain|={rn_err:.3e}; "
        f"edge cases passed: {edge}"
    )
    return timing, max_err, line


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.ctr_models import SCALED, table_specs
    from repro_torch.convert import publish_arrays
    from repro_torch.data.synthetic_ctr import SyntheticCTRStream
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
    from repro_torch.kernels.fused_adagrad import adagrad_plain
    from repro_torch.kernels.topk_mips import MAX_K, topk_mips_cuda, topk_mips_plain
    from repro_torch.retrieval import RetrievalEngine
    from repro_torch.serve import ServingCluster, ServingEngine

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    ptxas = []
    for name in build.SOURCES:
        log = build.library_path(name).with_suffix(".log")
        if log.exists():
            ptxas += [ln.split("ptxas info    : ")[-1] for ln in log.read_text().splitlines()
                      if "Used" in ln]
    print(f"build: {time.perf_counter() - t0:.2f}s compiled={sorted(built)} "
          f"torch={torch.__version__} cuda={torch.version.cuda} ptxas={ptxas}", flush=True)

    # -------------------------------------------------------------- publish
    cfg = SCALED["C"]
    check(cfg.emb_dim == 8 and cfg.nnz_per_example == 500 and cfg.n_slots == 125
          and cfg.n_sparse_keys == N_KEYS and tuple(cfg.mlp_hidden) == (96, 48)
          and cfg.batch_size == 2048 and cfg.minibatches_per_batch == 4,
          f"unexpected ctr-C-scaled widths {cfg}")
    spec = table_specs(cfg)[0]
    width = spec.schema.width  # [emb | adagrad] = 16 floats
    rng = np.random.default_rng(args.seed)
    keys = np.arange(N_KEYS, dtype=np.uint64)
    rows = np.concatenate(
        [dyadic(rng, (N_KEYS, cfg.emb_dim)), dyadic(rng, (N_KEYS, width - cfg.emb_dim), 0, 8)],
        axis=1,
    )
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT / "build")
    snap = tmp.name
    t0 = time.perf_counter()
    version = publish_arrays(snap, n_nodes=2, dim=width, init_cols=cfg.emb_dim,
                             tables={spec.name: (spec, keys, rows)})
    print(f"publish: version={version} keys={N_KEYS} row_width={width} "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # ---------------------------------------------------------------- serve
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    engine = ServingEngine(ServingCluster(snap), device_hot_rows=65536, device="cuda")
    retr = RetrievalEngine(engine, spec.name, device="cuda")
    t_index = time.perf_counter() - t0
    idx = retr._index
    check(idx.n_rows == N_KEYS and tuple(idx.corpus.shape) == (N_KEYS, 8)
          and idx.corpus.is_cuda, f"index {idx.n_rows} rows, corpus {tuple(idx.corpus.shape)}")
    stream = SyntheticCTRStream(N_KEYS, cfg.nnz_per_example, cfg.n_slots, BATCH, seed=args.seed)
    batch = stream.next_batch()
    emb = engine.lookup(spec.name, batch.keys)  # [B, nnz, emb]
    queries = np.einsum("bn,bnd->bd", batch.valid.astype(np.float32), emb)

    def serve_once():
        """One request of BATCH users; host-clock seconds per step (each
        step ends with its results on the host)."""
        res, secs = {}, {}
        for k in TOPK:
            t0 = time.perf_counter()
            res[k] = retr.search(queries, k)
            secs[f"search_k{k}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rr = retr.rerank(res[TOPK[0]], batch.keys, batch.slot_of, batch.valid,
                         n_slots=cfg.n_slots)
        secs["rerank"] = time.perf_counter() - t0
        return res, rr, secs

    res, rr, cold_s = serve_once()
    dev_batches = [stream.next_batch().keys[:32] for _ in range(2)]
    dev_keys = [batch.keys[:32], dev_batches[0], batch.keys[:32], dev_batches[1]]
    for q_keys in dev_keys:
        slots, tbl = engine.lookup_device(spec.name, q_keys)
        check(tbl.is_cuda, "lookup_device table must live on the card")
        got = tbl[torch.from_numpy(slots.astype(np.int64)).to(dev)].cpu().numpy()
        check(np.array_equal(got, rows[q_keys.astype(np.int64), : cfg.emb_dim]),
              "lookup_device rows != published rows")
    launches = kops.launch_counts()
    reused = engine.counters["device_rows_reused"]
    check(launches["topk_mips"] > 0 and launches["embedding_bag"] > 0,
          f"a kernel of the serving path never ran: {launches}")
    check(reused > 0, "lookup_device reused no device-resident row")
    for k in TOPK:
        r = res[k]
        check(r.scores.shape == (BATCH, k) and np.isfinite(r.scores).all() and r.valid.all(),
              f"search k={k}: shape {r.scores.shape}, all finite and valid")
    check(rr.scores.shape == (BATCH, TOPK[0]) and np.isfinite(rr.scores).all(), "rerank shape")
    # the same path on the plain versions, on the card: equal bitwise
    plain = (kops, topk_mips_plain, embedding_bag_plain, adagrad_plain)
    with plain_kernels(*plain):
        res_p, rr_p, _ = serve_once()
    check(kops.launch_counts() == launches, "the plain run launched a kernel")
    for k in TOPK:
        check(np.array_equal(res[k].scores, res_p[k].scores)
              and np.array_equal(res[k].indices, res_p[k].indices)
              and np.array_equal(res[k].ad_keys, res_p[k].ad_keys),
              f"search k={k}: kernel path != plain path")
    check(np.array_equal(rr.scores, rr_p.scores) and np.array_equal(rr.indices, rr_p.indices),
          "rerank: kernel path != plain path")
    # and the rerank against a numpy rescoring of the same candidates
    user_vec = np.einsum("bn,bnd->bd", batch.valid.astype(np.float32), emb)
    first = res[TOPK[0]]
    inter = np.einsum("qd,qkd->qk", user_vec, rows[first.indices, : cfg.emb_dim])
    final = first.scores + inter
    for b in range(8):
        order = np.lexsort((first.indices[b], -final[b]))
        check(np.array_equal(rr.scores[b], final[b][order]), "rerank != numpy rescoring")
    warm_s = serve_once()[2]  # after the counts were read: not the main path's run
    fmt = lambda d: {k: round(v, 6) for k, v in d.items()}
    print(f"serve: launches={launches} device_rows_reused={reused} "
          f"index_build_s={t_index:.3f} first_request_s={fmt(cold_s)} "
          f"warm_request_s={fmt(warm_s)} "
          f"kernel==plain bitwise for search k={list(TOPK)} and rerank", flush=True)

    # ---------------------------------------------------------------- train
    train_launches, train_line = train_phase(cfg, width, Path(snap) / "train", args.seed, plain)
    print(train_line, flush=True)

    # -------------------------------------------------------------- kernels
    corpus = idx.corpus
    q_dev = torch.from_numpy(queries).to(dev)

    def same(a, b):
        return bool(torch.equal(a, b))

    # topk_mips: the main-path shapes, dyadic -> bitwise
    for k in TOPK:
        kv, ki = topk_mips_cuda(q_dev, corpus, k, n_valid=idx.n_rows)
        pv, pi = topk_mips_plain(q_dev, corpus, k, n_valid=idx.n_rows)
        check(same(kv, pv) and same(ki, pi), f"topk_mips k={k} main shape != plain")
    max_err = {"topk_mips": float((kv - pv).abs().max())}
    edge = []
    g = torch.Generator(device="cpu").manual_seed(args.seed)

    def dy(*shape):
        return (torch.randint(-128, 128, shape, generator=g) / 64.0).to(dev)

    def topk_case(name, q, c, k, n_valid=None):
        kv, ki = topk_mips_cuda(q, c, k, n_valid=n_valid)
        pv, pi = topk_mips_plain(q, c, k, n_valid=n_valid)
        check(same(kv, pv) and same(ki, pi), f"topk_mips edge case {name}")
        edge.append(name)

    topk_case("k>N", dy(5, 8), dy(50, 8), 64)
    topk_case("n_valid_tail", dy(9, 8), dy(5000, 8), 33, n_valid=3001)
    topk_case("ties_4x_rows", dy(16, 8), dy(1000, 8).repeat(4, 1), 40)
    topk_case("ragged_Q=13", dy(13, 16), dy(20000, 16), 7)
    topk_case("k=1", dy(3, 8), dy(7000, 8), 1)
    topk_case(f"k=MAX_K={MAX_K}", dy(20, 8), dy(100000, 8), MAX_K)
    topk_case("n_valid=0", dy(4, 8), dy(100, 8), 5, n_valid=0)
    try:
        topk_mips_cuda(dy(2, 8), dy(10, 8), MAX_K + 1)
        check(False, "k > MAX_K must raise")
    except ValueError:
        edge.append("k>MAX_K_raises")
    # random normal data: scores within a stated tolerance
    qn = torch.randn(BATCH, 8, generator=g).to(dev)
    cn = torch.randn(N_KEYS, 8, generator=g).to(dev)
    kv, ki = topk_mips_cuda(qn, cn, 100)
    pv, pi = topk_mips_plain(qn, cn, 100)
    rnd_err = float((kv - pv).abs().max())
    agree = float((ki == pi).float().mean())
    check(torch.allclose(kv, pv, rtol=1e-5, atol=1e-5) and agree >= 0.99,
          f"topk_mips random normal: max |dscore| {rnd_err}, index agreement {agree}")
    edge.append(f"randn(max_abs_err={rnd_err:.2e},idx_agree={agree:.4f})")

    # embedding_bag: the rerank's inputs at the main-path shapes
    uniq, inv = np.unique(batch.keys.reshape(-1), return_inverse=True)
    bag_table = torch.from_numpy(rows[uniq.astype(np.int64), : cfg.emb_dim].copy()).to(dev)
    bag_ids = torch.from_numpy(inv.astype(np.int32).reshape(batch.keys.shape)).to(dev)
    bag_slot = torch.from_numpy(batch.slot_of.astype(np.int32)).to(dev)
    bag_valid = torch.from_numpy(batch.valid).to(dev)
    kb = embedding_bag_cuda(bag_table, bag_ids, bag_slot, bag_valid, cfg.n_slots)
    pb = embedding_bag_plain(bag_table, bag_ids, bag_slot, bag_valid, cfg.n_slots)
    check(same(kb, pb), "embedding_bag main shape != plain")
    kb2 = embedding_bag_cuda(bag_table, bag_ids, bag_slot, bag_valid, cfg.n_slots)
    check(same(kb, kb2), "embedding_bag: two launches differ")
    max_err["embedding_bag"] = float((kb - pb).abs().max())

    def bag_case(name, table, ids, slot, valid, n_slots, tol=None):
        kb = kops.embedding_bag(table, ids, slot, valid, n_slots)
        pb = embedding_bag_plain(table, ids, slot, valid, n_slots)
        ok = (same(kb, pb) if tol is None else
              torch.allclose(kb.float(), pb.float(), rtol=tol, atol=tol))
        check(ok, f"embedding_bag edge case {name}")
        edge.append(name)

    B2, nnz2, S2 = 33, 2500, 40  # nnz above the kernel's 1024-nonzero chunk
    t2 = dy(3000, 8)
    ids2 = torch.randint(0, 3000, (B2, nnz2), generator=g, dtype=torch.int32).to(dev)
    slot2 = torch.randint(-3, S2 + 3, (B2, nnz2), generator=g, dtype=torch.int32).to(dev)
    val2 = (torch.rand(B2, nnz2, generator=g) < 0.7).to(dev)
    bag_case("nnz>chunk+out_of_range_slots", t2, ids2, slot2, val2, S2)
    bag_case("float_mask", t2, ids2, slot2, val2.float() * 3.0, S2)
    bag_case("bf16_dyadic", t2.to(torch.bfloat16), ids2, slot2, val2, S2)
    bag_case("bf16_randn", torch.randn(3000, 8, generator=g).to(dev, torch.bfloat16),
             ids2, slot2, val2, S2, tol=1e-2)
    bag_case("f32_randn_D=12", torch.randn(3000, 12, generator=g).to(dev),
             ids2, slot2, val2, S2, tol=1e-5)
    bag_case("nnz=0", t2, ids2[:, :0], slot2[:, :0], val2[:, :0], S2)

    # timings at the main-path shapes
    k_main = TOPK[1]
    run_topk = lambda: topk_mips_cuda(q_dev, corpus, k_main, n_valid=idx.n_rows)
    topk_ms = cuda_ms(run_topk)
    topk_dev_ms = device_kernel_ms(run_topk, ("mips_partial", "mips_merge"))
    topk_plain_ms = cuda_ms(lambda: topk_mips_plain(q_dev, corpus, k_main, n_valid=idx.n_rows),
                            iters=5)
    topk_lib_ms = cuda_ms(lambda: torch.topk(q_dev @ corpus.T, k_main, dim=1), iters=10)
    topk_bound, topk_by = bound_ms(
        nbytes=(q_dev.numel() + corpus.numel()) * 4 + BATCH * k_main * 8,
        flops=2.0 * BATCH * idx.n_rows * corpus.shape[1],
    )
    run_bag = lambda: embedding_bag_cuda(bag_table, bag_ids, bag_slot, bag_valid, cfg.n_slots)
    bag_ms = cuda_ms(run_bag, iters=50)
    bag_dev_ms = device_kernel_ms(run_bag, ("bag_kernel",), iters=50)
    bag_plain_ms = cuda_ms(
        lambda: embedding_bag_plain(bag_table, bag_ids, bag_slot, bag_valid, cfg.n_slots))
    lib_bag, n_kept, n_rows_read = bag_library_call(bag_table, bag_ids, bag_slot, bag_valid,
                                                    cfg.n_slots)
    check(torch.equal(lib_bag().reshape(kb.shape), kb), "library embedding_bag != kernel")
    bag_lib_ms = cuda_ms(lib_bag, iters=50)
    bag_bound, bag_by = bound_ms(
        nbytes=bag_ids.numel() * (4 + 4 + 1) + n_rows_read * cfg.emb_dim * 4 + kb.numel() * 4,
        flops=float(n_kept * cfg.emb_dim),
    )
    timing = {
        "topk_mips": (topk_ms, topk_dev_ms, topk_plain_ms, topk_lib_ms, topk_bound, topk_by),
        "embedding_bag": (bag_ms, bag_dev_ms, bag_plain_ms, bag_lib_ms, bag_bound, bag_by),
    }
    print(
        "kernels (serving shapes): "
        + "; ".join(
            f"{n} launches={launches[n]} call_ms={t[0]:.5f} device_ms={t[1]} plain_ms={t[2]:.5f} "
            f"library_ms={t[3]:.5f} bound_ms={t[4]:.6f} ({t[5]})" for n, t in timing.items())
        + f"; topk shape Q={BATCH} N={idx.n_rows} D={corpus.shape[1]} k={k_main}; bag shape "
        f"B={BATCH} nnz={cfg.nnz_per_example} n_slots={cfg.n_slots} D={cfg.emb_dim} "
        f"kept={n_kept} rows_read={n_rows_read}; edge cases passed: {edge}",
        flush=True,
    )

    train_timing, train_err, train_kernels_line = training_kernels_phase(cfg, args.seed)
    print(train_kernels_line, flush=True)

    # --------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)

    # topk_mips at the serving path's shapes and launches; the other three at
    # one training mini-batch's shapes with the training path's launches
    sources = {
        "topk_mips": ("src/repro_torch/csrc/topk_mips.cu", "src/repro/kernels/topk_mips.py:101"),
        "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:63"),
        "scatter_add": ("src/repro_torch/csrc/scatter_add.cu",
                        "src/repro/kernels/scatter_add.py:43"),
        "fused_adagrad": ("src/repro_torch/csrc/fused_adagrad.cu",
                          "src/repro/kernels/fused_adagrad.py:33"),
    }
    timing = {"topk_mips": timing["topk_mips"], **train_timing}
    max_err = {"topk_mips": max_err["topk_mips"], **train_err}
    main_launches = {"topk_mips": launches["topk_mips"],
                     **{n: train_launches[n] for n in train_timing}}
    record = []
    for name, (src, replaces) in sources.items():
        call_ms, dev_ms, plain_ms, lib_ms, b_ms, b_by = timing[name]
        dev_ms = sum(dev_ms.values()) if dev_ms else None
        check(main_launches[name] > 0, f"{name} never launched on its path")
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": dev_ms if dev_ms is not None else call_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
    retr.close()
    tmp.cleanup()
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
