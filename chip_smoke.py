#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's ad-serving path, its CTR training path and its streaming
ingestion path (``repro_torch``) at the full width of ``ctr-C-scaled`` — emb_dim 8, 500
nonzeros per example over 125 slots, 600,000 keys, tower (96, 48), batch
2048 in 4 mini-batches, ``[emb | adagrad]`` rows 16 floats wide — its
LM serving path at Yi-9B's published widths, its MoE serving path at
OLMoE-1B-7B's published widths and depth and its VLM serving path at
Pixtral-12B's published widths, through the entry points a user calls, and
holds every kernel of those paths against its plain PyTorch version on the
card. Phases, one line each:

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
5. ingest   — CTRTrainer(ingest=True) on raw records with ragged nnz:
              6 batches pipelined, the same serial, and the host feeder over
              the same records, equal bitwise (losses and all 600k flushed
              rows); feature_extract launched once per batch.
6. kernels  — each kernel against its plain version at the main-path
              shapes and on edge cases; kernel, plain, library times and
              the bound; feature_extract also against the numpy host
              extraction, and its static SASS instruction count.
7. grouped  — a few grouped train steps at TINY_HETERO (widths 4 and 8)
              and LR steps at width 1 through the kernels, against the
              plain versions.
8. lm       — LM serving at Yi-9B's published widths (48 layers, d 4096,
              32 heads over 4 KV heads, Dh 128, d_ff 11008, vocab 64,000):
              publish a seeded fp32 ``tok_emb`` table of all 64,000 tokens,
              ServingEngine.lookup_device -> prefill of 4 x 2048 prompt
              tokens (embedding_lookup once, flash_attention once per
              layer) -> 32 greedy decode steps (one lookup_device and one
              embedding_lookup each); against plain attention, decode
              continuity, both kernels against their plain versions at the
              path's shapes and on edge cases, and their times.
9. moe      — MoE serving at OLMoE-1B-7B's published widths and depth (16
              layers, d 2048, 16 heads, 64 experts top-8 of d_ff 1024,
              vocab 50,304), the same path: per prefill 1 embedding_lookup,
              16 flash_attention and 48 moe_gmm (each layer's wi, wg and wo
              products over the compacted buffer of the kept rows, one
              tile plan per layer), per decode step 1 and 48 moe_gmm, every
              moe_gmm launch on the wgmma + TMA kernel; moe_gmm against its
              plain version on layer 0's real operands (compacted, and the
              reference's [64, 1280, 2048] capacity layout through both bf16
              kernels) and on edge cases, one moe_block compacted against
              the capacity layout and against the plain version, the kernel
              prefill against a fully plain one (and the tokens whose
              experts differ per layer), decode continuity, times beside
              torch.bmm and torch._grouped_mm.
10. vlm     — VLM serving at Pixtral-12B's published widths (``VLM_LAYERS``
              of its 40 layers): 4 x (256 seeded image embeddings + 1,792
              prompt tokens), 8 decode steps, against plain attention.
11. device  — the card's name and power limit (nvidia-smi).

Then one JSON line with the per-kernel record, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: non-zero exit, no
result. Without a card it exits non-zero at once.

Run:  python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 dense tensor cores

N_KEYS = 600_000
BATCH = 256
TOPK = (10, 100)
TRAIN_BATCHES = 6
TRAIN_STREAM_SEED = 3
SMS, INT32_LANES = 132, 64  # H100 SXM: SMs, INT32 lanes per SM per clock
FADD_LATENCY = 4  # cycles from one fp32 add to the next that depends on it (Hopper)
# 64-bit integer operations of one valid position: two seed xors, two
# splitmix64 rounds (add, three shift-xor pairs, two multiplies: 9 each)
# and two modulos; an invalid position hashes nothing
FE_U64_OPS = 2 + 2 * 9 + 2


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
    """Device milliseconds per launch of each CUDA kernel whose name contains
    one of ``names``, from torch.profiler; empty when the profiler sees no
    device time on this machine. The mean is over the launches the profiler
    recorded: on the card's machine it has kept only 6 or 7 of 10 launches
    of a 12 ms kernel."""
    import torch
    from torch.autograd import DeviceType
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
            if n in ev.key and ev.device_type == DeviceType.CUDA:
                out[n] = out.get(n, 0.0) + ev.self_device_time_total / ev.count / 1e3
    return out if sum(out.values()) > 0 else {}


def top_device_kernel(fn, iters: int = 5) -> str:
    """The name of the CUDA kernel that takes the most device time over
    ``iters`` calls of ``fn`` (which library kernel a yardstick ran)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [(ev.self_device_time_total, ev.key) for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA]
    return max(kernels)[1][:80] if kernels else "not seen by the profiler"


def device_breakdown(fn, top: int = 5) -> tuple[float, float, list]:
    """One call under torch.profiler: (host-clock ms to the end of its
    device work, device ms summed over its kernels, the ``top`` kernels by
    device ms with their launch counts). Kernels of one stream do not overlap, so their sum over the
    host-clock time is the device's busy share of the call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((ev.key[:48], ev.self_device_time_total / 1e3, ev.count)
                      for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    return (wall_ms, sum(k[1] for k in kernels),
            [(name, round(ms, 3), n) for name, ms, n in kernels[:top]])


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return float(out.splitlines()[0]) * 1e6


def bound_ms(nbytes: float, flops: float, peak: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
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
    bag = (cuda_ms(run_bag, iters=50), device_kernel_ms(run_bag, ("bag_sort_kernel",), iters=50),
           cuda_ms(lambda: embedding_bag_plain(tbl, ids, slot_of, valid, S)),
           cuda_ms(lib_bag, iters=50),
           *bound_ms(nbytes=ids.numel() * (4 + 4 + 1) + n_rows_read * D * 4 + kb.numel() * 4,
                     flops=float(n_kept * D)))
    # scatter_add's contract makes the longest run one dependent chain of adds;
    # the kernel on that run alone (one key, longest_run ids) shows its share
    chain_ms = longest_run * FADD_LATENCY / max_sm_clock_hz() * 1e3
    one_ids = torch.zeros(longest_run, dtype=torch.int32, device=dev)
    one_g = g_rn[:longest_run].contiguous()
    one_run = device_kernel_ms(lambda: scatter_add_cuda_(work, one_ids, one_g),
                               ("scatter_add_kernel",), iters=50)
    timing = {"embedding_bag": bag, "scatter_add": sc, "fused_adagrad": ag}
    fmt = lambda x: "null" if x is None else f"{x:.5f}"
    line = (
        "kernels (training shapes): "
        + "; ".join(f"{n} call_ms={t[0]:.5f} device_ms={t[1]} plain_ms={t[2]:.5f} "
                    f"library_ms={fmt(t[3])} bound_ms={t[4]:.6f} ({t[5]})"
                    for n, t in timing.items())
        + f"; mini-batch B={mb} nnz={nnz} n_slots={S} D={D} n_working={n_working} "
        f"kept={n_kept} rows_read={n_rows_read} scatter rows_touched={touched} "
        f"longest_run={longest_run} scatter serial-chain bound_ms={chain_ms:.6f} "
        f"({longest_run} x {FADD_LATENCY} cycles at the max SM clock), the kernel on one run "
        f"of {longest_run} ids alone device_ms={sum(one_run.values()) if one_run else None} "
        f"randn max|kernel-card plain|={rn_err:.3e}; "
        f"edge cases passed: {edge}"
    )
    return timing, max_err, line


def ingest_phase(cfg, width: int, base: Path) -> tuple[int, str]:
    """CTRTrainer(ingest=True) at ``cfg`` on raw records with ragged nnz, in
    the train phase's DRAM-resident setting: pipelined, serial, and the host
    feeder over the same records, equal bitwise. Returns the pipelined
    run's feature_extract launches and the phase's line."""
    import numpy as np
    import torch

    from repro_torch.core.node import Cluster
    from repro_torch.data.synthetic_ctr import SyntheticCTRStream, to_ctr_batch
    from repro_torch.kernels import ops as kops
    from repro_torch.train.trainer import CTRTrainer, TrainerConfig

    keys = np.arange(cfg.n_sparse_keys, dtype=np.uint64)

    def raw_records():
        return SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots,
                                  cfg.batch_size, seed=TRAIN_STREAM_SEED).raw_records()

    def run(tag, ingest, pipelined):
        cl = Cluster(2, str(base / tag), dim=width, cache_capacity=2 * cfg.n_sparse_keys,
                     file_capacity=4096, init_cols=cfg.emb_dim)
        tr = CTRTrainer(cfg, cl, TrainerConfig(ingest=ingest), device="cuda", seed=0)
        src = raw_records() if ingest else (
            to_ctr_batch(r, cfg.n_sparse_keys, cfg.n_slots, cfg.nnz_per_example)
            for r in raw_records())
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [r["loss"] for r in tr.run(src, TRAIN_BATCHES, pipelined=pipelined)]
        secs = time.perf_counter() - t0  # run() returns with every loss on the host
        launches = kops.launch_counts()
        cl.flush_all()
        return np.array(losses), cl.pull(keys, pin=False), tr, secs, launches

    # host feeder and ingest in turns, then the serial ingest run
    runs = {tag: run(tag, ingest, pipelined) for tag, ingest, pipelined in (
        ("host", False, True), ("ingest", True, True), ("serial", True, False),
        ("ingest2", True, True), ("host2", False, True))}
    h_loss, h_rows = runs["host"][:2]
    check(np.isfinite(h_loss).all() and np.isfinite(h_rows).all(), "non-finite loss or row")
    for tag, (loss, rows, tr, _, launches) in runs.items():
        check(np.array_equal(loss, h_loss), f"{tag} losses {loss} != host feeder {h_loss}")
        check(np.array_equal(rows, h_rows), f"{tag} flushed rows != host feeder, bitwise")
        want = 0 if tr.ingestor is None else TRAIN_BATCHES
        check(launches["feature_extract"] == want,
              f"{tag}: feature_extract launched {launches['feature_extract']} times, want {want}")
        if tr.ingestor is not None:
            c = tr.ingestor.counters
            check(tr.ingestor.ring.live_slots == 0, f"{tag}: staging slots left live")
            check(c["ingest_batches"] == TRAIN_BATCHES
                  and c["ingest_examples"] == TRAIN_BATCHES * cfg.batch_size,
                  f"{tag}: ingest counters {c.snapshot()}")
    ex = cfg.batch_size * TRAIN_BATCHES
    busy = lambda tag: {n: round(st["busy_s"], 4)
                        for n, st in runs[tag][2].last_pipeline.report().items()}
    c = runs["ingest"][2].ingestor.counters
    line = (f"ingest: {cfg.name} batches={TRAIN_BATCHES}x{cfg.batch_size} "
            f"feature_extract launches={runs['ingest'][4]['feature_extract']} "
            f"card examples/s: ingest={ex / runs['ingest'][3]:.1f},{ex / runs['ingest2'][3]:.1f} "
            f"host_feeder={ex / runs['host'][3]:.1f},{ex / runs['host2'][3]:.1f} "
            f"ingest_serial={ex / runs['serial'][3]:.1f} "
            f"(run s: ingest {runs['ingest'][3]:.3f},{runs['ingest2'][3]:.3f} host "
            f"{runs['host'][3]:.3f},{runs['host2'][3]:.3f} serial {runs['serial'][3]:.3f}) "
            f"card pipeline busy_s ingest={busy('ingest')} host={busy('host')} "
            f"counters staging_bytes={c['staging_bytes']} ingest_wait_us={c['ingest_wait_us']} "
            f"ingest_overlap_us={c['ingest_overlap_us']} losses={h_loss.tolist()} "
            f"ingest==serial==host feeder bitwise (losses, {len(keys)} flushed rows), "
            f"no slot live")
    torch.cuda.synchronize()
    return runs["ingest"][4]["feature_extract"], line


def sass_static(lib: Path, kernel: str) -> dict | None:
    """Static SASS of the function whose name contains ``kernel`` in a built
    library (NOPs excluded): its instruction count and, for each subroutine
    it calls, the subroutine's size and its call sites. None where the
    toolkit has no cuobjdump."""
    import re

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    dump = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ins, inside = [], False
    for ln in dump.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if inside and m and not m.group(2).strip().startswith("NOP"):
            ins.append((int(m.group(1), 16), m.group(2).strip()))
    calls: dict[int, int] = {}
    for _, op in ins:
        m = re.search(r"CALL\.\S*\s+0x([0-9a-f]+)", op)
        if m:
            calls[int(m.group(1), 16)] = calls.get(int(m.group(1), 16), 0) + 1
    subs = {}
    for target, n_calls in calls.items():
        body = [op for addr, op in ins if addr >= target]
        size = next(i for i, op in enumerate(body) if op.startswith("RET")) + 1
        subs[hex(target)] = {"size": size, "call_sites": n_calls}
    return {"instructions": len(ins), "subroutines": subs}


def feature_extract_phase(cfg, seed: int) -> tuple[tuple, float, str]:
    """feature_extract against its plain version on the card (bitwise) and
    the numpy host extraction, at the ingest batch's shape and key spaces up
    to paper scale, and on edge cases; its times there. Returns (timing,
    max_abs_err, line)."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic_ctr import SyntheticCTRStream, extract_host
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.feature_extract import feature_extract_cuda, feature_extract_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    seeds = dict(key_seed=17, slot_seed=31)
    P, S = cfg.nnz_per_example, cfg.n_slots
    edge, max_err = [], 0

    def case(name, raw, lengths, n_keys, n_slots):
        """kernel == plain on the card, and == extract_host on the host."""
        nonlocal max_err
        want_k, want_s, want_v = extract_host(raw, lengths, n_keys, n_slots)
        t_raw = torch.from_numpy(np.ascontiguousarray(raw).view(np.int64)).to(dev)
        t_valid = torch.from_numpy(want_v).to(dev)
        k, s = feature_extract_cuda(t_raw, t_valid, n_keys=n_keys, n_slots=n_slots, **seeds)
        pk, ps = feature_extract_plain(t_raw, t_valid, n_keys=n_keys, n_slots=n_slots, **seeds)
        check(torch.equal(k, pk) and torch.equal(s, ps), f"feature_extract {name}: kernel != plain")
        check(np.array_equal(k.cpu().numpy().view(np.uint64), want_k)
              and np.array_equal(s.cpu().numpy(), want_s),
              f"feature_extract {name}: kernel != numpy host extraction")
        if raw.size:
            max_err = max(max_err, int((k - pk).abs().max()), int((s - ps).abs().max()))
        edge.append(name)
        return t_raw, t_valid, want_k

    # the main path's batch: the first raw records of the ingest phase
    first = next(SyntheticCTRStream(cfg.n_sparse_keys, P, S, cfg.batch_size,
                                    seed=TRAIN_STREAM_SEED).raw_records())
    B = cfg.batch_size
    raw_main, valid_main, _ = case(f"main_{B}x{P}_n_keys={cfg.n_sparse_keys}", first.raw_ids,
                                   first.lengths, cfg.n_sparse_keys, S)
    wide_raw = rng.integers(0, 2**64, size=(B, P), dtype=np.uint64)
    for n_keys in (6 * 10**10, 2 * 10**11):  # paper models C and E
        _, _, k = case(f"{B}x{P}_n_keys={n_keys:.0e}", wide_raw, first.lengths, n_keys, S)
        check(bool((k >> np.uint64(32)).any()), "wide key space: high key bits never set")
    small = rng.integers(0, 2**64, size=(64, P), dtype=np.uint64)
    small[0, :6] = [0, 1, 2**63, 2**64 - 1, 0xFFFFFFFF, 2**32]
    lens = rng.integers(0, P + 1, 64).astype(np.int32)
    case("pow2_modulus_2^20", small, lens, 2**20, 128)
    case("modulus_2^32-5", small, lens, 2**32 - 5, 2**31 - 1)
    case("n_keys=2^63-25", small, lens, 2**63 - 25, S)
    case("n_keys=2^63", small, lens, 2**63, S)
    case("all_invalid_rows", small, np.zeros(64, dtype=np.int32), cfg.n_sparse_keys, S)
    case("odd_13x37", rng.integers(0, 2**64, size=(13, 37), dtype=np.uint64), None, 1000, 8)
    before = feature_extract_cuda.launches
    case("size_0", np.zeros((0, P), dtype=np.uint64), np.zeros(0, dtype=np.int32), 1000, 8)
    check(feature_extract_cuda.launches == before, "an empty input launched the kernel")
    try:
        kops.feature_extract(raw_main, valid_main, n_keys=1000, n_slots=2**31)
        check(False, "n_slots >= 2^31 must raise")
    except ValueError:
        edge.append("n_slots>=2^31_raises")

    run_k = lambda: feature_extract_cuda(raw_main, valid_main, n_keys=cfg.n_sparse_keys,
                                         n_slots=S, **seeds)
    n, n_valid = raw_main.numel(), int(valid_main.sum())
    clock_mhz = max_sm_clock_hz() / 1e6
    int_rate = SMS * INT32_LANES * clock_mhz * 1e6  # int32 lane operations per second
    # the kernel reads a raw id only where its position is valid; every
    # position reads its valid byte and writes a key and a slot
    t_bytes = (8 * n_valid + (1 + 8 + 4) * n) / HBM_BYTES_PER_S
    t_ops = n_valid * FE_U64_OPS / int_rate  # each u64 operation counted as one lane operation
    timing = (cuda_ms(run_k, iters=50),
              device_kernel_ms(run_k, ("feature_extract_kernel",), iters=50),
              cuda_ms(lambda: feature_extract_plain(raw_main, valid_main, n_keys=cfg.n_sparse_keys,
                                                    n_slots=S, **seeds), iters=10),
              None, max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    sass = sass_static(build.library_path("feature_extract"), "feature_extract_kernel")
    line = (f"kernels (ingest shapes): feature_extract call_ms={timing[0]:.5f} "
            f"device_ms={timing[1]} plain_ms={timing[2]:.5f} library_ms=null "
            f"bound_ms={timing[4]:.6f} ({timing[5]}; bytes {t_bytes * 1e3:.6f} ms, "
            f"{FE_U64_OPS} u64 ops/valid position at {int_rate:.4g} lane ops/s "
            f"{t_ops * 1e3:.6f} ms) static_sass={sass}; "
            f"shape [{cfg.batch_size}, {P}] positions={n} valid={n_valid} "
            f"max_sm_clock_mhz={clock_mhz}; bitwise vs plain and vs numpy: {edge}")
    return timing, float(max_err), line


def grouped_lr_phase(seed: int, plain) -> str:
    """A few grouped train steps at TINY_HETERO (bag at widths 4 and 8) and
    LR steps at width 1 on the card through the kernels, against the same
    steps on the plain versions. Tolerance: losses rtol 1e-5; tables within
    1e-5 for 99% of the elements and every element within 2*lr per step
    (the plain bag sums with atomics in another order, and Adagrad's first
    step turns a gradient within rounding of zero into a step of either
    sign, as in the train phase)."""
    import numpy as np
    import torch

    from repro_torch.configs.ctr_models import TINY_HETERO as cfg
    from repro_torch.kernels import ops as kops
    from repro_torch.models import ctr as ctr_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.train_step import make_ctr_train_step_grouped

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    k, mb, nnz, lr = cfg.minibatches_per_batch, cfg.batch_size // cfg.minibatches_per_batch, \
        cfg.nnz_per_example, 0.05
    n_working = {g.name: 300 for g in cfg.groups}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    tables0 = {g.name: t((rng.normal(size=(300, g.emb_dim)) * 0.1).astype(np.float32))
               for g in cfg.groups}
    accums0 = {n: v.abs() for n, v in tables0.items()}
    g0 = torch.Generator().manual_seed(seed)
    tower0 = ctr_model.init_tower(cfg, g0, dev)
    batches = [{
        "labels": t((rng.random((k, mb)) < 0.3).astype(np.float32)),
        "inputs": {g.name: {
            "slot_ids": t(rng.integers(0, n_working[g.name], (k, mb, nnz)).astype(np.int32)),
            "slot_of": t(rng.integers(0, g.n_slots, (k, mb, nnz)).astype(np.int32)),
            "valid": t(rng.random((k, mb, nnz)) < 0.8)} for g in cfg.groups},
    } for _ in range(3)]
    lr_tab0 = t((rng.normal(size=(2000, 1)) * 0.1).astype(np.float32))
    lr_ids = t(rng.integers(0, 2000, (3, 256, 40)).astype(np.int32))
    lr_valid = t(rng.random((3, 256, 40)) < 0.7)
    lr_labels = t((rng.random((3, 256)) < 0.4).astype(np.float32))
    bias = torch.zeros((), device=dev)

    def drive():
        opt = AdamW(lr=1e-3)
        step = make_ctr_train_step_grouped(cfg, lr, opt)
        state = ({n: v.clone() for n, v in tower0.items()}, opt.init(tower0),
                 dict(tables0), dict(accums0))
        losses = []
        for b in batches:
            *state, m = step(*state, b)
            losses.append(float(m["loss"]))
        tab, acc = lr_tab0, torch.zeros_like(lr_tab0)
        for i in range(3):  # LR: one weight per feature, row-Adagrad on it
            w = tab.detach().requires_grad_()
            loss = ctr_model.lr_loss_fn(w, lr_ids[i], lr_valid[i], lr_labels[i], bias)
            (gw,) = torch.autograd.grad(loss, [w])
            tab, acc = kops.adagrad_update(tab, acc, gw, lr)
            losses.append(float(loss.detach()))
        return np.array(losses), {**state[2], "lr": tab}

    kops.reset_launch_counts()
    k_loss, k_tabs = drive()
    launches = kops.launch_counts()
    # per grouped mini-batch one bag, one scatter (its backward) and one
    # Adagrad per group; per LR step one of each
    want = 3 * k * len(cfg.groups) + 3
    check(all(launches[n] == want for n in ("embedding_bag", "scatter_add", "fused_adagrad")),
          f"grouped/LR launches {launches}, want {want} of each training kernel")
    with plain_kernels(*plain):
        p_loss, p_tabs = drive()
    check(kops.launch_counts() == launches, "the plain run launched a kernel")
    loss_rel = float(np.max(np.abs(p_loss - k_loss) / np.abs(k_loss)))
    diffs = {n: (k_tabs[n] - p_tabs[n]).abs() for n in k_tabs}
    n_el = sum(d.numel() for d in diffs.values())
    n_over = sum(int((d > 1e-5).sum()) for d in diffs.values())
    tab_err = max(float(d.max()) for d in diffs.values())
    check(np.isfinite(k_loss).all() and loss_rel <= 1e-5 and n_over <= 0.01 * n_el
          and tab_err <= 2 * lr * 3 * k,
          f"grouped/LR kernels vs plain: loss rel diff {loss_rel}, table max |diff| {tab_err}, "
          f"{n_over} of {n_el} elements beyond 1e-5")
    return (f"grouped: {cfg.name} widths={[g.emb_dim for g in cfg.groups]} 3 grouped steps x "
            f"{k} mini-batches + 3 LR steps at width 1, launches={launches}, losses="
            f"{k_loss.tolist()}; vs plain: loss rel diff {loss_rel:.3e}, table max |diff| "
            f"{tab_err:.3e}, {n_over} of {n_el} elements beyond 1e-5")


LM_ARCH = "yi-9b"
LM_BATCH, LM_PROMPT, LM_STEPS = 4, 2048, 32
# logits: max |diff| <= LM_TOL * max |ref|. Two prefills that differ only in
# the order of fp32 sums inside attention round some bf16 activations the
# other way, and 48 layers of random weights amplify those flips (2e-2 holds
# at the smoke configs' 2 layers); each phase prints that floor, the same
# prefill on two plain attention paths (naive vs blockwise), beside the
# kernel's error
LM_TOL = 5e-2
MOE_ARCH = "olmoe-1b-7b"
VLM_ARCH, VLM_LAYERS, VLM_IMAGE, VLM_STEPS = "pixtral-12b", 8, 256, 8


def kept_pairs(Sq: int, Skv: int, *, causal: bool, window: int, q_offset: int) -> int:
    """(query, key) pairs the attention mask keeps, for one (batch, head)."""
    import numpy as np

    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, Skv) if causal else np.full(Sq, Skv)
    lo = np.maximum(qpos - window + 1, 0) if window > 0 else np.zeros(Sq, dtype=np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def lm_check(name: str, got, want, tol: float = LM_TOL) -> float:
    """Finite, and max |got - want| <= tol * max |want|; returns the ratio."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    check(bool(torch.isfinite(got).all()) and err <= tol * scale,
          f"{name}: max |diff| {err} > {tol} * max |ref| {scale} (or not finite)")
    return err / scale


@contextlib.contextmanager
def swapped(module, **attrs):
    """Set ``module``'s attributes for the block (a plain run of the same
    path, or a capture of a kernel's inputs); restores them after."""
    saved = {name: getattr(module, name) for name in attrs}
    for name, value in attrs.items():
        setattr(module, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(module, name, value)


def serve_lm(cfg, base: Path, seed: int, *, batch: int, prompt: int, steps: int,
             n_image: int = 0):
    """The LM serving path on the card through the entry points a user
    calls, counted: publish a seeded fp32 ``tok_emb`` of all ``vocab`` keys to
    2 PS nodes, ServingEngine(device_hot_rows=16384), bf16 weights from a
    seeded CUDA generator, ``TokenStream`` prompts (and, for a VLM, seeded
    image embeddings first), then ``lookup_device`` -> prefill -> ``steps``
    greedy decode steps, each one ``lookup_device`` of the new tokens. The
    launch counts are zeroed just before and read just after. Returns what
    the phase's checks and timings need."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.convert import publish_arrays
    from repro_torch.core.tables import RowSchema, TableSpec
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_cuda
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import KVCache
    from repro_torch.serve import ServingCluster, ServingEngine
    from repro_torch.serve.serve_step import greedy_sample, make_decode_step, make_prefill_step

    dev = torch.device("cuda")
    B, S, V, d = batch, prompt, cfg.vocab_size, cfg.d_model
    spec = TableSpec("tok_emb", RowSchema.embedding(d))
    rows = np.random.default_rng(seed).standard_normal((V, d), dtype=np.float32)
    t0 = time.perf_counter()
    publish_arrays(str(base), n_nodes=2, dim=d,
                   tables={"tok_emb": (spec, np.arange(V, dtype=np.uint64), rows)})
    t_publish = time.perf_counter() - t0
    engine = ServingEngine(ServingCluster(str(base)), device_hot_rows=16384, device="cuda")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init(cfg, gen, dtype=torch.bfloat16)
    img = (torch.randn((B, n_image, d), generator=gen, device=dev, dtype=torch.float32)
           if n_image else None)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    prompts = TokenStream(V, B, S, seed=seed).next_batch()[:, :S].astype(np.uint64)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    slots_dev = lambda sl: torch.from_numpy(np.ascontiguousarray(sl)).to(dev)

    def batch_of(sl, wt_):
        out = {"tokens": slots_dev(sl), "working_table": wt_}
        if img is not None:
            out["image_embeds"] = img
        return out

    # ---- the main path, counted: lookup -> prefill -> greedy decode steps
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    slots, wt = engine.lookup_device("tok_emb", prompts)
    t_lookup_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch_of(slots, wt))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = kops.launch_counts()
    prefill_variants = dict(flash_attention_cuda.launches_by_variant)
    prefill_gmm_variants = dict(gmm_cuda.launches_by_variant)
    ctx = n_image + S
    cache = KVCache(*(F.pad(a, (0, 0, 0, steps)) for a in cache))
    tokens, step_s, lookup_s = [], [], []
    tok = greedy_sample(logits)
    first_logits = logits
    for i in range(steps):
        t0 = time.perf_counter()
        keys = tok.cpu().numpy().astype(np.uint64)
        t1 = time.perf_counter()
        s_i, wt_i = engine.lookup_device("tok_emb", keys)
        lookup_s.append(time.perf_counter() - t1)
        logits, cache = decode(params, {"token": slots_dev(s_i), "working_table": wt_i}, cache,
                               ctx + i)
        check(bool(torch.isfinite(logits).all()), f"{cfg.name} decode step {i}: non-finite")
        tok = greedy_sample(logits)
        tokens.append(tok)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = kops.launch_counts()
    gmm_variants = dict(gmm_cuda.launches_by_variant)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decoded = torch.cat(tokens, dim=1).cpu().numpy()
    decode_launches = {n: launches[n] - after_prefill[n] for n in launches}
    check(decoded.shape == (B, steps) and ((decoded >= 0) & (decoded < V)).all(),
          f"{cfg.name}: decoded tokens out of [0, {V}): {decoded.min()}..{decoded.max()}")
    uniq = np.unique(prompts)
    check(np.array_equal(uniq[slots], prompts)
          and np.array_equal(wt.cpu().numpy(), rows[uniq.astype(np.int64)]),
          f"{cfg.name}: working-table rows != published rows, bitwise")
    return types.SimpleNamespace(
        cfg=cfg, engine=engine, params=params, img=img, prompts=prompts, slots=slots, wt=wt,
        uniq=uniq, first_logits=first_logits, cache=cache, last=(s_i, wt_i), ctx=ctx,
        steps=steps, after_prefill=after_prefill, prefill_variants=prefill_variants,
        prefill_gmm_variants=prefill_gmm_variants, gmm_variants=gmm_variants,
        decode_launches=decode_launches,
        launches=launches, decoded=decoded, step_s=step_s, lookup_s=lookup_s,
        t_publish=t_publish, t_init=t_init, t_lookup_prefill=t_lookup_prefill,
        t_prefill=t_prefill, peak_gb=peak_gb, weights_gb=weights_gb, prefill=prefill,
        decode=decode, batch_of=batch_of, slots_dev=slots_dev)


def check_launches(run, per_prefill: dict, per_step: dict) -> None:
    """The counted run launched exactly these kernels: ``per_prefill`` in the
    prefill, ``per_step`` in each decode step, and no other; every
    flash_attention launch of the prefill took the wgmma + TMA kernel."""
    n_flash = per_prefill.get("flash_attention", 0)
    check(run.prefill_variants == {"hopper": n_flash, "simt": 0},
          f"{run.cfg.name} prefill flash_attention launches by kernel {run.prefill_variants}, "
          f"want all {n_flash} on the hopper kernel")
    want_decode = {n: run.steps * c for n, c in per_step.items()}
    for n, c in run.after_prefill.items():
        check(c == per_prefill.get(n, 0), f"{run.cfg.name} prefill launches "
              f"{run.after_prefill}, want {per_prefill} and no other kernel")
    for n, c in run.decode_launches.items():
        check(c == want_decode.get(n, 0), f"{run.cfg.name} decode launches "
              f"{run.decode_launches}, want {want_decode} over {run.steps} steps")


def plain_prefill(run, attn_impl: str, **plain):
    """The counted prefill again with ``attn_impl`` attention and the kernels
    named in ``plain`` (``ops`` attributes) on their plain versions."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serve.serve_step import make_prefill_step

    with swapped(kops, **plain):
        logits, _ = make_prefill_step(run.cfg, attn_impl=attn_impl)(
            run.params, run.batch_of(run.slots, run.wt))
    return logits


def decode_continuity(run, full=None) -> float:
    """Prefill all but the last prompt token, decode the last one, and hold
    its logits against the full prefill's (``full``, or a fresh kernel
    prefill): max |diff| / max |full|."""
    import torch.nn.functional as F

    from repro_torch.models.attention import KVCache

    if full is None:
        full, _ = run.prefill(run.params, run.batch_of(run.slots, run.wt))
    s_a, wt_a = run.engine.lookup_device("tok_emb", run.prompts[:, :-1])
    _, cache_a = run.prefill(run.params, run.batch_of(s_a, wt_a))
    cache_a = KVCache(*(F.pad(a, (0, 0, 0, 1)) for a in cache_a))
    s_b, wt_b = run.engine.lookup_device("tok_emb", run.prompts[:, -1:])
    cont, _ = run.decode(run.params, {"token": run.slots_dev(s_b), "working_table": wt_b},
                         cache_a, run.ctx - 1)
    return lm_check(f"{run.cfg.name} decode continuity (prefill {run.ctx - 1} + decode 1 vs "
                    f"prefill {run.ctx})", cont, full, tol=float("inf"))


def lm_logit_checks(run, *, continuity: bool = True, **plain) -> tuple[float, ...]:
    """The kernel prefill's last logits against the same prefill on plain
    attention (naive, and blockwise) with the plain versions in ``plain``,
    the plain-vs-plain floor (naive vs blockwise), and, where
    ``continuity``, decode continuity within ``LM_TOL``. Returns (vs naive,
    vs blockwise, floor, continuity or None), of the largest logit."""
    name = run.cfg.name
    naive = plain_prefill(run, "naive", **plain)
    rel_plain = lm_check(f"{name} prefill last logits, kernels vs plain naive attention",
                         run.first_logits, naive)
    block = plain_prefill(run, "blockwise", **plain)
    rel_block = lm_check(f"{name} prefill last logits, kernels vs plain blockwise attention",
                         run.first_logits, block)
    rel_floor = float((block - naive).abs().max() / naive.abs().max())
    rel_cont = None
    if continuity:
        rel_cont = decode_continuity(run, run.first_logits)
        check(rel_cont <= LM_TOL, f"{name} decode continuity {rel_cont} > {LM_TOL} of max |logit|")
    return rel_plain, rel_block, rel_floor, rel_cont


def lm_lines(name: str, run, checks: tuple[float, ...], kernels: tuple[str, ...]) -> list[str]:
    """The phase's summary line and its torch.profiler breakdown of one warm
    prefill and one decode step (without its lookup_device)."""
    import numpy as np
    import torch

    cfg = run.cfg
    B, S = run.prompts.shape
    t0 = time.perf_counter()
    run.prefill(run.params, run.batch_of(run.slots, run.wt))
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    pre_wall, pre_dev, pre_top = device_breakdown(
        lambda: run.prefill(run.params, run.batch_of(run.slots, run.wt)))
    s_i, wt_i = run.last
    dec_wall, dec_dev, dec_top = device_breakdown(
        lambda: run.decode(run.params, {"token": run.slots_dev(s_i), "working_table": wt_i},
                           run.cache, run.ctx + run.steps - 1))
    steady = run.step_s[1:]
    rel_plain, rel_block, rel_floor, rel_cont = checks
    cont = "" if rel_cont is None else f", decode continuity {rel_cont:.3e}"
    img = "" if run.img is None else f"image_embeds={tuple(run.img.shape)} "
    moe = f"experts={cfg.n_experts}/top{cfg.top_k} " if cfg.is_moe else ""
    tokens = B * run.ctx
    return [
        f"{name}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} Dh={cfg.resolved_head_dim} d_ff={cfg.d_ff} {moe}"
        f"vocab={cfg.vocab_size} "
        f"weights_bf16_gb={run.weights_gb:.3f} init_s={run.t_init:.2f} "
        f"publish_s={run.t_publish:.2f} ({cfg.vocab_size}x{cfg.d_model} fp32) batch={B} "
        f"{img}prompt={S} n_working={run.wt.shape[0]} lookup_device_host_ms prefill="
        f"{run.t_lookup_prefill * 1e3:.3f} decode_mean={np.mean(run.lookup_s) * 1e3:.3f} "
        f"prefill_ms cold={run.t_prefill * 1e3:.1f} warm={t_warm * 1e3:.1f} "
        f"prefill_tokens_per_s cold={tokens / run.t_prefill:.1f} warm={tokens / t_warm:.1f} "
        f"decode_ms_per_step first={run.step_s[0] * 1e3:.2f} "
        f"steady_mean={np.mean(steady) * 1e3:.2f} decode_tokens_per_s={B / np.mean(steady):.1f} "
        f"peak_mem_gb={run.peak_gb:.2f} launches prefill="
        f"{ {n: run.after_prefill[n] for n in kernels} } per decode step="
        f"{ {n: run.decode_launches[n] / run.steps for n in kernels} } "
        f"vs plain attention naive {rel_plain:.3e} blockwise {rel_block:.3e}{cont} (of max "
        f"|logit|, tol {LM_TOL}; plain naive vs plain blockwise {rel_floor:.3e}) "
        f"decoded[0][:8]={run.decoded[0][:8].tolist()}",
        f"{name} breakdown (torch.profiler, one call each): prefill wall_ms={pre_wall:.1f} "
        f"kernels_ms={pre_dev:.1f} busy={pre_dev / pre_wall:.3f} top={pre_top}; decode step "
        f"without lookup_device wall_ms={dec_wall:.1f} kernels_ms={dec_dev:.1f} "
        f"busy={dec_dev / dec_wall:.3f} top={dec_top}",
    ]


def release(run) -> None:
    """Free a phase's weights and caches on the card."""
    import torch

    for name in ("params", "img", "cache", "wt", "first_logits", "last", "engine"):
        setattr(run, name, None)
    torch.cuda.empty_cache()


FLASH_EDGE = [
    # B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset
    (1, 8, 1, 200, 200, 16, True, 0, 0),  # MQA, tails
    (2, 4, 4, 130, 300, 96, True, 0, 170),  # rep 1, Dh 96, q_offset > 0, Sq < Skv
    (1, 32, 4, 1, 777, 128, True, 0, 776),  # Sq = 1, rep 8
    (2, 8, 1, 257, 257, 64, True, 100, 0),  # window, tails
    (1, 4, 2, 64, 300, 256, False, 0, 0),  # Dh 256, not causal
    (1, 3, 1, 33, 65, 9, True, 0, 32),  # odd Dh
    (1, 2, 1, 4, 16, 8, True, 4, 30),  # rows that keep no key -> 0
]


# bf16 cases for the wgmma + TMA kernel beyond FLASH_EDGE, each also through
# the SIMT kernel: the head dims the zoo has besides 128
FLASH_HOPPER_EDGE = [
    # name, B, H, Hkv, Sq, Skv, Dh, causal, window, q_offset
    ("Dh64", 2, 8, 2, 333, 333, 64, True, 0, 0),
    ("Dh96", 1, 32, 32, 300, 300, 96, True, 0, 0),  # phi3-mini: 32 heads of 96
    ("Dh192", 1, 8, 1, 300, 400, 192, True, 0, 100),
    ("Dh256", 1, 8, 4, 257, 257, 256, True, 64, 0),
]
# prefill shapes of other models, checked against the plain version and timed
# beside SDPA: OLMoE-1B-7B's (the MoE phase's attention), a hymba-like sliding
# window (25 heads over 5 KV heads, Dh 64, window 1024) and a whisper-like
# encoder (6 heads of 64, not causal, 1500 frames)
FLASH_SHAPES = [
    # name, B, H, Hkv, S, Dh, causal, window
    ("olmoe_prefill", 4, 16, 16, 2048, 128, True, 0),
    ("hymba_window", 4, 25, 5, 2048, 64, True, 1024),
    ("whisper_encoder", 4, 6, 6, 1500, 64, False, 0),
]


def flash_case(label: str, q, k, v, want_variant: str, variant=None, **kw) -> float:
    """One flash_attention launch against the plain version (fp32 within
    2e-5, bf16 within rtol 2^-6 and atol 2e-5), checking that it took
    ``want_variant``'s kernel. Returns max |kernel - plain|."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain

    before = dict(flash_attention_cuda.launches_by_variant)
    got = flash_attention_cuda(q, k, v, variant=variant, **kw)
    took = [n for n, c in flash_attention_cuda.launches_by_variant.items() if c != before[n]]
    check(took == [want_variant], f"flash_attention {label}: launched {took}, want "
          f"[{want_variant}]")
    want = flash_attention_plain(q, k, v, **kw)
    tol = (dict(rtol=2e-5, atol=2e-5) if q.dtype == torch.float32
           else dict(rtol=2**-6, atol=2e-5))
    check(got.dtype == q.dtype and torch.allclose(got.float(), want.float(), **tol),
          f"flash_attention {label} {q.dtype} on the {want_variant} kernel != plain")
    return float((got.float() - want.float()).abs().max())


def lm_phase(base: Path, seed: int) -> tuple[dict, dict, dict, dict, list[str]]:
    """LM serving at Yi-9B's published widths on the card. Returns (timing,
    max_abs_err, main-path launches, flash_attention's two kernels, lines)
    for embedding_lookup and flash_attention."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_lookup import embedding_lookup_cuda, embedding_lookup_plain
    from repro_torch.kernels.flash_attention import (
        attention_mask,
        flash_attention_cuda,
        flash_attention_plain,
        flash_variant,
    )

    dev = torch.device("cuda")
    cfg = get_config(LM_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.d_ff, cfg.vocab_size, cfg.embedding_mode)
          == (48, 4096, 32, 4, 128, 11008, 64000, "hier_ps"), f"unexpected yi-9b widths {cfg}")
    B, S, d = LM_BATCH, LM_PROMPT, cfg.d_model
    run = serve_lm(cfg, base, seed, batch=B, prompt=S, steps=LM_STEPS)
    L, H, Hkv, Dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    check_launches(run, {"embedding_lookup": 1, "flash_attention": L}, {"embedding_lookup": 1})

    # ---- checks off the counted path; layer 0's real q/k/v from the plain run
    captured = {}
    real_attention = kops.attention

    def capture(q, k, v, **kw):
        captured.setdefault("qkv", (q.contiguous(), k.contiguous(), v.contiguous()))
        return real_attention(q, k, v, **kw)

    with swapped(kops, attention=capture):
        checks = lm_logit_checks(run)

    # ---- the kernels against their plain versions
    q, k, v = captured["qkv"]
    check(q.shape == (B, H, S, Dh) and k.shape == (B, Hkv, S, Dh) and q.dtype == torch.bfloat16,
          f"layer 0 q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    err = {"flash_attention": flash_case("layer 0", q, k, v, "hopper")}
    simt_err = flash_case("layer 0", q, k, v, "simt", variant="simt")
    edge = []
    g = torch.Generator().manual_seed(seed)
    for case in FLASH_EDGE:
        Bc, Hc, Hkc, Sq, Skv, Dc, causal, window, qoff = case
        for dt in (torch.float32, torch.bfloat16):
            mk = lambda *shape: torch.randn(shape, generator=g).to(dev, dt)
            qc, kc, vc = mk(Bc, Hc, Sq, Dc), mk(Bc, Hkc, Skv, Dc), mk(Bc, Hkc, Skv, Dc)
            kw = dict(causal=causal, window=window, q_offset=qoff)
            rule = flash_variant(qc, kc, vc)
            flash_case(f"edge case {case}", qc, kc, vc, rule, **kw)
            if rule == "hopper":  # and the same inputs through the other kernel
                flash_case(f"edge case {case}", qc, kc, vc, "simt", variant="simt", **kw)
            edge.append(f"{Hc}/{Hkc}x{Sq}x{Skv}xDh{Dc}{'c' if causal else ''}w{window}o{qoff}"
                        f"{'f32' if dt == torch.float32 else 'bf16'}:"
                        f"{'hopper+simt' if rule == 'hopper' else 'simt'}")
    mk = lambda *shape: torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    for name, Bc, Hc, Hkc, Sq, Skv, Dc, causal, window, qoff in FLASH_HOPPER_EDGE:
        qc, kc, vc = mk(Bc, Hc, Sq, Dc), mk(Bc, Hkc, Skv, Dc), mk(Bc, Hkc, Skv, Dc)
        kw = dict(causal=causal, window=window, q_offset=qoff)
        flash_case(name, qc, kc, vc, "hopper", **kw)
        flash_case(name, qc, kc, vc, "simt", variant="simt", **kw)
        edge.append(f"{name}_bf16:hopper+simt")
    kvp = mk(2, 300, 2, 2, 128)  # q as the model makes it, k and v views of one tensor
    flash_case("strided views", mk(2, 300, 8, 128).transpose(1, 2), kvp[:, :, 0].transpose(1, 2),
               kvp[:, :, 1].transpose(1, 2), "hopper")
    edge.append("strided_q_k_v_views_bf16:hopper")
    wt = run.wt
    ids = run.slots_dev(run.slots.reshape(-1).astype(np.int32))
    for dt in (torch.float32, torch.bfloat16):
        tbl = wt.to(dt)
        check(torch.equal(embedding_lookup_cuda(tbl, ids), embedding_lookup_plain(tbl, ids)),
              f"embedding_lookup at the prefill's shape, {dt}: kernel != plain")
    err["embedding_lookup"] = 0.0
    odd = torch.randn(3000, 4103, generator=g).to(dev)
    odd_ids = torch.randint(0, 2999, (999,), generator=g, dtype=torch.int32).to(dev)
    for name, view in (("odd_D=4102_offset_1", odd[:, 1:]), ("odd_D=7", odd[1:, 5:12]),
                       ("bf16_odd_D=4101", odd.to(torch.bfloat16)[:2999, 2:])):
        check(torch.equal(embedding_lookup_cuda(view, odd_ids), view[odd_ids.long()]),
              f"embedding_lookup {name}")
        edge.append(name)

    # ---- times at the main path's shapes (after the counted run)
    run_fa = lambda: flash_attention_cuda(q, k, v)
    pairs = B * H * kept_pairs(S, S, causal=True, window=0, q_offset=0)
    fa = (cuda_ms(run_fa, iters=20, warmup=3),
          device_kernel_ms(run_fa, ("flash_attention_hopper_kernel",), iters=20),
          cuda_ms(lambda: flash_attention_plain(q, k, v), iters=3, warmup=1),
          cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True), iters=20),
          *bound_ms(nbytes=2.0 * (2 * q.numel() + k.numel() + v.numel()),
                    flops=4.0 * Dh * pairs, peak=BF16_FLOPS))
    check(bool(fa[1]), "the profiler saw no flash_attention_hopper_kernel device time")
    run_simt = lambda: flash_attention_cuda(q, k, v, variant="simt")
    simt_dev = device_kernel_ms(run_simt, ("flash_attention_simt_kernel",), iters=5)
    check(bool(simt_dev), "the profiler saw no flash_attention_simt_kernel device time")
    variants = {
        "hopper": {"launches": run.prefill_variants["hopper"], "ms": sum(fa[1].values()),
                   "max_abs_err": err["flash_attention"]},
        "simt": {"launches": run.prefill_variants["simt"], "ms": sum(simt_dev.values()),
                 "max_abs_err": simt_err},
    }
    shape_parts = []
    for name, Bc, Hc, Hkc, Sc, Dc, causal, window in FLASH_SHAPES:
        qs, ks, vs = mk(Bc, Hc, Sc, Dc), mk(Bc, Hkc, Sc, Dc), mk(Bc, Hkc, Sc, Dc)
        kw = dict(causal=causal, window=window)
        e_s = flash_case(name, qs, ks, vs, "hopper", **kw)
        call = lambda: flash_attention_cuda(qs, ks, vs, **kw)
        dev_ms = device_kernel_ms(call, ("flash_attention_hopper_kernel",), iters=20)
        check(bool(dev_ms), f"{name}: the profiler saw no flash_attention_hopper_kernel time")
        if window:  # SDPA has no window: an explicit mask
            mask = attention_mask(Sc, Sc, causal=causal, window=window, q_offset=0, device=dev)
            sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                          enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                          enable_gqa=True)
        sdpa_ms = cuda_ms(sdpa, iters=20)
        sdpa_kernel = top_device_kernel(sdpa)
        kept = Bc * Hc * kept_pairs(Sc, Sc, causal=causal, window=window, q_offset=0)
        b_ms, b_by = bound_ms(nbytes=2.0 * (2 * qs.numel() + ks.numel() + vs.numel()),
                              flops=4.0 * Dc * kept, peak=BF16_FLOPS)
        variants["hopper"].setdefault("shapes", {})[name] = {
            "ms": sum(dev_ms.values()), "bound_ms": b_ms, "library_ms": sdpa_ms}
        shape_parts.append(
            f"{name} q {tuple(qs.shape)} kv {tuple(ks.shape)} causal={causal} window={window} "
            f"kept pairs {kept}: device_ms={sum(dev_ms.values()):.5f} call_ms="
            f"{cuda_ms(call, iters=20):.5f} bound_ms={b_ms:.6f} ({b_by}) sdpa_ms={sdpa_ms:.5f} "
            f"(kernel {sdpa_kernel!r}) max|kernel-plain|={e_s:.3e}")
        del qs, ks, vs
    run_el = lambda: embedding_lookup_cuda(wt, ids)
    ids64 = ids.long()
    el = (cuda_ms(run_el, iters=50),
          device_kernel_ms(run_el, ("lookup_kernel",), iters=50),
          cuda_ms(lambda: embedding_lookup_plain(wt, ids), iters=50),
          cuda_ms(lambda: F.embedding(ids64, wt), iters=50),
          *bound_ms(nbytes=ids.numel() * 4 + (len(run.uniq) + ids.numel()) * d * 4, flops=0.0))
    s_i, wt_i = run.last
    dec_ids = run.slots_dev(s_i.reshape(-1).astype(np.int32))  # the last decode step's
    el_decode = device_kernel_ms(lambda: embedding_lookup_cuda(wt_i, dec_ids),
                                 ("lookup_kernel",), iters=50)
    kernels = ("embedding_lookup", "flash_attention")
    lines = lm_lines("lm", run, checks, kernels)
    timing = {"embedding_lookup": el, "flash_attention": fa}
    main = {n: run.launches[n] for n in kernels}
    fmt = lambda x: "null" if x is None else f"{x:.5f}"
    lines.append(
        "kernels (LM shapes): "
        + "; ".join(f"{n} launches={main[n]} call_ms={t[0]:.5f} device_ms={t[1]} "
                    f"plain_ms={t[2]:.5f} library_ms={fmt(t[3])} bound_ms={t[4]:.6f} ({t[5]})"
                    for n, t in timing.items())
        + f"; embedding_lookup decode-step device_ms={el_decode}; flash shape q {tuple(q.shape)} "
        f"kv {tuple(k.shape)} bf16 causal, kept pairs {pairs}; lookup ids {ids.numel()} "
        f"unique rows {len(run.uniq)} D={d} fp32; layer-0 flash max|kernel-plain| hopper="
        f"{err['flash_attention']:.3e} simt={simt_err:.3e}; flash simt kernel at the same shape "
        f"device_ms={sum(simt_dev.values()):.5f}; prefill flash launches by kernel "
        f"{run.prefill_variants}; edge cases passed: {edge}")
    lines.append("flash shapes (hopper kernel vs SDPA): " + "; ".join(shape_parts))
    del q, k, v, wt, wt_i, captured
    release(run)
    return timing, err, main, variants, lines


GMM_EDGE = [
    # E, K, N, group sizes, rows past the last group
    (4, 128, 128, [100, 0, 300, 56], 0),  # the reference's test shapes
    (5, 128, 256, [7, 250, 1, 0, 130], 0),  # groups of 1, empty groups
    (5, 100, 72, [7, 250, 1, 0, 130], 0),  # K and N that do not tile (wmma)
    (3, 9, 13, [1, 1, 1], 0),  # odd K and N below a tile (wmma)
    (4, 64, 48, [10, 0, 20, 5], 37),  # rows past the last group -> 0
    (6, 136, 264, [1, 65, 0, 200, 64, 129], 5),  # hopper: K, N tails, tiles ending mid-box
]


def gmm_close(name: str, got, want) -> float:
    """The kernel against its plain version: fp32 within atol and rtol 2e-4
    (the reference's test_gmm_vs_ref); bf16 within rtol 2^-6 (one bf16 ulp,
    doubled: both round an fp32 sum taken in another order) and atol 1e-4 of
    the largest output. Returns max |diff|."""
    import torch

    if want.dtype == torch.float32:
        tol = dict(rtol=2e-4, atol=2e-4)
    else:
        tol = dict(rtol=2**-6, atol=1e-4 * float(want.float().abs().max()))
    check(got.dtype == want.dtype and got.shape == want.shape
          and bool(torch.isfinite(got).all())
          and torch.allclose(got.float(), want.float(), **tol), f"moe_gmm {name}: kernel != plain")
    return float((got.float() - want.float()).abs().max())


def grouped_mm_call(x, w, gs):
    """The library yardstick of a ragged grouped product: PyTorch's
    ``torch._grouped_mm`` (bf16, sm90) with the groups' end offsets, where
    this build has it and it takes these operands; else None."""
    import torch

    from repro_torch.kernels.moe_gmm import gmm_plain

    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    offs = torch.cumsum(gs.to(torch.int32), 0, dtype=torch.int32)
    live = x[: int(gs.sum())]  # the rows the groups cover
    call = lambda: fn(live, w, offs=offs)
    try:
        gmm_close("torch._grouped_mm yardstick", call(), gmm_plain(live, w, gs))
    except (RuntimeError, TypeError, ValueError) as e:
        print(f"# torch._grouped_mm not usable here: {type(e).__name__}: {str(e)[:160]}",
              flush=True)
        return None
    return call


def moe_phase(base: Path, seed: int) -> tuple[dict, dict, dict, dict, list[str]]:
    """MoE serving at OLMoE-1B-7B's published widths and depth on the card.
    Returns (timing, max_abs_err, main-path launches, moe_gmm's kernels,
    lines) for moe_gmm."""
    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.moe_gmm import TILE_ROWS, gmm_cuda, gmm_plain, gmm_tiles
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T

    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
           cfg.d_ff, cfg.vocab_size, cfg.n_experts, cfg.top_k, cfg.capacity_factor,
           cfg.embedding_mode)
          == (16, 2048, 16, 16, 128, 1024, 50304, 64, 8, 1.25, "hier_ps"),
          f"unexpected olmoe-1b-7b widths {cfg}")
    B, S, L, E, k = LM_BATCH, LM_PROMPT, cfg.n_layers, cfg.n_experts, cfg.top_k
    run = serve_lm(cfg, base, seed, batch=B, prompt=S, steps=LM_STEPS)
    check_launches(run, {"embedding_lookup": 1, "flash_attention": L, "moe_gmm": 3 * L},
                   {"embedding_lookup": 1, "moe_gmm": 3 * L})
    n_gmm = 3 * L * (1 + run.steps)
    check(run.prefill_gmm_variants == {"hopper": 3 * L, "wmma": 0, "f32": 0}
          and run.gmm_variants == {"hopper": n_gmm, "wmma": 0, "f32": 0},
          f"moe_gmm launches by kernel: prefill {run.prefill_gmm_variants}, whole run "
          f"{run.gmm_variants}, want all {n_gmm} on the hopper kernel")

    @contextlib.contextmanager
    def capture(store):
        """Record every routing, the first moe_block input and the first
        three ops.gmm calls (a layer's wi, wg and wo products)."""
        real_route, real_block, real_gmm = moe_mod.route, moe_mod.moe_block, kops.gmm

        def route(*a, **kw):
            store.setdefault("routes", []).append(real_route(*a, **kw))
            return store["routes"][-1]

        def block(x, p, *a, **kw):
            store.setdefault("block", (x, p))
            return real_block(x, p, *a, **kw)

        def gmm(x, w, gs, *, tiles=None):
            if len(store.setdefault("gmm", [])) < 3:
                store["gmm"].append((x, w, gs, tiles))
            return real_gmm(x, w, gs, tiles=tiles)

        with swapped(moe_mod, route=route, moe_block=block), swapped(kops, gmm=gmm):
            yield store

    # ---- off the counted path: a kernel prefill capturing every layer's
    # routing and layer 0's real moe_block input and gmm operands; the fully
    # plain prefill (plain attention, gmm_plain, embedding_lookup_plain) and
    # decode continuity, capturing the plain prefill's routings
    with capture({}) as kstore:
        plain_prefill(run, "auto")
    with capture({}) as pstore:
        checks = lm_logit_checks(run, continuity=False, gmm=gmm_plain,
                                 embedding_lookup=embedding_lookup_plain)
    # decode continuity. Capacity dispatch makes a token's output depend on
    # the batch it is routed with: the full prefill (G 32, C 40), the prefill
    # of all but the last token (G 4, C 320) and a decode step (G 4, C 8)
    # drop different assignments, so the three compute different functions
    # wherever a capacity overflows (in the reference as well). Checked with a
    # capacity no group can overflow, where they compute the same function;
    # printed at the configured capacity
    cont_capacity = decode_continuity(run, run.first_logits)
    no_drop = lambda cfg_, n_tokens, groups=1: max(8, -(-n_tokens // groups))
    with swapped(moe_mod, expert_capacity=no_drop):
        rel_cont = decode_continuity(run)
    check(rel_cont <= LM_TOL, f"decode continuity without drops {rel_cont} > {LM_TOL}")
    checks = checks[:3] + (rel_cont,)
    # tokens whose top-k expert set differs between the kernel and the plain
    # prefill, per layer: a near tie in the router flips on other roundings
    flips = [int((kr.top_i.sort(dim=-1).values != pr.top_i.sort(dim=-1).values).any(dim=-1).sum())
             for kr, pr in zip(kstore["routes"], pstore["routes"][:L])]
    check(len(kstore["routes"]) == L and len(flips) == L, f"{len(flips)} routings, want {L}")

    # ---- moe_gmm against its plain version on layer 0's real operands: the
    # compacted buffer of the main path, and the reference's capacity layout
    (buf, wi, gs, tiles), (_, wg, _, _), (h, wo, _, _) = kstore["gmm"]
    r0 = kstore["routes"][0]
    G, C = r0.groups, r0.capacity
    n_live = int(gs.sum())
    check(tuple(buf.shape) == (r0.n_rows, cfg.d_model) == (B * S * k, cfg.d_model)
          and buf.dtype == torch.bfloat16 and tuple(h.shape) == (r0.n_rows, cfg.d_ff)
          and (G, C) == (32, 40) and torch.equal(gs, r0.expert_rows)
          and n_live == int(r0.keep.sum())
          and torch.equal(tiles, gmm_tiles(gs, r0.n_rows, TILE_ROWS[torch.bfloat16])),
          f"layer 0 compacted buffer {tuple(buf.shape)} {buf.dtype}, G={G} C={C}, "
          f"{n_live} live rows")
    err = {"moe_gmm": 0.0}
    for n, (x, w, g_, t_) in zip(("wi", "wg", "wo"), kstore["gmm"]):
        got = gmm_cuda(x, w, g_)
        err["moe_gmm"] = max(err["moe_gmm"],
                             gmm_close(f"layer 0 {n}", got, gmm_plain(x, w, g_)))
        check(torch.equal(gmm_cuda(x, w, g_, tiles=t_), got), f"layer 0 {n}: tiles= changed bits")
    mx, mp = kstore["block"]
    xf = mx.reshape(-1, cfg.d_model)
    pad_rows = E * G * C
    pad_gs = torch.full((E,), G * C, dtype=torch.int32, device=dev)
    pbuf = torch.zeros((pad_rows + 1, cfg.d_model), dtype=torch.bfloat16, device=dev)
    pbuf[r0.slot] = xf.repeat_interleave(k, dim=0).to(torch.bfloat16)
    pbuf = pbuf[:pad_rows]
    check(torch.equal(pbuf[r0.slot[r0.keep]], buf[r0.row[r0.keep]]),
          "padded and compacted buffers hold other rows")
    p_hop, p_plain = gmm_cuda(pbuf, wi, pad_gs), gmm_plain(pbuf, wi, pad_gs)
    p_wmma = gmm_cuda(pbuf, wi, pad_gs, variant="wmma")
    err["moe_gmm"] = max(err["moe_gmm"], gmm_close("padded wi, hopper", p_hop, p_plain))
    wmma_err = gmm_close("padded wi, wmma", p_wmma, p_plain)
    same_rows = torch.equal(p_hop[r0.slot[r0.keep]], gmm_cuda(buf, wi, gs)[r0.row[r0.keep]])
    # one moe_block on layer 0's real input: compacted (the main path) against
    # the capacity layout, both through the hopper kernel (the same products
    # of the same rows), and against the plain version; the plain version
    # differs by the products' roundings: each within one bf16 ulp, and wo's
    # inputs carry wi's and wg's differences, so atol 2^-7 of the largest
    out_k, aux_k = moe_mod.moe_block(mx, mp, cfg)
    out_pad = moe_mod.run_experts(xf, mp, cfg, r0, r0.slot, pad_rows, pad_gs)
    out_pad = out_pad.reshape(out_k.shape)
    layout_bitwise = bool(torch.equal(out_k, out_pad))
    layout_err = gmm_close("moe_block compacted vs capacity layout", out_k, out_pad)
    with swapped(kops, gmm=gmm_plain):
        out_p, aux_p = moe_mod.moe_block(mx, mp, cfg)
    scale = float(out_p.float().abs().max())
    blk_err = float((out_k.float() - out_p.float()).abs().max())
    check(bool(torch.isfinite(out_k).all()) and float(aux_k) == float(aux_p)
          and torch.allclose(out_k.float(), out_p.float(), rtol=2**-6, atol=2**-7 * scale),
          f"moe_block on layer 0's input, kernel vs plain: max |diff| {blk_err} of {scale}")
    # a tied router on the card at OLMoE's smoke widths: with a zero router
    # every expert ties, and the routing takes the lowest expert indices
    # first (jax.lax.top_k's order), through moe_block and the kernel
    scfg = get_smoke_config(MOE_ARCH)
    sgen = torch.Generator(device=dev).manual_seed(seed)
    sp = dict(T.init(scfg, sgen, dtype=torch.bfloat16)["layers"]["moe"])
    sp = {n: t[0] for n, t in sp.items()}  # layer 0
    sp["router"] = torch.zeros_like(sp["router"])
    sx = torch.randn((2, 64, scfg.d_model), generator=sgen, device=dev).to(torch.bfloat16)
    with capture({}) as tstore:
        tie_out, _ = moe_mod.moe_block(sx, sp, scfg)
    tie_i = tstore["routes"][0].top_i
    check(bool(torch.isfinite(tie_out).all()) and tstore["gmm"]
          and torch.equal(tie_i, torch.arange(scfg.top_k, device=dev).expand_as(tie_i)),
          f"tied router: routing {tie_i[:2].tolist()}..., want experts "
          f"{list(range(scfg.top_k))} for every token")
    dropped = float((~r0.keep).float().mean())
    live = [int(r.expert_rows.sum()) for r in kstore["routes"]]  # kept rows per layer
    load = torch.bincount(r0.top_i.reshape(-1), minlength=E)
    edge = []
    g = torch.Generator().manual_seed(seed)
    for case in GMM_EDGE:
        Ec, K, N, sizes, extra = case
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(sum(sizes) + extra, K, generator=g).to(dev, dt)
            w = (torch.randn(Ec, K, N, generator=g) * 0.1).to(dev, dt)
            gsc = torch.tensor(sizes, dtype=torch.int32, device=dev)
            got = gmm_cuda(x, w, gsc)
            gmm_close(f"edge {case} {dt}", got, gmm_plain(x, w, gsc))
            check(extra == 0 or not bool(got[sum(sizes):].any()), f"rows past groups {case}")
            edge.append(f"E{Ec}K{K}N{N}{sizes}+{extra}{'f32' if dt == torch.float32 else 'bf16'}")
    xb = torch.randn(130, 67, generator=g).to(dev, torch.bfloat16)
    wb = (torch.randn(2, 5, 64, 99, generator=g) * 0.1).to(dev, torch.bfloat16)
    sizes = torch.tensor([33, 0, 90, 1, 6])
    for name, x, w in (("x_col_offset3_w_N_offset3", xb[:, 3:], wb[1, :, :, 3:]),
                       ("x_col_offset3", xb[:, 3:], wb[1, :, :, :96]),
                       ("w_N_offset3", xb[:, :64].contiguous(), wb[0, :, :, 3:])):
        before = gmm_cuda.launches_by_variant["wmma"]
        gmm_close(name, gmm_cuda(x, w, sizes), gmm_plain(x, w, sizes))
        check(gmm_cuda.launches_by_variant["wmma"] == before + 1, f"{name} did not take wmma")
        edge.append(name)

    # ---- times at the path's shapes: the prefill's layer-0 wi product
    # (compacted, and in the capacity layout), and a decode step's, captured
    # from one decode step off the counted path
    s_i, wt_i = run.last
    with capture({}) as dstore:
        run.decode(run.params, {"token": run.slots_dev(s_i), "working_table": wt_i}, run.cache,
                   run.ctx + run.steps - 1)
    dx, dw, dgs, dtiles = dstore["gmm"][0]
    check(tuple(dx.shape) == (B * k, cfg.d_model), f"decode buffer {tuple(dx.shape)}")
    err["moe_gmm"] = max(err["moe_gmm"], gmm_close("decode step wi", gmm_cuda(dx, dw, dgs),
                                                    gmm_plain(dx, dw, dgs)))

    def times(x, w, gs_, *, variant="hopper", library=None, tiles_=None):
        """(call ms, device ms, plain ms, library ms, bound ms, bound by) of
        one product; the bound counts the live rows and the weights of the
        experts that hold rows."""
        K, N = x.shape[1], w.shape[2]
        rows, hit = int(gs_.sum()), int((gs_ > 0).sum())
        call = lambda: gmm_cuda(x, w, gs_, tiles=tiles_, variant=variant)
        kernel = "gmm_hopper_kernel" if variant == "hopper" else "gmm_bf16_kernel"
        return (cuda_ms(call, iters=20), device_kernel_ms(call, (kernel,), iters=20),
                cuda_ms(lambda: gmm_plain(x, w, gs_), iters=3, warmup=1),
                None if library is None else cuda_ms(library, iters=20),
                *bound_ms(nbytes=2.0 * (rows * K + hit * K * N + rows * N),
                          flops=2.0 * rows * K * N, peak=BF16_FLOPS))

    bmm = lambda: torch.bmm(pbuf.view(E, G * C, -1), wi)
    t_pad = times(pbuf, wi, pad_gs, library=bmm)
    t_pad_wmma = times(pbuf, wi, pad_gs, variant="wmma", library=bmm)
    t_pre = times(buf, wi, gs, library=grouped_mm_call(buf, wi, gs), tiles_=tiles)
    t_dec = times(dx, dw, dgs, library=grouped_mm_call(dx, dw, dgs), tiles_=dtiles)
    plan_ms = cuda_ms(lambda: gmm_tiles(gs, r0.n_rows, TILE_ROWS[torch.bfloat16]), iters=50)
    lines = lm_lines("moe", run, checks, ("embedding_lookup", "flash_attention", "moe_gmm"))
    fmt = lambda t: (f"call_ms={t[0]:.5f} device_ms={t[1]} plain_ms={t[2]:.5f} library_ms="
                     f"{'null' if t[3] is None else f'{t[3]:.5f}'} bound_ms={t[4]:.6f} ({t[5]})")
    lines.append(
        f"kernels (MoE shapes): moe_gmm launches={run.launches['moe_gmm']} by kernel "
        f"{run.gmm_variants}; prefill layer 0 wi compacted [{buf.shape[0]}x{buf.shape[1]}, "
        f"{n_live} live rows] x [{E}x{wi.shape[1]}x{wi.shape[2]}] hopper {fmt(t_pre)} "
        f"(library: torch._grouped_mm); capacity layout [{pbuf.shape[0]}x{pbuf.shape[1]}] "
        f"hopper {fmt(t_pad)} wmma {fmt(t_pad_wmma)} (library: torch.bmm); decode step "
        f"[{dx.shape[0]}x{dx.shape[1]}, {int(dgs.sum())} live rows, {int((dgs > 0).sum())} "
        f"experts] hopper {fmt(t_dec)}; tile plan (gmm_tiles, once per layer) call_ms="
        f"{plan_ms:.5f}; max|kernel-plain| (layer 0 wi, wg, wo; padded wi; decode wi)="
        f"{err['moe_gmm']:.3e}, wmma padded wi {wmma_err:.3e}; layer 0 wi rows hopper "
        f"compacted == capacity layout bitwise: {same_rows}; moe_block layer 0 compacted vs "
        f"capacity layout (both hopper) bitwise={layout_bitwise} max|diff|={layout_err:.3e}; "
        f"kernel vs plain max|diff|={blk_err:.3e} of max {scale:.3e}, "
        f"tied (zero) router at smoke widths routes to experts {tie_i[0].tolist()}, "
        f"dropped share={dropped:.5f}, kept rows per layer {live}, largest expert load="
        f"{int(load.max())} of "
        f"{r0.top_i.numel()} assignments (capacity {G}x{C}), aux={float(aux_k):.5f}; "
        f"tokens whose top-{cfg.top_k} set differs, kernel vs plain prefill, per layer: "
        f"{flips}; decode continuity at the configured capacity (unchecked) "
        f"{cont_capacity:.3e}, without capacity drops (checked) {rel_cont:.3e}; "
        f"edge cases passed: {edge}")
    timing = {"moe_gmm": t_pre}
    main = {"moe_gmm": run.launches["moe_gmm"]}
    dev_ms = lambda t: sum(t[1].values()) if t[1] else t[0]
    variants = {
        "launches_by_kernel": run.gmm_variants,
        "capacity_layout": {"rows": pad_rows, "hopper_ms": dev_ms(t_pad),
                            "wmma_ms": dev_ms(t_pad_wmma), "library_ms": t_pad[3],
                            "bound_ms": t_pad[4], "bound_by": t_pad[5]},
        "decode_step": {"rows": int(dgs.sum()), "ms": dev_ms(t_dec), "library_ms": t_dec[3],
                        "bound_ms": t_dec[4], "bound_by": t_dec[5]},
    }
    del buf, wi, wg, wo, h, kstore, pstore, dstore, dx, dw, mx, mp, pbuf, p_hop, p_plain, p_wmma
    release(run)
    return timing, err, main, variants, lines


def vlm_phase(base: Path, seed: int) -> list[str]:
    """VLM serving at Pixtral-12B's published widths, ``VLM_LAYERS`` of its
    40 layers: ``VLM_IMAGE`` seeded image embeddings before each prompt's
    tokens. This path adds no kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain

    cfg = get_config(VLM_ARCH)
    check((cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
           cfg.vocab_size, cfg.embedding_mode)
          == ("vlm", 40, 5120, 32, 8, 14336, 131072, "hier_ps"), f"unexpected pixtral {cfg}")
    cfg = dataclasses.replace(cfg, n_layers=VLM_LAYERS)
    run = serve_lm(cfg, base, seed, batch=LM_BATCH, prompt=LM_PROMPT - VLM_IMAGE,
                   steps=VLM_STEPS, n_image=VLM_IMAGE)
    check_launches(run, {"embedding_lookup": 1, "flash_attention": cfg.n_layers},
                   {"embedding_lookup": 1})
    checks = lm_logit_checks(run, embedding_lookup=embedding_lookup_plain)
    lines = lm_lines("vlm", run, checks, ("embedding_lookup", "flash_attention"))
    release(run)
    return lines


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


TOPK_STEPS = {"threshold": ("mips_group_min", "mips_threshold", "mips_filter", "mips_select"),
              "stream": ("mips_partial", "mips_merge")}


def equal_nan(a, b) -> bool:
    """Equal values, NaN where the other has NaN (payloads aside)."""
    import torch

    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


def topk_phase(q_dev, corpus, n_rows: int, seed: int) -> tuple[tuple, float, dict, str]:
    """topk_mips at the serving path's shapes (k=10 and k=100), both variants
    bitwise equal to the plain version; edge cases under both variants, among
    them the corpus whose threshold-variant candidate count reaches its
    capacity C; random normal data within tolerance, the two variants bitwise
    equal to each other and a launch equal to the next. Times: the threshold
    variant's four kernels (device ms per launch, k=100 and k=10), the
    stream kernel at the same shape, plain, ``torch.topk(q @ c.T)`` and the
    bound. Returns (timing, max_abs_err, variants record, line)."""
    import torch

    from repro_torch.kernels.topk_mips import (MAX_K, VARIANTS, capacity_corpus,
                                               topk_mips_cuda, topk_mips_plain, topk_plan)

    dev = q_dev.device
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    k_main = TOPK[1]
    for k in TOPK:
        check(topk_plan(BATCH, n_rows, k, n_sms).variant == "threshold",
              f"topk_mips k={k} at the main shape does not take the threshold variant")
        pv, pi = topk_mips_plain(q_dev, corpus, k, n_valid=n_rows)
        for variant in VARIANTS:
            kv, ki = topk_mips_cuda(q_dev, corpus, k, n_valid=n_rows, variant=variant)
            check(torch.equal(kv, pv) and torch.equal(ki, pi),
                  f"topk_mips {variant} k={k} main shape != plain")
            if variant == "threshold":
                max_err = float((kv - pv).abs().max())

    g = torch.Generator(device="cpu").manual_seed(seed)
    edge = []

    def dy(*shape):
        return (torch.randint(-128, 128, shape, generator=g) / 64.0).to(dev)

    def case(name, q, c, k, n_valid=None, counts_eq=None):
        pv, pi = topk_mips_plain(q, c, k, n_valid=n_valid)
        for variant in VARIANTS:
            counts = torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev)
            kv, ki = topk_mips_cuda(q, c, k, n_valid=n_valid, variant=variant,
                                    counts=counts if variant == "threshold" else None)
            check(equal_nan(kv, pv) and torch.equal(ki, pi),
                  f"topk_mips {variant} edge case {name}")
            if variant == "threshold" and counts_eq is not None:
                check(bool((counts == counts_eq).all()),
                      f"topk_mips {name}: candidate counts {counts.unique().tolist()} "
                      f"!= {counts_eq}")
        edge.append(name)

    case("k>N", dy(5, 8), dy(50, 8), 64)
    case("n_valid_tail", dy(9, 8), dy(5000, 8), 33, n_valid=3001)
    case("ties_4x_rows", dy(16, 8), dy(1000, 8).repeat(4, 1), 40)
    case("ragged_Q=13", dy(13, 16), dy(20000, 16), 7)
    case("k=1", dy(3, 8), dy(7000, 8), 1)
    case(f"k=MAX_K={MAX_K}", dy(20, 8), dy(100000, 8), MAX_K)
    case("n_valid=0", dy(4, 8), dy(100, 8), 5, n_valid=0)
    case("all_equal_rows", dy(40, 8), dy(1, 8).repeat(200_000, 1), 100)
    qd = dy(40, 8)
    qd[:, 0] = qd[:, 0].abs() + 0.5
    qd[:, 1:] = 0.0
    cd = dy(200_000, 8)
    cd[:, 0] = cd[:, 0].sort(descending=True).values
    case("sorted_descending", qd, cd, 100)  # the best rows crowd the first split
    cn = dy(600, 8)
    cn[torch.rand(600, generator=g).to(dev) < 0.3, 0] = -torch.inf
    qn = qd[:6].clone()
    qn[::3, 0] = 0.0  # 0 * -inf: NaN rows, ranked after the -inf ones
    case("neg_inf_and_nan_rows", qn, cn, 500)
    for k in (k_main, MAX_K):  # the main path's plan; k=512 at more splits (S=128 on an H100)
        plan = topk_plan(BATCH, n_rows, k, n_sms)
        qc, cc = capacity_corpus(plan)
        case(f"k={k}_S={plan.S}_count_reaches_C={plan.C}", qc.to(dev), cc.to(dev), k,
             counts_eq=plan.C)
    try:
        topk_mips_cuda(dy(2, 8), dy(10, 8), MAX_K + 1)
        check(False, "k > MAX_K must raise")
    except ValueError:
        edge.append("k>MAX_K_raises")
    # random normal data: within a stated tolerance of plain; the variants
    # score with the same fmaf sequence, so they agree bitwise
    qr = torch.randn(BATCH, 8, generator=g).to(dev)
    cr = torch.randn(n_rows, 8, generator=g).to(dev)
    kv, ki = topk_mips_cuda(qr, cr, k_main)
    kv2, ki2 = topk_mips_cuda(qr, cr, k_main)
    sv, si = topk_mips_cuda(qr, cr, k_main, variant="stream")
    pv, pi = topk_mips_plain(qr, cr, k_main)
    rnd_err = float((kv - pv).abs().max())
    agree = float((ki == pi).float().mean())
    check(torch.allclose(kv, pv, rtol=1e-5, atol=1e-5) and agree >= 0.99,
          f"topk_mips random normal: max |dscore| {rnd_err}, index agreement {agree}")
    check(torch.equal(kv, kv2) and torch.equal(ki, ki2), "topk_mips: two launches differ")
    check(torch.equal(kv, sv) and torch.equal(ki, si), "topk_mips: threshold != stream")
    edge.append(f"randn(max_abs_err={rnd_err:.2e},idx_agree={agree:.4f},"
                "threshold==stream==relaunch)")

    def run(variant, k=k_main):
        return lambda: topk_mips_cuda(q_dev, corpus, k, n_valid=n_rows, variant=variant)

    call_ms = cuda_ms(run("threshold"))
    steps = device_kernel_ms(run("threshold"), TOPK_STEPS["threshold"])
    steps_k10 = device_kernel_ms(run("threshold", TOPK[0]), TOPK_STEPS["threshold"])
    stream_call_ms = cuda_ms(run("stream"))
    stream_steps = device_kernel_ms(run("stream"), TOPK_STEPS["stream"])
    plain_ms = cuda_ms(lambda: topk_mips_plain(q_dev, corpus, k_main, n_valid=n_rows), iters=5)
    lib_ms = cuda_ms(lambda: torch.topk(q_dev @ corpus.T, k_main, dim=1), iters=10)
    bound, by = bound_ms(nbytes=(q_dev.numel() + corpus.numel()) * 4 + BATCH * k_main * 8,
                         flops=2.0 * BATCH * n_rows * corpus.shape[1])
    total = lambda d: sum(d.values()) if d else None
    p = topk_plan(BATCH, n_rows, k_main, n_sms)
    variants = {
        "threshold": {"ms": total(steps), "steps_ms": steps, "call_ms": call_ms,
                      "ms_k10": total(steps_k10), "plan": {"S": p.S, "G": p.G, "C": p.C}},
        "stream": {"ms": total(stream_steps), "steps_ms": stream_steps,
                   "call_ms": stream_call_ms},
    }
    line = (f"topk shape Q={BATCH} N={n_rows} D={corpus.shape[1]} k={k_main}: threshold "
            f"{variants['threshold']} stream {variants['stream']}; topk edge cases passed "
            f"under {list(VARIANTS)}: {edge}")
    return (call_ms, steps, plain_ms, lib_ms, bound, by), max_err, variants, line


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
    from repro_torch.kernels.topk_mips import topk_mips_cuda, topk_mips_plain
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
    check(topk_mips_cuda.launches_by_variant == {"threshold": launches["topk_mips"], "stream": 0},
          f"a serving topk_mips launch did not take the threshold variant: "
          f"{topk_mips_cuda.launches_by_variant}")
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

    topk_timing, topk_err, topk_variants, topk_line = topk_phase(q_dev, corpus, idx.n_rows,
                                                                  args.seed)
    max_err = {"topk_mips": topk_err}
    edge = []
    g = torch.Generator(device="cpu").manual_seed(args.seed)

    def dy(*shape):
        return (torch.randint(-128, 128, shape, generator=g) / 64.0).to(dev)

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
    run_bag = lambda: embedding_bag_cuda(bag_table, bag_ids, bag_slot, bag_valid, cfg.n_slots)
    bag_ms = cuda_ms(run_bag, iters=50)
    bag_dev_ms = device_kernel_ms(run_bag, ("bag_sort_kernel",), iters=50)
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
        "topk_mips": topk_timing,
        "embedding_bag": (bag_ms, bag_dev_ms, bag_plain_ms, bag_lib_ms, bag_bound, bag_by),
    }
    print(
        "kernels (serving shapes): "
        + "; ".join(
            f"{n} launches={launches[n]} call_ms={t[0]:.5f} device_ms={t[1]} plain_ms={t[2]:.5f} "
            f"library_ms={t[3]:.5f} bound_ms={t[4]:.6f} ({t[5]})" for n, t in timing.items())
        + f"; {topk_line}; bag shape "
        f"B={BATCH} nnz={cfg.nnz_per_example} n_slots={cfg.n_slots} D={cfg.emb_dim} "
        f"kept={n_kept} rows_read={n_rows_read}; edge cases passed: {edge}",
        flush=True,
    )

    train_timing, train_err, train_kernels_line = training_kernels_phase(cfg, args.seed)
    print(train_kernels_line, flush=True)

    # --------------------------------------------------------------- ingest
    fe_launches, ingest_line = ingest_phase(cfg, width, Path(snap) / "ingest")
    print(ingest_line, flush=True)
    fe_timing, fe_err, fe_line = feature_extract_phase(cfg, args.seed)
    print(fe_line, flush=True)

    # -------------------------------------------------------------- grouped
    print(grouped_lr_phase(args.seed, plain), flush=True)

    # ------------------------------------------------------------------- lm
    lm_timing, lm_err, lm_launches, flash_variants, lines = lm_phase(Path(snap) / "lm", args.seed)
    for ln in lines:
        print(ln, flush=True)

    # ------------------------------------------------------------------ moe
    moe_timing, moe_err, moe_launches, gmm_variants, lines = moe_phase(Path(snap) / "moe",
                                                                        args.seed)
    for ln in lines:
        print(ln, flush=True)

    # ------------------------------------------------------------------ vlm
    for ln in vlm_phase(Path(snap) / "vlm", args.seed):
        print(ln, flush=True)

    # --------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)

    # topk_mips at the serving path's shapes and launches; the three training
    # kernels at one training mini-batch's shapes with the training path's
    # launches; feature_extract at one ingest batch's shape with the ingest
    # path's launches; embedding_lookup and flash_attention at the LM
    # prefill's shapes with the LM path's launches; moe_gmm at the MoE
    # prefill's shape with the MoE path's launches
    sources = {
        "topk_mips": ("src/repro_torch/csrc/topk_mips.cu", "src/repro/kernels/topk_mips.py:101"),
        "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:63"),
        "scatter_add": ("src/repro_torch/csrc/scatter_add.cu",
                        "src/repro/kernels/scatter_add.py:43"),
        "fused_adagrad": ("src/repro_torch/csrc/fused_adagrad.cu",
                          "src/repro/kernels/fused_adagrad.py:33"),
        "feature_extract": ("src/repro_torch/csrc/feature_extract.cu",
                            "src/repro/kernels/feature_extract.py:229"),
        "embedding_lookup": ("src/repro_torch/csrc/embedding_lookup.cu",
                             "src/repro/kernels/embedding_lookup.py:32"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:106"),
        "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:45"),
    }
    timing = {"topk_mips": timing["topk_mips"], **train_timing, "feature_extract": fe_timing,
              **lm_timing, **moe_timing}
    max_err = {"topk_mips": max_err["topk_mips"], **train_err, "feature_extract": fe_err,
               **lm_err, **moe_err}
    main_launches = {"topk_mips": launches["topk_mips"],
                     **{n: train_launches[n] for n in train_timing},
                     "feature_extract": fe_launches, **lm_launches, **moe_launches}
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
        if name == "topk_mips":  # the threshold variant on the path, stream beside it
            record[-1]["variants"] = topk_variants
        if name == "flash_attention":  # its two kernels: hopper on the path, simt beside it
            record[-1]["variants"] = flash_variants
        if name == "moe_gmm":  # the compacted prefill above; the capacity layout and decode
            record[-1]["variants"] = gmm_variants
    retr.close()
    tmp.cleanup()
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
