#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's ad-serving path, its CTR training path and its streaming
ingestion path (``repro_torch``) at the full width of ``ctr-C-scaled`` — emb_dim 8, 500
nonzeros per example over 125 slots, 600,000 keys, tower (96, 48), batch
2048 in 4 mini-batches, ``[emb | adagrad]`` rows 16 floats wide — its
LM serving path at Yi-9B's published widths, its MoE serving path at
OLMoE-1B-7B's published widths and depth, its VLM serving path at
Pixtral-12B's published widths, its hybrid, SSM and audio serving paths
at hymba-1.5b's, xlstm-1.3b's and whisper-tiny's published widths (whisper's
depth too),
and its LM training path (hier_ps: the token table in the PS) at Yi-9B's and
OLMoE-1B-7B's published widths, cut in depth, on one rank, and
tensor-parallel on two to five at those and at whisper-tiny's, xlstm-1.3b's,
hymba-1.5b's and phi3.5-moe's, through the entry points a user calls, and
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
11. hybrid  — hymba-1.5b at its published widths, 8 of its 32 layers (d
              1600, 25 heads over 5 KV heads, mamba heads of state 16,
              window 1024 but in layers 0/3/7, as the published 0/15/31,
              128 meta tokens): 4 x 2,048 prompt tokens (2,176 positions),
              per prefill 1 embedding_lookup and 8 flash_attention (5
              windowed), 32 greedy decode steps on
              the ring and full caches; each layer against the same layer on
              plain attention (banded in the window layers) from the same
              input, decode continuity, each flash mode on its real q, k, v.
12. ssm     — xlstm-1.3b at its published widths, 8 of its 48 blocks (7
              mLSTM + 1 sLSTM, d 2048, 4 heads): prefill of 4 x 2,048
              prompt tokens (the forward's last logits, 1 embedding_lookup),
              then 32 decode steps from ``init_cache`` fed the prompt's first
              32 tokens; each block's decode steps against its forward over
              the same inputs.
13. audio   — whisper-tiny at its published widths (4 + 4 layers, d 384, 6
              heads): 4 x (1,500 seeded frames + 224 prompt tokens), per
              prefill 1 embedding_lookup and 12 flash_attention (encoder
              non-causal, decoder causal, cross attention 224 x 1,500), 32
              greedy decode steps; the same checks as hybrid.
14. lm_train — LM training at Yi-9B's published widths (d 4096, 32 heads
              over 4 KV heads, Dh 128, d_ff 11008, vocab 64,000), depth cut
              to 8 of its 48 layers (fp32 weights, AdamW's fp32 m and v and
              the fp32 gradients come to ~137 GB at 48, ~26 GB at 8),
              hier_ps: the launcher (``launch.train.run``) on an NCCL world
              of one — a fresh 2-node Cluster holding
              TableSpec("tok_emb", RowSchema.with_adagrad(4096)),
              TokenStream(64000, 4, 2048) -> PSClient.session -> the hier
              step (2 microbatches of 2 x 2048 tokens, remat on, AdamW lr
              3e-4, row-Adagrad) -> session commit, 3 steps; exact launch
              counts per step (2 embedding_lookup, 2 scatter_add, 32
              flash_attention on the wgmma + TMA kernel, 16 flash backward
              recomputes, 1 fused_adagrad); step 1 rerun equal to the
              counted step bit for bit, its loss and every gradient leaf
              against the same step on the plain versions (naive attention)
              within LM_TOL, beside two plain paths' floor, its new rows
              against the plain path's where the two table gradients
              share a sign; the rows read back after commit; step time, tokens/s, peak memory,
              session host times, a torch.profiler breakdown, and the
              launcher's gradient all-reduce timed over a parameter-sized
              fp32 tree.
15. moe_train — the same at OLMoE-1B-7B's published widths (d 2048, 64
              experts top-8 of d_ff 1024, vocab 50,304), 4 of its 16 layers,
              2 steps: 72 moe_gmm launches per step (wi, wg, wo forward,
              remat's recompute and dx, dx counted by mode), every one on
              the wgmma + TMA kernel;
              remat's recomputed routing equal to the forward's; the tokens
              whose experts differ between the kernel and the plain step.
    Then the training path's backward kernels against their plain versions
    at its shapes, with their times beside one PyTorch call and the bound:
    the lookup's backward through scatter_add at 8,192 zipf ids x 4096 and
    fused_adagrad at [n_working, 4096] (both bitwise), the flash Function's
    dq, dk, dv against fp32 naive attention at Yi-9B's, hymba's window,
    whisper's encoder and cross attention shapes (SDPA's backward beside
    it), and gmm dx and dw at OLMoE layer 0's kept rows.
16. launch_cli — ``python -m repro_torch.launch.train`` at smoke yi-9b and
              olmoe-1b-7b: 4 steps with checkpoints every 2, then
              ``--resume`` for 2 (subprocesses on the card, the two archs'
              side by side); in process the
              same run and its resume: params, AdamW state and PS rows
              restored bitwise, and equal to the CLI's checkpoint.
17. sharded_hbm — ``ShardedWorkingTable`` on the NCCL world of one against
              ``WorkingTable`` bitwise, and its S = 4 per-shard bodies in one
              process (embedding_lookup 3 launches a shard, scatter_add 1)
              against their plain versions at ctr-C-scaled's working set and
              ``lm_train``'s [3,729, 4096] table: times, bounds,
              ``F.embedding`` and ``index_add_``, ``plan_a2a``'s host ms.
18. tp_train — tensor parallelism over ``model``: M gloo ranks on the one
              card (a (data 1, model M) mesh; NCCL takes one rank a card;
              every run's ranks on one pool of processes started once,
              ``chip_smoke.py --tp-pool``) train 2 steps through
              ``launch.train.run(model_parallel=M)`` at published widths
              (``TP_CELLS``, keyed by arch and M): Yi-9B (2 of 48 layers)
              and OLMoE-1B-7B (2 of 16 layers, 32 experts a rank) at M = 2,
              whisper-tiny (4 + 4 layers, 4 x (1,500 frames + 224 tokens))
              at M = 2 (3 heads a rank) and M = 4 (1.5 heads' columns a
              rank: q gathered into whole heads, 1 or 2 a rank),
              xlstm-1.3b (8 of 48 blocks: 7 mLSTM + 1 sLSTM, 1,024 tokens
              a sequence) at M = 2, hymba-1.5b (2 of 32 layers, global at
              0, window at 1) at M = 5 and M = 2 (12.5 heads' columns a
              rank; rank 1's heads start inside a kv group: flash with a
              head offset), phi3.5-moe-42b-a6.6b (1 of 32 layers) at M = 5
              (model inside each of its 16 experts' mlp: 1,280 of 6,400
              columns a rank); then this process's NCCL world of one the
              same (one for the cells of one config): step 1's gradients
              gathered over ``model`` within LM_TOL of the world of one's
              (hymba's and xlstm's with fp32 compute, their bf16 ones
              printed, and beside hymba's the world of one's own gap with
              every weight one ulp of that compute dtype off), and its new
              rows within
              LM_TOL * row_lr where the table gradients share a sign,
              replicated leaves bitwise equal on every rank after each step,
              each rank's parameter count, launches (flash's by mask mode)
              and local kernel shapes, peak memory and step ms per rank;
              each kernel (flash by mask mode) at rank 0's first TP call
              checked (lookup and Adagrad bitwise, scatter_add its contract
              bound, flash and moe_gmm their main-path tolerances) and timed
              against its plain version and one PyTorch call; flash with
              a head offset on the rank whose heads start inside a kv
              group, hopper in bf16 and SIMT in fp32, against its plain
              version and SDPA on kv expanded per q head; for the three
              cells added with the uneven placements, each step's
              collective bytes over ``model`` on every rank equal to the
              dry run's count (the others' counts printed). With it,
              ``fsdp_train``: the Yi-9B cell again on four gloo ranks, mesh
              (data 2, model 2), FSDP over ``data`` (weights, gradients and
              AdamW state cut on both axes), one microbatch of 2 sequences a
              data rank: step 1's gradients gathered over both axes and its
              new rows held against the same world of one, leaves bitwise
              equal over each axis they are whole on, the same launch,
              shape and kernel checks at the local shapes, and each step's
              collective bytes over ``data`` equal to the dry run's count
              of that step; peak memory a rank beside the dry run's.
19. dryrun  — ``repro_torch.launch.dryrun`` (one rank's step traced on the
              meta device under the op counter, no card) of ``lm_train``'s
              and ``moe_train``'s cells (mesh 1 x 1, their microbatches,
              remat, working rows) against what the card measured: the
              predicted peak within 0.9-1.1x of ``max_memory_allocated``,
              each kernel's calls per step equal to its launches per step,
              max(t_compute, t_memory, t_collective) at most the warm step;
              printed: whisper-tiny's ``tp_train`` rank 0 at (1, 2)
              predicted vs measured, and each cell's roofline fraction.
20. device  — the seconds of each phase, and the card's name and power
              limit (nvidia-smi).

Then one JSON line with the per-kernel record, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises: non-zero exit, no
result. Without a card it exits non-zero at once.

Run:  python3 chip_smoke.py [--seed N]
(``--tp-pool PLAN`` runs one process of the pool of ranks that
``tp_train`` starts once for all its runs, ``fsdp_train``'s among them.)
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
    of a 12 ms kernel, and once none of 20 launches of a 0.12 ms one, so a
    profile that records none is taken again, up to 3 times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            for n in names:
                if n in ev.key and ev.device_type == DeviceType.CUDA:
                    out[n] = out.get(n, 0.0) + ev.self_device_time_total / ev.count / 1e3
        if sum(out.values()) > 0:
            return out
    return {}


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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((ev.key[:48], ev.self_device_time_total / 1e3, ev.count)
                      for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
                     key=lambda k: -k[1])
    return (wall_ms, sum(k[1] for k in kernels),
            [(name, round(ms, 3), n) for name, ms, n in kernels[:top]])


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def scatter_within(diff, zeros, ids, grads) -> bool:
    """scatter_add's contract bound against the plain version on the card,
    which adds in another order: ``diff`` (|kernel - plain| of a scatter
    into ``zeros``) within 1e-5 of each row's sum of magnitudes, plus
    1e-6."""
    from repro_torch.kernels.scatter_add import scatter_add_plain_

    scale = scatter_add_plain_(zeros.clone(), ids, grads.abs())
    return bool((diff <= 1e-5 * scale + 1e-6).all())


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
    check(scatter_within(diff, zeros, sid, g_rn), "scatter_add random normal vs card plain")
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


def rel_err(name: str, got, want) -> float:
    """max |got - want| / max |want|; fails where ``got`` is not finite."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{name}: not finite")
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def lm_check(name: str, got, want) -> float:
    """Finite, and max |got - want| <= LM_TOL * max |want|; returns the ratio."""
    rel = rel_err(name, got, want)
    check(rel <= LM_TOL, f"{name}: max |diff| {rel} of max |ref| > {LM_TOL}")
    return rel


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


@contextlib.contextmanager
def compute_dtype(dtype):
    """Every model family computes in ``dtype`` for the block."""
    from repro_torch.models import hymba, transformer, whisper

    with contextlib.ExitStack() as stack:
        for mod in (transformer, hymba, whisper):
            stack.enter_context(swapped(mod, COMPUTE_DTYPE=dtype))
        yield


def serve_lm(cfg, base: Path, seed: int, *, batch: int, prompt: int, steps: int,
             n_image: int = 0):
    """The LM serving path on the card through the entry points a user
    calls, counted: publish a seeded fp32 ``tok_emb`` of all ``vocab`` keys to
    2 PS nodes, ServingEngine(device_hot_rows=16384), bf16 weights from a
    seeded CUDA generator (``get_model(cfg).init``), ``TokenStream`` prompts
    (and, for a VLM, seeded image embeddings first; for the audio family,
    seeded fp32 frames), then ``lookup_device`` -> prefill -> ``steps``
    decode steps on the family's cache (``grow_cache``), each one
    ``lookup_device`` of the new tokens: greedy, except the ``ssm`` family's,
    which are fed the prompt's first ``steps`` tokens from ``init_cache``
    (its prefill keeps no state). The launch counts (flash_attention's by
    kernel and by mask mode too) are zeroed just before and read just after.
    Returns what the phase's checks and timings need."""
    import numpy as np
    import torch

    from repro_torch.convert import publish_arrays
    from repro_torch.core.tables import RowSchema, TableSpec
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_cuda
    from repro_torch.models import get_model
    from repro_torch.serve import ServingCluster, ServingEngine
    from repro_torch.serve.serve_step import (
        greedy_sample,
        grow_cache,
        make_decode_step,
        make_prefill_step,
    )

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
    params = get_model(cfg).init(cfg, gen, dtype=torch.bfloat16)
    img = (torch.randn((B, n_image, d), generator=gen, device=dev, dtype=torch.float32)
           if n_image else None)
    frames = (torch.randn((B, cfg.n_frames, d), generator=gen, device=dev, dtype=torch.float32)
              if cfg.family == "audio" else None)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    prompts = TokenStream(V, B, S, seed=seed).next_batch()[:, :S].astype(np.uint64)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    slots_dev = lambda sl: torch.from_numpy(np.ascontiguousarray(sl)).to(dev)
    teacher = cfg.family == "ssm"

    def batch_of(sl, wt_):
        out = {"tokens": slots_dev(sl), "working_table": wt_}
        if img is not None:
            out["image_embeds"] = img
        if frames is not None:
            out["frames"] = frames
        return out

    # decode positions: after the image embeddings (vlm) or the meta tokens
    # (hybrid) and the prompt; the ssm decode starts from init_cache
    ctx = 0 if teacher else n_image + cfg.n_meta_tokens + S
    # ---- the main path, counted: lookup -> prefill -> decode steps
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
    prefill_modes = dict(flash_attention_cuda.launches_by_mode)
    prefill_gmm_variants = dict(gmm_cuda.launches_by_variant)
    cache = grow_cache(cfg, cache, steps, batch=B)
    tokens, step_s, lookup_s = [], [], []
    tok = greedy_sample(logits)
    first_logits = logits
    for i in range(steps):
        t0 = time.perf_counter()
        keys = (prompts[:, i:i + 1] if teacher else tok.cpu().numpy().astype(np.uint64))
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
    flash_modes = dict(flash_attention_cuda.launches_by_mode)
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
        cfg=cfg, engine=engine, params=params, img=img, frames=frames, prompts=prompts,
        slots=slots, wt=wt, uniq=uniq, first_logits=first_logits, cache=cache,
        last=(s_i, wt_i), ctx=ctx, steps=steps, after_prefill=after_prefill,
        prefill_variants=prefill_variants, prefill_modes=prefill_modes, flash_modes=flash_modes,
        prefill_gmm_variants=prefill_gmm_variants, gmm_variants=gmm_variants,
        decode_launches=decode_launches, launches=launches, decoded=decoded, step_s=step_s, lookup_s=lookup_s,
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
    prefill): max |diff| / max |full|, unchecked."""
    from repro_torch.serve.serve_step import grow_cache

    if full is None:
        full, _ = run.prefill(run.params, run.batch_of(run.slots, run.wt))
    s_a, wt_a = run.engine.lookup_device("tok_emb", run.prompts[:, :-1])
    _, cache_a = run.prefill(run.params, run.batch_of(s_a, wt_a))
    cache_a = grow_cache(run.cfg, cache_a, 1, batch=run.prompts.shape[0])
    s_b, wt_b = run.engine.lookup_device("tok_emb", run.prompts[:, -1:])
    cont, _ = run.decode(run.params, {"token": run.slots_dev(s_b), "working_table": wt_b},
                         cache_a, run.ctx - 1)
    return rel_err(f"{run.cfg.name} decode continuity (prefill {run.ctx - 1} + decode 1 vs "
                   f"prefill {run.ctx})", cont, full)


def plain_ratios(run, **plain) -> tuple[float, float, float]:
    """The kernel prefill's last logits against the same prefill on plain
    attention, naive and blockwise, with the kernels named in ``plain`` on
    their plain versions; and the plain-vs-plain floor (naive vs blockwise).
    Each max |diff| / max |ref|, unchecked."""
    naive = plain_prefill(run, "naive", **plain)
    block = plain_prefill(run, "blockwise", **plain)
    name = f"{run.cfg.name} prefill last logits"
    return (rel_err(name, run.first_logits, naive), rel_err(name, run.first_logits, block),
            rel_err(name, block, naive))


def lm_logit_checks(run, *, continuity: bool = True, **plain) -> tuple[float, ...]:
    """``plain_ratios``, the kernel's two within ``LM_TOL``; and, where
    ``continuity``, decode continuity within ``LM_TOL``. Returns (vs naive,
    vs blockwise, floor, continuity or None), of the largest logit."""
    name = run.cfg.name
    rel_plain, rel_block, rel_floor = plain_ratios(run, **plain)
    check(max(rel_plain, rel_block) <= LM_TOL,
          f"{name} prefill last logits, kernels vs plain attention: naive {rel_plain}, "
          f"blockwise {rel_block} of max |logit| > {LM_TOL}")
    rel_cont = None
    if continuity:
        rel_cont = decode_continuity(run, run.first_logits)
        check(rel_cont <= LM_TOL, f"{name} decode continuity {rel_cont} > {LM_TOL} of max |logit|")
    return rel_plain, rel_block, rel_floor, rel_cont


def hybrid_layer_checks(run) -> list[float]:
    """Every layer's attention branch in a kernel prefill (flash) against the
    same branch on plain attention (naive: ``attention_banded`` in the window
    layers) from the same input, within ``LM_TOL`` of the plain branch's
    largest magnitude. Returns each layer's max |diff| / max |plain|. The
    branch and not the layer's output, whose residual stream, shared by both,
    would hide a wrong branch at depth."""
    from repro_torch.models import hymba as H

    real_layer, real_attention, branches, rels = H._hymba_layer, H.attention_block, [], []

    def attention(*args, **kw):
        out = real_attention(*args, **kw)
        branches.append(out[0])
        return out

    def layer(cfg, h, lp, **kw):
        out = real_layer(cfg, h, lp, **kw)
        real_layer(cfg, h, lp, **{**kw, "attn_impl": "naive"})
        flash, plain = branches
        branches.clear()
        rels.append(lm_check(f"{cfg.name} layer {len(rels)} attention branch, flash vs plain "
                             f"naive from the same input", flash, plain))
        return out

    with swapped(H, _hymba_layer=layer, attention_block=attention):
        plain_prefill(run, "auto")
    check(len(rels) == run.cfg.n_layers, f"{len(rels)} hymba layers checked")
    return rels


def teacher_decode(run, params):
    """``run.steps`` decode steps on ``params`` from ``init_cache``, fed the
    prompt's first ``run.steps`` tokens (the ``ssm`` serving contract) ->
    their logits [B, steps, V]."""
    import torch

    from repro_torch.serve.serve_step import grow_cache

    cache = grow_cache(run.cfg, None, 0, batch=run.prompts.shape[0])
    logits = []
    for t in range(run.steps):
        s_t, wt_t = run.engine.lookup_device("tok_emb", run.prompts[:, t:t + 1])
        out, cache = run.decode(params, {"token": run.slots_dev(s_t), "working_table": wt_t},
                                cache, t)
        logits.append(out)
    return torch.cat(logits, dim=1)


def recurrent_continuity(run, params) -> float:
    """The ``ssm`` family's serving contract end to end, on ``params``: the
    teacher-forced decode steps against the forward over the same tokens:
    max |diff| / max |forward|, unchecked."""
    from repro_torch.models import get_model

    s_f, wt_f = run.engine.lookup_device("tok_emb", run.prompts[:, :run.steps])
    full, _ = get_model(run.cfg).forward(run.cfg, params, run.slots_dev(s_f), working_table=wt_f)
    return rel_err(f"{run.cfg.name} {run.steps} decode steps from init_cache vs the forward "
                   f"over the same tokens", teacher_decode(run, params), full)


def recurrent_block_checks(run) -> list[float]:
    """Every block's branch in the xlstm decode against its forward: the
    teacher-forced decode steps replayed, capturing each block's branch (the
    mLSTM mixer, the sLSTM cell) input and output per step; each branch
    over its captured inputs at once (chunkwise mLSTM, sequential sLSTM)
    against its decode outputs, within ``LM_TOL`` of the forward's largest
    magnitude. Returns each block's max |diff| / max |forward|. The branch
    and not the block's output, whose residual stream, shared by both,
    would hide a wrong branch at depth."""
    import torch

    from repro_torch.models import xlstm as X

    n_blocks = run.cfg.n_layers
    real = {"mlstm": X._mlstm_mixer, "slstm": X._slstm_cell}
    blocks: dict[int, tuple] = {}
    calls = [0]

    def recording(kind):
        def branch(cfg, p, x, *, state, **kw):
            out, new = real[kind](cfg, p, x, state=state, **kw)
            _, _, xs, outs = blocks.setdefault(calls[0] % n_blocks, (kind, p, [], []))
            xs.append(x)
            outs.append(out)
            calls[0] += 1
            return out, new
        return branch

    with swapped(X, _mlstm_mixer=recording("mlstm"), _slstm_cell=recording("slstm")):
        teacher_decode(run, run.params)
    check(calls[0] == n_blocks * run.steps, f"{calls[0]} block calls in {run.steps} steps")
    rels = []
    for i in range(n_blocks):
        kind, p, xs, outs = blocks[i]
        kw = {"chunk": 64} if kind == "mlstm" else {}  # the forward's chunk
        fwd, _ = real[kind](run.cfg, p, torch.cat(xs, dim=1), state=None, **kw)
        rels.append(lm_check(f"{run.cfg.name} block {i} ({kind}) branch: {run.steps} decode "
                             f"steps vs its forward over the same inputs",
                             torch.cat(outs, dim=1), fwd))
    return rels


def fp32_checks(run) -> tuple[float, ...]:
    """The end-to-end checks that bf16 rounding defeats at depth, run again
    on the same weights upcast to fp32 with fp32 compute (TF32 off), each
    within ``LM_TOL``: hybrid, the kernel prefill's last logits (flash on its
    fp32 kernel) against naive and blockwise attention; ssm, the
    teacher-forced decode steps against the forward. Returns the ratios."""
    import torch

    from repro_torch.serve.serve_step import make_prefill_step

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    params, f32 = _tree_map(lambda t: t.float(), run.params), torch.float32
    name = f"{run.cfg.name} with fp32 compute"
    with compute_dtype(f32):
        if run.cfg.family == "ssm":
            rels = (recurrent_continuity(run, params),)
        else:
            batch = run.batch_of(run.slots, run.wt)
            kernel, naive, block = (make_prefill_step(run.cfg, attn_impl=impl)(params, batch)[0]
                                    for impl in ("auto", "naive", "blockwise"))
            rels = (rel_err(name, kernel, naive), rel_err(name, kernel, block))
    check(max(rels) <= LM_TOL, f"{name}: end to end {rels} of max |logit| > {LM_TOL}")
    del params
    torch.cuda.empty_cache()
    return rels


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
    img += "" if run.frames is None else f"frames={tuple(run.frames.shape)} "
    moe = f"experts={cfg.n_experts}/top{cfg.top_k} " if cfg.is_moe else ""
    tokens = B * (run.prompts.shape[1] + cfg.n_meta_tokens + (0 if run.img is None
                                                               else run.img.shape[1]))
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
        f"decoded[0][:8]={run.decoded[0][:8].tolist()} card {card()}",
        f"{name} breakdown (torch.profiler, one call each): prefill wall_ms={pre_wall:.1f} "
        f"kernels_ms={pre_dev:.1f} busy={pre_dev / pre_wall:.3f} top={pre_top}; decode step "
        f"without lookup_device wall_ms={dec_wall:.1f} kernels_ms={dec_dev:.1f} "
        f"busy={dec_dev / dec_wall:.3f} top={dec_top}; card {card()}",
    ]


def release(run) -> None:
    """Free a phase's weights and caches on the card."""
    import torch

    for name in ("params", "img", "frames", "cache", "wt", "first_logits", "last", "engine"):
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
# beside SDPA: OLMoE-1B-7B's (the MoE phase's attention); hymba-1.5b's and
# whisper-tiny's modes are timed at their real q, k, v in their own phases
FLASH_SHAPES = [
    # name, B, H, Hkv, S, Dh, causal, window
    ("olmoe_prefill", 4, 16, 16, 2048, 128, True, 0),
]


def flash_within(got, want) -> bool:
    """flash_attention's tolerance against its plain version: fp32 within
    2e-5, bf16 within rtol 2^-6 and atol 2e-5."""
    import torch

    tol = (dict(rtol=2e-5, atol=2e-5) if want.dtype == torch.float32
           else dict(rtol=2**-6, atol=2e-5))
    return got.dtype == want.dtype and torch.allclose(got.float(), want.float(), **tol)


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
    check(got.dtype == q.dtype and flash_within(got, want),
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
        plain_ms = cuda_ms(lambda: flash_attention_plain(qs, ks, vs, **kw), iters=3, warmup=1)
        variants["hopper"].setdefault("shapes", {})[name] = {
            "ms": sum(dev_ms.values()), "bound_ms": b_ms, "plain_ms": plain_ms,
            "library_ms": sdpa_ms}
        shape_parts.append(
            f"{name} q {tuple(qs.shape)} kv {tuple(ks.shape)} causal={causal} window={window} "
            f"kept pairs {kept}: device_ms={sum(dev_ms.values()):.5f} call_ms="
            f"{cuda_ms(call, iters=20):.5f} bound_ms={b_ms:.6f} ({b_by}) plain_ms={plain_ms:.5f} "
            f"sdpa_ms={sdpa_ms:.5f} (kernel {sdpa_kernel!r}) max|kernel-plain|={e_s:.3e}")
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


def gmm_within(got, want) -> bool:
    """moe_gmm's tolerance against its plain version: fp32 within atol and
    rtol 2e-4 (the reference's test_gmm_vs_ref); bf16 within rtol 2^-6 (one
    bf16 ulp, doubled: both round an fp32 sum taken in another order) and
    atol 1e-4 of the largest output; finite."""
    import torch

    if want.dtype == torch.float32:
        tol = dict(rtol=2e-4, atol=2e-4)
    else:
        tol = dict(rtol=2**-6, atol=1e-4 * float(want.float().abs().max()))
    return (got.dtype == want.dtype and got.shape == want.shape
            and bool(torch.isfinite(got).all())
            and torch.allclose(got.float(), want.float(), **tol))


def gmm_close(name: str, got, want) -> float:
    """The kernel against its plain version, within :func:`gmm_within`.
    Returns max |diff|."""
    check(gmm_within(got, want), f"moe_gmm {name}: kernel != plain")
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


HYBRID_ARCH, SSM_ARCH, AUDIO_ARCH = "hymba-1.5b", "xlstm-1.3b", "whisper-tiny"
AUDIO_PROMPT = 224  # text tokens after the frames; with 32 decode steps 256 of 448
FAMILIES = {
    # phase: (arch, published widths, prompt tokens, flash launches per
    # prefill by mask mode (Sq, Skv, causal, window), depth cut). hymba at
    # 8 of its 32 layers (global first, middle and last, as the published
    # (0, 15, 31)) and xlstm at 8 of its 48 blocks (1 of 6 supersteps of 7
    # mLSTM + 1 sLSTM), cut to keep the script inside its time: both phases
    # serve through every kind of layer of their model
    "hybrid": (HYBRID_ARCH,
               dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, resolved_head_dim=64,
                    d_ff=5504, ssm_state=16, window=1024, global_attn_layers=(0, 15, 31),
                    n_meta_tokens=128, vocab_size=32001),
               LM_PROMPT, {(2176, 2176, True, 1024): 5, (2176, 2176, True, 0): 3},
               dict(n_layers=8, global_attn_layers=(0, 3, 7))),
    "audio": (AUDIO_ARCH,
              dict(encoder_layers=4, n_layers=4, d_model=384, n_heads=6, resolved_head_dim=64,
                   d_ff=1536, n_frames=1500, vocab_size=51865),
              AUDIO_PROMPT,
              {(1500, 1500, False, 0): 4, (224, 224, True, 0): 4, (224, 1500, False, 0): 4}, {}),
    "ssm": (SSM_ARCH,
            dict(n_layers=48, d_model=2048, n_heads=4, slstm_every=8, proj_factor=2.0,
                 vocab_size=50304),
            LM_PROMPT, {}, dict(n_layers=8)),
}


def family_phase(name: str, base: Path, seed: int) -> tuple[dict, dict, list[str]]:
    """Serving of the hybrid, SSM or audio family at its published widths on
    the card, its depth cut where ``FAMILIES`` says: the counted path with its exact launch
    counts, flash_attention's by mask mode too; the last logits against the
    fully plain prefill (naive and blockwise attention,
    ``embedding_lookup_plain``; hymba's window layers take
    ``attention_banded``), within ``LM_TOL`` for whisper; hymba's attention
    branch layer by layer and xlstm's block branches (decode steps against
    the forward), and both end to end with fp32 compute (``fp32_checks``);
    decode continuity (hymba, whisper); and each flash mode on the real q,
    k, v of a kernel prefill against ``flash_attention_plain`` on the
    hopper kernel, timed beside SDPA. Returns (the path's launches, the
    flash modes' records, lines)."""
    import dataclasses

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
    )

    arch, widths, prompt, want_modes, cuts = FAMILIES[name]
    cfg = get_config(arch)
    check(cfg.family == name and cfg.embedding_mode == "hier_ps"
          and all(getattr(cfg, k) == v for k, v in widths.items()),
          f"unexpected {arch} widths {cfg}")
    cfg = dataclasses.replace(cfg, **cuts)
    per_prefill = {"embedding_lookup": 1}
    if want_modes:
        per_prefill["flash_attention"] = sum(want_modes.values())
    run = serve_lm(cfg, base, seed, batch=LM_BATCH, prompt=prompt, steps=LM_STEPS)
    check_launches(run, per_prefill, {"embedding_lookup": 1})
    check(run.prefill_modes == want_modes and run.flash_modes == want_modes,
          f"{arch} flash launches by mode: prefill {run.prefill_modes}, whole run "
          f"{run.flash_modes}, want {want_modes} in the prefill and none in decode")

    # ---- off the counted path
    plain = dict(embedding_lookup=embedding_lookup_plain)
    held = f"published widths {widths}" + (f", depth cut to {cuts}; " if cuts else "; ")
    if name == "audio":
        checks = lm_logit_checks(run, **plain)
    else:
        checks = plain_ratios(run, **plain) + (None,)
        rels_fp32 = fp32_checks(run)
        held += (f"the bf16 end-to-end numbers above unchecked; with fp32 compute on the same "
                 f"weights (checked, tol {LM_TOL}) ")
    if name == "hybrid":
        rel_cont = decode_continuity(run, run.first_logits)
        check(rel_cont <= LM_TOL, f"{arch} decode continuity {rel_cont} > {LM_TOL} of max |logit|")
        checks = checks[:3] + (rel_cont,)
        rels = hybrid_layer_checks(run)
        held += (f"kernel vs naive {rels_fp32[0]:.3e}, vs blockwise {rels_fp32[1]:.3e}; held "
                 f"layer by layer: the attention branch, flash vs plain naive from the same "
                 f"input, max over {len(rels)} layers {max(rels):.3e} (layer "
                 f"{rels.index(max(rels))}), per layer {[round(r, 4) for r in rels]}; ")
    if name == "ssm":
        rels = recurrent_block_checks(run)
        held += (f"the logits of the {run.steps} decode steps vs the forward over the same "
                 f"tokens {rels_fp32[0]:.3e}, in bf16 (unchecked) "
                 f"{recurrent_continuity(run, run.params):.3e}; held block by block: each "
                 f"block's branch, {run.steps} decode steps vs its forward over the same inputs, "
                 f"max over {len(rels)} blocks {max(rels):.3e} (block {rels.index(max(rels))}), "
                 f"per block {[round(r, 4) for r in rels]}; ")

    # ---- each flash mode on the real q, k, v of a kernel prefill against
    # the plain version, and its times
    modes = {}
    real_attention = kops.attention

    def capture(q, k, v, *, causal=True, window=0, q_offset=0, **kw):
        modes.setdefault((q.shape[2], k.shape[2], causal, window),
                         (q.contiguous(), k.contiguous(), v.contiguous(), q_offset))
        return real_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, **kw)

    with swapped(kops, attention=capture):
        run.prefill(run.params, run.batch_of(run.slots, run.wt))
    check(set(modes) == set(want_modes), f"{arch} prefill attention modes {sorted(modes)}")
    records, parts = {}, []
    for (Sq, Skv, causal, window), (q, k, v, q_offset) in sorted(modes.items()):
        mask_name = ("causal" if causal else "full") + (f"_w{window}" if window else "")
        label = f"{name}_{mask_name}_{Sq}x{Skv}"
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        err = flash_case(label, q, k, v, "hopper", **kw)
        call = lambda: flash_attention_cuda(q, k, v, **kw)
        call_ms = cuda_ms(call, iters=20)
        dev_ms = device_kernel_ms(call, ("flash_attention_hopper_kernel",), iters=20)
        check(bool(dev_ms), f"flash_attention {label}: no device time in the profile")
        if window:  # SDPA has no window: an explicit mask
            mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                                  device=q.device)
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                          enable_gqa=True)
        sdpa_ms = cuda_ms(sdpa, iters=20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=3, warmup=1)
        B, H, _, Dh = q.shape
        kept = B * H * kept_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset)
        b_ms, b_by = bound_ms(nbytes=2.0 * (2 * q.numel() + k.numel() + v.numel()),
                              flops=4.0 * Dh * kept, peak=BF16_FLOPS)
        n_run = run.flash_modes[(Sq, Skv, causal, window)]
        records[label] = {"launches": n_run, "ms": sum(dev_ms.values()), "bound_ms": b_ms,
                          "bound_by": b_by, "plain_ms": plain_ms, "library_ms": sdpa_ms,
                          "max_abs_err": err}
        parts.append(f"{label} q {tuple(q.shape)} kv {tuple(k.shape)} launches on the path "
                     f"{n_run} kept pairs {kept}: device_ms={dev_ms} "
                     f"call_ms={call_ms:.5f} bound_ms={b_ms:.6f} ({b_by}) plain_ms={plain_ms:.5f} "
                     f"sdpa_ms={sdpa_ms:.5f} (kernel {top_device_kernel(sdpa)!r}) "
                     f"max|kernel-plain|={err:.3e}")
    modes.clear()

    # ---- embedding_lookup at the prefill's shape: bitwise, and its time
    ids = run.slots_dev(run.slots.reshape(-1).astype(np.int32))
    check(torch.equal(embedding_lookup_cuda(run.wt, ids), embedding_lookup_plain(run.wt, ids)),
          f"{arch} embedding_lookup at the prefill's shape: kernel != plain")
    el_dev = device_kernel_ms(lambda: embedding_lookup_cuda(run.wt, ids), ("lookup_kernel",),
                              iters=50)
    el_plain = cuda_ms(lambda: embedding_lookup_plain(run.wt, ids), iters=50)
    ids64 = ids.long()
    el_lib = cuda_ms(lambda: F.embedding(ids64, run.wt), iters=50)
    el_bound = bound_ms(nbytes=ids.numel() * 4 + (len(run.uniq) + ids.numel()) * cfg.d_model * 4,
                        flops=0.0)
    kernels = tuple(per_prefill)
    lines = lm_lines(name, run, checks, kernels)
    lines[0] += f"; {held}"
    lines.append(f"{name} kernels: embedding_lookup at the prefill's shape (ids {ids.numel()}, "
                 f"unique rows {len(run.uniq)}, D={cfg.d_model} fp32) == plain bitwise, "
                 f"device_ms={el_dev} bound_ms={el_bound[0]:.6f} ({el_bound[1]}) plain_ms="
                 f"{el_plain:.5f} library_ms={el_lib:.5f} (F.embedding); flash modes "
                 f"(hopper kernel vs plain and SDPA): " + ("; ".join(parts) or "none") +
                 f"; card {card()}")
    launches = {n: run.launches[n] for n in kernels}
    release(run)
    return launches, records, lines


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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


LM_TRAIN_LAYERS, LM_TRAIN_STEPS = 8, 3  # Yi-9B: 8 of its 48 layers
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 2  # OLMoE-1B-7B: 4 of its 16 layers
TRAIN_MICROBATCHES, TRAIN_LR = 2, 3e-4
# the flash Function's dq, dk, dv (bf16) against autograd of the naive
# attention in fp32 on the same bf16 values: max |diff| <= this * max |ref|
# (the bf16 rounding of each gradient is 2^-9 of it)
FLASH_BWD_TOL = 1e-2
# name, B, H, Hkv, Sq, Skv, Dh, causal, window: the training shapes of the
# flash backward (Yi-9B's; hymba-1.5b's window layers; whisper-tiny's
# encoder and cross attention)
FLASH_BWD_SHAPES = [
    ("yi_9b", 4, 32, 4, 2048, 2048, 128, True, 0),
    ("hymba_window", 4, 25, 5, 2176, 2176, 64, True, 1024),
    ("whisper_encoder", 4, 6, 6, 1500, 1500, 64, False, 0),
    ("whisper_cross", 4, 6, 6, 224, 1500, 64, False, 0),
]


@contextlib.contextmanager
def plain_lm_kernels():
    """Route the LM training path's kernel wrappers to their plain versions
    inside ``ops``' autograd Functions and ``adagrad_update`` (the same step
    on the card with no kernel of the port; the launch counters stay
    untouched). Attention's plain path is the caller's ``attn_impl``."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.fused_adagrad import adagrad_plain
    from repro_torch.kernels.moe_gmm import gmm_plain
    from repro_torch.kernels.scatter_add import scatter_add_plain_

    with swapped(kops, embedding_lookup_cuda=lambda t, ids: embedding_lookup_plain(t, ids),
                 scatter_add_cuda_=scatter_add_plain_,
                 gmm_cuda=lambda x, w, gs, tiles=None, mode=None: gmm_plain(x, w, gs),
                 adagrad_cuda=adagrad_plain):
        yield


def train_lm(cfg, base: Path, seed: int, *, steps: int, profile_step: int | None):
    """The launcher, ``repro_torch.launch.train.run``, on an NCCL world of one,
    counted: a fresh 2-node ``Cluster`` holding ``TableSpec("tok_emb",
    RowSchema.with_adagrad(d))``, fp32 weights from a seeded CUDA generator,
    ``TokenStream(vocab, 4, 2048, seed=0)`` (rows of 2,049 tokens: 2,048
    inputs and their shifted targets) -> ``client.session("tok_emb",
    inputs)`` -> ``make_lm_train_step_hier(cfg, TrainSettings(AdamW(lr=3e-4),
    microbatches=2))`` with the data-parallel gradient mean (an all-reduce
    over the world of one) -> ``s.commit``, ``steps`` times. The launch counts
    (and the flash backward's recomputes of ``attention_blockwise``) are
    zeroed just before and read just after; step ``profile_step`` runs
    under torch.profiler. Keeps step 1's inputs and outputs for the
    comparisons on the host, so the peak memory is the loop's own. Times
    the launcher's gradient reduction once more afterwards on a tree of the
    parameters' size (``allreduce_ms``)."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.moe_gmm import gmm_cuda
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as launch
    from repro_torch.models import common, get_model
    from repro_torch.train.optim import AdamW, tree_leaves
    from repro_torch.train.train_step import TrainSettings

    dev = torch.device("cuda")
    B, S = LM_BATCH, LM_PROMPT
    t0 = time.perf_counter()
    init = [get_model(cfg).init(cfg, torch.Generator(device=dev).manual_seed(seed))]
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    settings = TrainSettings(optimizer=AdamW(lr=TRAIN_LR), microbatches=TRAIN_MICROBATCHES)
    n_params = sum(t.numel() for t in tree_leaves(init[0]))
    recomputes = [0]
    real_blockwise = kops.attention_blockwise
    kept = {"first": None, "breakdown": None, "last": None}

    def blockwise(*a, **kw):  # the flash backward's recompute
        recomputes[0] += 1
        return real_blockwise(*a, **kw)

    def step_hook(i, step, args):
        out = []
        call = lambda: out.append(step(*args))
        if i == profile_step:
            kept["breakdown"] = device_breakdown(call, top=8)
        else:
            call()
        params, _, batch, wt, acc = args
        if i == 0:
            kept["first"] = tuple(_tree_map(lambda t: t.cpu(), v) for v in (
                params, batch, wt, acc, out[0][2]["loss"], out[0][3]))
        kept["last"] = (batch["tokens"].cpu().numpy(), out[0][3].cpu().numpy(),
                        out[0][4].cpu().numpy())
        return out[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # what is allocated before the run beyond the initial weights (earlier
    # phases' leftovers): the dryrun phase adds it to its predicted peak
    outside_bytes = torch.cuda.memory_allocated() - 4 * n_params
    kops.reset_launch_counts()
    with swapped(kops, attention_blockwise=blockwise):
        # the launcher holds the only reference, so step 1 frees the initial weights
        res = launch.run(cfg, settings, steps=steps, batch=B, seq=S, base=str(base),
                         ckpt_every=0, device=dev, params=init.pop(), step_hook=step_hook)
    launches = kops.launch_counts()
    flash_variants = dict(flash_attention_cuda.launches_by_variant)
    gmm_variants = dict(gmm_cuda.launches_by_variant)
    gmm_modes = dict(gmm_cuda.launches_by_mode)
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9
    losses = res.losses
    check(np.isfinite(losses).all(), f"{cfg.name} training losses {losses}")
    check(torch.distributed.get_backend() == "nccl" and torch.distributed.get_world_size() == 1,
          "the launcher did not run on an NCCL world of one")
    # the rows came back through commit: the last batch's rows, read again
    stream = TokenStream(cfg.vocab_size, B, S, seed=res.start)
    for _ in range(steps):
        toks = stream.next_batch()
    slots, rows, accs = kept["last"]
    with res.client.session("tok_emb", toks[:, :-1].astype(np.uint64), read_only=True) as r:
        check(np.array_equal(np.asarray(r.params)[r.slots], rows[slots])
              and np.array_equal(np.asarray(r.opt_state)[r.slots], accs[slots]),
              f"{cfg.name}: rows read back != the last step's committed rows")
    # the launcher's gradient mean on a tree of the parameters' size (AdamW's
    # m, fp32): all-reduce of each leaf over the world of one, then / 1
    mesh = launch.make_host_mesh()
    shd.install_constraints(mesh, shd.build_rules(cfg, mesh), cfg)
    try:
        grads_like = {"params": res.opt_state.m}
        allreduce_ms = cuda_ms(lambda: common.constrain_like_params(grads_like), iters=3,
                               warmup=1)
    finally:
        shd.clear_constraints()
    timings = dict(step_s=res.step_s, pull_s=res.pull_s, d2h_s=res.d2h_s,
                   commit_s=res.commit_s, n_working=res.n_working)
    del res, grads_like
    torch.cuda.empty_cache()
    return types.SimpleNamespace(
        cfg=cfg, settings=settings, first=kept["first"], losses=losses, **timings,
        launches=launches,
        flash_variants=flash_variants, gmm_variants=gmm_variants, gmm_modes=gmm_modes,
        recomputes=recomputes[0], allreduce_ms=allreduce_ms, allreduce_bytes=4 * n_params,
        peak_gb=peak_gb, peak_bytes=peak_bytes, outside_bytes=outside_bytes,
        breakdown=kept["breakdown"], profile_step=profile_step, t_init=t_init,
        n_params=n_params, steps=steps, tokens=B * S)


def _leaf_errs(got, want, prefix=()) -> dict:
    """max |got - want| / max |want| per leaf of two gradient trees (each
    leaf finite), keyed by its path."""
    if isinstance(got, dict):
        out = {}
        for k in got:
            out.update(_leaf_errs(got[k], want[k], prefix + (k,)))
        return out
    return {"/".join(prefix): rel_err("/".join(prefix), got, want)}


def train_grad_checks(run, *, capture=None) -> dict:
    """Step 1 of the counted run again, its gradients only
    (``make_lm_grads``: the same loss, microbatches and remat), on the
    kernels and on the plain versions (``plain_lm_kernels``, naive
    attention), and the plain versions with blockwise attention (two
    correct plain paths: the floor). The kernel rerun equals the counted
    step 1 bit for bit, in loss and in new rows (``fused_adagrad`` of its
    table gradient), so the comparisons hold the counted step. Loss within
    rtol 1e-2, every gradient leaf and the working table's within ``LM_TOL``
    of the plain path's largest. New rows: the first Adagrad step from a
    zero accumulator is ``lr * g / |g|``, so an element whose two gradients
    differ in sign steps apart by 2 * row_lr; wherever the plain path's
    table gradient is larger in magnitude than the largest difference
    between the two table gradients (so they share a sign), the kernel
    path's new rows lie within ``LM_TOL * row_lr`` of the plain path's
    (``adagrad_plain`` of its gradient). ``capture(tag)``: a context
    manager around each run (the MoE phase records routings and gmm
    operands)."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.fused_adagrad import adagrad_plain
    from repro_torch.train.train_step import make_lm_grads

    cfg, settings = run.cfg, run.settings
    p0, batch, wt, acc, loss1, new_t1 = (_tree_map(lambda t: t.cuda(), v) for v in run.first)
    capture = capture or (lambda tag: contextlib.nullcontext())
    grads = lambda impl: make_lm_grads(cfg, dataclasses.replace(settings, attn_impl=impl),
                                       hier=True)(p0, batch, wt)
    with capture("kernel"):
        kg, kt, km = grads("auto")
    with plain_lm_kernels(), capture("plain"):
        pg, pt, pm = grads("naive")
    new_k = kops.adagrad_update(wt, acc, kt, settings.row_lr)[0]
    rerun_rel = abs(float(km["loss"]) - float(loss1)) / abs(float(loss1))
    rerun_rows = float((new_k - new_t1).abs().max())
    check(rerun_rel == 0 and rerun_rows == 0,
          f"{cfg.name}: the rerun of step 1 is not the counted step: loss rel {rerun_rel}, "
          f"new rows max |diff| {rerun_rows}")
    errs = _leaf_errs(kg, pg)
    errs["working_table"] = rel_err("working table grad", kt, pt)
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(km["loss"]) - float(pm["loss"])) / abs(float(pm["loss"]))
    new_p = adagrad_plain(wt, acc, pt, settings.row_lr)[0]
    clear = pt.abs() > (kt - pt).abs().max()
    row_max = float((new_k - new_p).abs()[clear].max())
    check(row_max <= LM_TOL * settings.row_lr,
          f"{cfg.name}: new rows vs the plain path's {row_max} where the table gradients "
          f"share a sign, > {LM_TOL} * row_lr")
    share = float(clear.float().mean())
    with plain_lm_kernels():
        bg, bt, _ = grads("blockwise")
    floor = _leaf_errs(bg, pg)
    floor["working_table"] = rel_err("working table grad", bt, pt)
    del pg, pt, bg, bt
    check(loss_rel <= 1e-2 and errs[worst] <= LM_TOL,
          f"{cfg.name} step 1, kernels vs plain: loss rel {loss_rel}, worst gradient leaf "
          f"{worst} {errs[worst]} of its max |ref| > {LM_TOL}")
    torch.cuda.empty_cache()
    return dict(kt=kt, loss_rel=loss_rel, rerun_rel=rerun_rel, rerun_rows=rerun_rows,
                worst=worst, errs=errs, floor=floor, row_max=row_max, row_share=share)


def check_train_launches(run, gmm_products: int) -> dict:
    """The counted run launched exactly what one step's code launches, times
    the steps: per microbatch one embedding_lookup (the forward) and one
    scatter_add (its backward); per layer and microbatch two flash_attention
    (the forward and remat's recompute, all on the wgmma + TMA kernel), one
    recompute of ``attention_blockwise`` (the flash backward) and, for each
    of the layer's ``gmm_products`` expert products, three moe_gmm (the
    forward, remat's recompute and dx, counted by mode; all on the wgmma +
    TMA kernel); one fused_adagrad per step; nothing else. Returns the
    per-step counts."""
    L, M, n = run.cfg.n_layers, TRAIN_MICROBATCHES, run.steps
    per_step = {"embedding_lookup": M, "scatter_add": M, "fused_adagrad": 1,
                "flash_attention": 2 * L * M, "moe_gmm": 3 * gmm_products * L * M}
    want = {name: per_step.get(name, 0) * n for name in run.launches}
    check(run.launches == want, f"{run.cfg.name} training launches {run.launches}, want {want} "
          f"over {n} steps")
    check(run.flash_variants == {"hopper": want["flash_attention"], "simt": 0},
          f"{run.cfg.name} training flash_attention by kernel {run.flash_variants}")
    check(run.gmm_variants == {"hopper": want["moe_gmm"], "wmma": 0, "f32": 0},
          f"{run.cfg.name} training moe_gmm by kernel {run.gmm_variants}")
    want_modes = {"forward": 2 * gmm_products * L * M * n, "dx": gmm_products * L * M * n}
    check(run.gmm_modes == (want_modes if gmm_products else {}),
          f"{run.cfg.name} training moe_gmm by mode {run.gmm_modes}, want {want_modes}")
    check(run.recomputes == L * M * n, f"{run.cfg.name}: {run.recomputes} flash backward "
          f"recomputes, want {L * M * n}")
    return per_step


def train_lines(name: str, run, checks: dict, per_step: dict, extra: str = "") -> list[str]:
    cfg = run.cfg
    warm = run.step_s[1]
    ms = lambda xs: [round(x * 1e3, 1) for x in xs]
    floor_worst = max(checks["floor"], key=checks["floor"].get)
    lines = [
        f"{name}: {cfg.name} L={cfg.n_layers} d={cfg.d_model} heads={cfg.n_heads}/"
        f"{cfg.n_kv_heads} Dh={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
        + (f"experts={cfg.n_experts}/top{cfg.top_k} " if cfg.is_moe else "")
        + f"vocab={cfg.vocab_size} params={run.n_params} (fp32, AdamW m and v fp32) "
        f"init_s={run.t_init:.2f} batch={LM_BATCH}x{LM_PROMPT} microbatches={TRAIN_MICROBATCHES} "
        f"remat=on steps={run.steps} losses={[round(x, 5) for x in run.losses]} "
        f"step_ms={ms(run.step_s)} warm_step_ms={warm * 1e3:.1f} "
        f"tokens_per_s_warm={run.tokens / warm:.1f} peak_mem_gb={run.peak_gb:.2f} "
        f"(launch.train.run, NCCL world 1) grad_allreduce_ms={run.allreduce_ms:.3f} over "
        f"{run.allreduce_bytes} bytes fp32 (bound {2 * run.allreduce_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms: each byte read and written once) "
        f"n_working={run.n_working} session host_ms pull={ms(run.pull_s)} "
        f"d2h={ms(run.d2h_s)} commit={ms(run.commit_s)} launches={run.launches} (per step "
        f"{per_step}; flash by kernel {run.flash_variants}, moe_gmm by kernel "
        f"{run.gmm_variants} and by mode {run.gmm_modes}, flash backward recomputes {run.recomputes}) "
        f"step 1 vs plain (naive attention, plain lookup/scatter/gmm/adagrad): loss rel "
        f"{checks['loss_rel']:.3e}, worst gradient leaf {checks['worst']} "
        f"{checks['errs'][checks['worst']]:.3e} of its max |ref| (tol {LM_TOL}), working table "
        f"{checks['errs']['working_table']:.3e}; plain naive vs plain blockwise worst leaf "
        f"{floor_worst} {checks['floor'][floor_worst]:.3e}, working table "
        f"{checks['floor']['working_table']:.3e}; rerun of step 1 == the counted step (loss rel "
        f"{checks['rerun_rel']:.3e}, new rows max |diff| {checks['rerun_rows']:.3e}); new rows "
        f"vs the plain path's where |plain table grad| > max |table grad diff| "
        f"({checks['row_share']:.3e} of the elements) max |diff| {checks['row_max']:.3e} (tol {LM_TOL} * row_lr = "
        f"{LM_TOL * run.settings.row_lr:.4f}); rows read back after commit == committed{extra} "
        f"card {card()}",
        f"{name} gradient leaves, max |kernel - plain| / max |plain|: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in checks["errs"].items()}),
    ]
    if run.breakdown is not None:
        wall, dev_ms, top = run.breakdown
        lines.append(f"{name} breakdown (torch.profiler, step {run.profile_step + 1} of the "
                     f"counted run): wall_ms={wall:.1f} kernels_ms={dev_ms:.1f} "
                     f"busy={dev_ms / wall:.3f} top={top}; card {card()}")
    return lines


def measured_train(run, per_step: dict) -> dict:
    """What the dryrun phase holds its prediction of a training cell against:
    the cell (config, steps' tokens, working rows), the counted run's peak
    and what was allocated outside it, its warm step and launches per step."""
    return dict(cfg=run.cfg, settings=run.settings, peak_bytes=run.peak_bytes,
                outside_bytes=run.outside_bytes, warm_step_s=run.step_s[1],
                n_working=max(run.n_working), per_step=per_step)


def lm_train_phase(base: Path, seed: int):
    """LM training at Yi-9B's published widths, 8 of its 48 layers, in
    hier_ps mode on the card. Returns (launches, flash backward recomputes,
    lines, what the kernel-level backward checks take, what the dryrun
    phase measures against)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(LM_ARCH)
    check((full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.resolved_head_dim,
           full.d_ff, full.vocab_size, full.embedding_mode)
          == (48, 4096, 32, 4, 128, 11008, 64000, "hier_ps"), f"unexpected yi-9b widths {full}")
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    run = train_lm(cfg, base, seed, steps=LM_TRAIN_STEPS, profile_step=LM_TRAIN_STEPS - 1)
    per_step = check_train_launches(run, 0)
    checks = train_grad_checks(run)
    lines = train_lines("lm_train", run, checks, per_step)
    _, batch, wt, acc, _, _ = (_tree_map(lambda t: t.cuda(), v) for v in run.first)
    kernel_inputs = dict(ids=batch["tokens"].reshape(-1).int().contiguous(), wt=wt, acc=acc,
                         table_grad=checks["kt"])
    launches, recomputes = run.launches, run.recomputes
    run.first = None
    import torch

    torch.cuda.empty_cache()
    return launches, recomputes, lines, kernel_inputs, measured_train(run, per_step)


def moe_train_phase(base: Path, seed: int):
    """MoE training at OLMoE-1B-7B's published widths, 4 of its 16 layers, in
    hier_ps mode on the card: every moe_gmm launch (forward, recompute, dx)
    on the wgmma + TMA kernel; the gradients against the plain path; the
    tokens whose experts differ between the two; remat's recomputed routing
    equal to the forward's. Returns (launches, dx launches of moe_gmm, lines,
    layer 0's wi product operands, what the dryrun phase measures against)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import moe as moe_mod

    full = get_config(MOE_ARCH)
    check((full.n_layers, full.d_model, full.n_experts, full.top_k, full.d_ff,
           full.vocab_size, full.embedding_mode) == (16, 2048, 64, 8, 1024, 50304, "hier_ps"),
          f"unexpected olmoe-1b-7b widths {full}")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    run = train_lm(cfg, base, seed, steps=MOE_TRAIN_STEPS, profile_step=None)
    per_step = check_train_launches(run, 3)
    store = {"kernel": {}, "plain": {}}

    @contextlib.contextmanager
    def capture(tag):
        st = store[tag]
        real_route, real_gmm = moe_mod.route, kops.gmm

        def route(*a, **kw):
            r = real_route(*a, **kw)
            st.setdefault("routes", []).append(r.top_i)
            return r

        def gmm(x, w, gs, *, tiles=None):
            st.setdefault("gmm", (x.detach(), w.detach(), gs, tiles))
            return real_gmm(x, w, gs, tiles=tiles)

        with swapped(moe_mod, route=route), swapped(kops, gmm=gmm):
            yield

    checks = train_grad_checks(run, capture=capture)
    L = cfg.n_layers
    kr, pr = store["kernel"]["routes"], store["plain"]["routes"]
    check(len(kr) == len(pr) == 2 * L * TRAIN_MICROBATCHES,
          f"{len(kr)} / {len(pr)} routings, want {2 * L * TRAIN_MICROBATCHES}")
    # microbatch 0: layers 0..L-1 forward, then remat's recompute L-1..0
    same = all(torch.equal(kr[i], kr[2 * L - 1 - i]) for i in range(L))
    check(same, "remat's recomputed routing != the forward's")
    flips = [int((a.sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())
             for a, b in zip(kr[:L], pr[:L])]
    extra = (f"; remat recomputed routing == forward routing; tokens (of "
             f"{kr[0].shape[0]}) whose top-{cfg.top_k} experts differ, kernel vs plain step, "
             f"microbatch 0, per layer: {flips}")
    lines = train_lines("moe_train", run, checks, per_step, extra)
    launches, dx_launches = run.launches, run.gmm_modes["dx"]
    gmm_ops = store["kernel"]["gmm"]
    run.first = None
    del store
    torch.cuda.empty_cache()
    return launches, dx_launches, lines, gmm_ops, measured_train(run, per_step)


LAUNCH_ARCHS = ("yi-9b", "olmoe-1b-7b")  # smoke scale: an 8-layer Yi-9B checkpoint is ~26 GB
LAUNCH_STEPS, LAUNCH_CKPT_EVERY, LAUNCH_RESUME_STEPS = 4, 2, 2


def _launch_state(res, vocab: int):
    """A run's params, AdamW state and PS rows of every vocab id, on the host."""
    import numpy as np

    from repro_torch.train.optim import tree_leaves

    opt = [res.opt_state.step] + tree_leaves(res.opt_state.m) + tree_leaves(res.opt_state.v)
    with res.client.session("tok_emb", np.arange(vocab, dtype=np.uint64), read_only=True) as r:
        rows = np.concatenate([np.asarray(r.params)[r.slots], np.asarray(r.opt_state)[r.slots]], 1)
    return [t.cpu() for t in tree_leaves(res.params)], [t.cpu() for t in opt], rows


def launch_cli_phase(base: Path) -> tuple[dict, list[str]]:
    """The launcher's command line on the card at smoke scale, for each of
    ``LAUNCH_ARCHS``: ``python -m repro_torch.launch.train --arch A --scale
    smoke --steps 4 --ckpt-every 2`` and then ``--resume --steps 2`` as
    subprocesses, the archs' side by side (rc 0, "resumed from step 4", a
    step-6 checkpoint); in this process, while the first ones run, the same run (``launch.train.run``, the CLI's settings, counted)
    and its resume from the step-4 checkpoint with no steps: params, AdamW
    state and every vocab row of the PS equal the saved ones bitwise; and
    the CLI process's step-4 checkpoint equals this process's state bitwise
    (the same program from the same seeds). Returns (launches of the
    counted runs, lines)."""
    import os

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optim import AdamW, tree_leaves
    from repro_torch.train.train_step import TrainSettings

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = {arch: [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--scale",
                  "smoke", "--ckpt-dir", str(base / arch), "--ckpt-every",
                  str(LAUNCH_CKPT_EVERY)] for arch in LAUNCH_ARCHS}

    def start(extra: list) -> dict:
        """Every arch's CLI with ``extra``, at once."""
        return {arch: subprocess.Popen(cmd + extra, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True, env=env)
                for arch, cmd in cli.items()}

    def finish(procs: dict, what: str) -> dict:
        """Wait for ``procs`` -> their results, each with rc 0."""
        done = {}
        try:
            for arch, q in procs.items():
                out, err = q.communicate(timeout=600)
                done[arch] = subprocess.CompletedProcess(q.args, q.returncode, out, err)
        finally:
            for q in procs.values():
                if q.poll() is None:
                    q.kill()
                    q.wait()
        for arch, r in done.items():
            check(r.returncode == 0, f"launcher {arch}{what}: rc {r.returncode}\n"
                  f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        return done

    t0 = time.perf_counter()
    procs = start(["--steps", str(LAUNCH_STEPS)])
    try:  # this process's runs while the CLI's first runs go
        launches, inproc = {}, {}
        for arch in LAUNCH_ARCHS:
            cfg = get_smoke_config(arch)
            settings = TrainSettings(optimizer=AdamW(lr=3e-4), microbatches=1)  # the CLI's
            run_dir = str(base / f"{arch}_inproc")
            kops.reset_launch_counts()
            x = launch.run(cfg, settings, steps=LAUNCH_STEPS, ckpt_every=LAUNCH_CKPT_EVERY,
                           base=run_dir, device="cuda")
            launches[arch] = kops.launch_counts()
            want = {"embedding_lookup", "scatter_add", "fused_adagrad", "flash_attention"} | (
                {"moe_gmm"} if cfg.is_moe else set())
            check(want <= {k for k, v in launches[arch].items() if v},
                  f"launcher {arch}: launches {launches[arch]}")
            saved = _launch_state(x, cfg.vocab_size)
            y = launch.run(cfg, settings, steps=0, resume=True, ckpt_every=0, base=run_dir,
                           device="cuda")
            restored = _launch_state(y, cfg.vocab_size)
            check(y.start == LAUNCH_STEPS
                  and all(a.dtype == b.dtype and torch.equal(a, b)
                          for a, b in zip(saved[0] + saved[1], restored[0] + restored[1]))
                  and np.array_equal(saved[2], restored[2]),
                  f"launcher {arch}: the resumed state != the saved state")
            inproc[arch] = (x, saved)
            del y
    finally:
        firsts = finish(procs, "")
    t_first = time.perf_counter() - t0
    lines = []
    for arch in LAUNCH_ARCHS:  # the CLI's step-4 checkpoints, before the resumes add step 6
        x, saved = inproc[arch]
        tree, step, _, _ = ckpt.restore(str(base / arch / "ckpt"),
                                        {"params": x.params, "opt": x.opt_state},
                                        step=LAUNCH_STEPS)
        cli_leaves = ([tree["opt"].step] + tree_leaves(tree["opt"].m) + tree_leaves(tree["opt"].v))
        check(all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(
            saved[0] + saved[1], tree_leaves(tree["params"]) + cli_leaves)),
            f"launcher {arch}: the CLI's step-{LAUNCH_STEPS} checkpoint != this process's run")
        del tree
    t0 = time.perf_counter()
    seconds = finish(start(["--steps", str(LAUNCH_RESUME_STEPS), "--resume"]), " --resume")
    t_second = time.perf_counter() - t0
    for arch in LAUNCH_ARCHS:
        cfg = get_smoke_config(arch)
        first, second = firsts[arch], seconds[arch]
        (x, saved) = inproc.pop(arch)
        check(f"resumed from step {LAUNCH_STEPS}" in second.stdout,
              f"launcher {arch} --resume printed {second.stdout[-2000:]}")
        ck = str(base / arch / "ckpt")
        check(ckpt.latest_step(ck) == LAUNCH_STEPS + LAUNCH_RESUME_STEPS,
              f"launcher {arch}: latest checkpoint {ckpt.latest_step(ck)}")
        tail = lambda out: " | ".join(out.strip().splitlines()[-2:])
        lines.append(
            f"launch_cli: {arch} smoke (L={cfg.n_layers} d={cfg.d_model} batch 8 x 128, "
            f"AdamW 3e-4, 1 microbatch): `python -m repro_torch.launch.train --steps "
            f"{LAUNCH_STEPS} --ckpt-every {LAUNCH_CKPT_EVERY}` rc 0 ({tail(first.stdout)}); "
            f"`--resume --steps {LAUNCH_RESUME_STEPS}` rc 0, \"resumed from step "
            f"{LAUNCH_STEPS}\", latest checkpoint step {LAUNCH_STEPS + LAUNCH_RESUME_STEPS} "
            f"({tail(second.stdout)}); in process (NCCL world 1): losses "
            f"{[round(v, 5) for v in x.losses]}, launches {launches[arch]}, resume restored "
            f"params ({len(saved[0])} leaves), AdamW state ({len(saved[1])}) and {len(saved[2])} "
            f"PS rows bitwise; the CLI's step-{LAUNCH_STEPS} checkpoint == this process's state "
            f"bitwise; card {card()}")
        del x
    torch.cuda.empty_cache()
    lines.append(f"launch_cli: the {len(LAUNCH_ARCHS)} archs' CLI processes side by side: first "
                 f"runs in {t_first:.1f}s (this process's runs and resumes beside them), "
                 f"resumes in {t_second:.1f}s")
    return launches, lines


SHARDS = 4  # the per-shard bodies run in one process: S = 4 shards


def sharded_hbm_phase(ctr_cfg, n_lm: int, lm_ids, seed: int) -> tuple[list, dict, list[str]]:
    """The sharded working table on the card.

    * ``ShardedWorkingTable`` over the launcher's NCCL world of one (a real
      ``all_reduce`` and two ``all_to_all_single``): its three ops equal
      ``WorkingTable.get`` and ``.accumulate`` bitwise.
    * The S = 4 per-shard bodies (``psum_body``, ``accumulate_body``,
      ``a2a_serve_body``, ``a2a_restore_body``), every shard's run in this
      process with the exchanges done by hand, counted, against the same
      bodies on the plain versions on the card: bitwise (dyadic values, so
      ``scatter_add``'s sums are exact), and assembled equal to
      ``WorkingTable``.

    At two sizes: ctr-C-scaled's working set (the unique keys of one
    2048-example batch, d 8) with its first mini-batch's 256,000 slots, and
    ``lm_train``'s [``n_lm``, 4096] working table with step 1's 8,192 ids.
    Times per body (CUDA events), each kernel's device ms, its plain version
    and one PyTorch call (``F.embedding``, ``index_add_``) on shard 0's
    inputs, the bound, and ``plan_a2a``'s host ms. Returns (JSON records,
    launches by size, lines)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.hbm_ps import (
        ShardedWorkingTable,
        WorkingTable,
        a2a_restore_body,
        a2a_serve_body,
        accumulate_body,
        from_sharded_rows,
        plan_a2a,
        psum_body,
        to_sharded_rows,
    )
    from repro_torch.data.synthetic_ctr import SyntheticCTRStream
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.mesh import make_host_mesh

    dev, S = torch.device("cuda"), SHARDS
    rng = np.random.default_rng(seed)
    batch = SyntheticCTRStream(ctr_cfg.n_sparse_keys, ctr_cfg.nnz_per_example, ctr_cfg.n_slots,
                               ctr_cfg.batch_size, seed=TRAIN_STREAM_SEED).next_batch()
    uniq, inv = np.unique(batch.keys.reshape(-1), return_inverse=True)
    mb = ctr_cfg.batch_size // ctr_cfg.minibatches_per_batch
    sizes = {
        "ctr": (len(uniq), ctr_cfg.emb_dim, inv.reshape(batch.keys.shape)[:mb].reshape(-1)),
        "lm": (n_lm, 4096, lm_ids.cpu().numpy().reshape(-1)),
    }
    swt = ShardedWorkingTable(make_host_mesh(), "model")
    check(swt.n_shards == 1 and torch.distributed.get_backend() == "nccl",
          "the sharded table's world of one is not NCCL")
    records, launches, lines = [], {}, []
    for size, (n, d, ids) in sizes.items():
        ids = ids.astype(np.int32)
        B = len(ids)
        table_np = dyadic(rng, (n, d))
        table = torch.from_numpy(table_np).to(dev)
        sl = torch.from_numpy(ids).to(dev)
        grads = torch.from_numpy(dyadic(rng, (B, d))).to(dev)
        # the world of one over NCCL against WorkingTable
        t0 = time.perf_counter()
        req1, restore1 = plan_a2a(ids, 1)
        plan1_ms = (time.perf_counter() - t0) * 1e3
        one_ok = (torch.equal(swt.get_psum(table, sl), WorkingTable.get(table, sl))
                  and torch.equal(swt.accumulate(table, sl, grads),
                                  WorkingTable.accumulate(table, sl, grads))
                  and torch.equal(swt.get_a2a(table, torch.from_numpy(req1[0]).to(dev),
                                              torch.from_numpy(restore1[0]).to(dev)),
                                  WorkingTable.get(table, sl)))
        check(one_ok, f"sharded_hbm {size}: ShardedWorkingTable on NCCL world 1 != WorkingTable")
        # the S = 4 bodies, counted, on the kernels and on the plain versions
        shards = torch.from_numpy(to_sharded_rows(table_np, S)).to(dev).chunk(S)
        rps = shards[0].shape[0]
        t0 = time.perf_counter()
        req, restore = plan_a2a(ids, S)
        plan_ms = (time.perf_counter() - t0) * 1e3
        req_d, restore_d = torch.from_numpy(req).to(dev), torch.from_numpy(restore).to(dev)
        m = req.shape[-1]

        def bodies():
            out = {"psum": [psum_body(shards[r], sl, r, S) for r in range(S)],
                   "accumulate": [accumulate_body(shards[r], sl, grads, r, S) for r in range(S)],
                   "a2a_serve": [a2a_serve_body(shards[o], req_d[:, o].reshape(-1), S)
                                 for o in range(S)]}
            out["a2a_restore"] = [a2a_restore_body(
                torch.cat([out["a2a_serve"][o][r * m:(r + 1) * m] for o in range(S)]),
                restore_d[r]) for r in range(S)]
            return out

        torch.cuda.synchronize()
        kops.reset_launch_counts()
        k_out = bodies()
        torch.cuda.synchronize()
        launches[size] = kops.launch_counts()
        want = {name: 0 for name in launches[size]}
        want.update(embedding_lookup=3 * S, scatter_add=S)
        check(launches[size] == want, f"sharded_hbm {size}: launches {launches[size]}, want {want}")
        with plain_lm_kernels():
            p_out = bodies()
        check(kops.launch_counts() == launches[size], "the plain bodies launched a kernel")
        errs = {name: max(float((a - b).abs().max()) for a, b in zip(k_out[name], p_out[name]))
                for name in k_out}
        check(all(all(torch.equal(a, b) for a, b in zip(k_out[name], p_out[name]))
                  for name in k_out), f"sharded_hbm {size}: kernel bodies != plain, {errs}")
        assembled = (
            torch.equal(torch.stack(k_out["psum"]).sum(0), WorkingTable.get(table, sl))
            and torch.equal(torch.cat(k_out["a2a_restore"]), WorkingTable.get(table, sl))
            and np.array_equal(from_sharded_rows(torch.cat(k_out["accumulate"]).cpu().numpy(), n, S),
                               WorkingTable.accumulate(table, sl, grads).cpu().numpy()))
        check(assembled, f"sharded_hbm {size}: the assembled bodies != WorkingTable")
        del k_out, p_out

        # times on shard 0's inputs
        owned = (sl % S) == 0
        local_row = torch.where(owned, sl // S, 0)
        g0 = grads.masked_fill(~owned[:, None], 0.0)
        n_owned_rows = int(torch.unique(local_row[owned]).numel())
        calls = {
            "psum": lambda: psum_body(shards[0], sl, 0, S),
            "accumulate": lambda: accumulate_body(shards[0], sl, grads, 0, S),
            "a2a_serve": lambda: a2a_serve_body(shards[0], req_d[:, 0].reshape(-1), S),
        }
        body_ms = {name: cuda_ms(fn) for name, fn in calls.items()}
        with plain_lm_kernels():
            plain_body_ms = {name: cuda_ms(fn) for name, fn in calls.items()}
        lookup_ms = sum(device_kernel_ms(calls["psum"], ("lookup_kernel",)).values()) or None
        scatter_ms = sum(device_kernel_ms(calls["accumulate"], ("scatter_add_kernel",)).values()) or None
        lib_lookup = cuda_ms(lambda: F.embedding(local_row, shards[0]))
        lib_scatter = cuda_ms(lambda: shards[0].clone().index_add_(0, (sl // S).long(), g0))
        lk_bound = bound_ms(B * 4 + n_owned_rows * d * 4 + B * d * 4, 0.0)
        sc_bound = bound_ms(B * 4 + B * d * 4 + 2 * rps * d * 4, float(B * d))
        src = "src/repro_torch/csrc/"
        records += [
            {"name": f"embedding_lookup_sharded_{size}", "route": "cuda",
             "source": src + "embedding_lookup.cu",
             "replaces": "src/repro/kernels/embedding_lookup.py:32",
             "launches": launches[size]["embedding_lookup"], "max_abs_err": max(
                 errs["psum"], errs["a2a_serve"], errs["a2a_restore"]),
             "ms": lookup_ms if lookup_ms is not None else body_ms["psum"],
             "plain_ms": plain_body_ms["psum"], "bound_ms": lk_bound[0], "bound_by": lk_bound[1],
             "library_ms": lib_lookup, "body_ms": body_ms["psum"]},
            {"name": f"scatter_add_sharded_{size}", "route": "cuda",
             "source": src + "scatter_add.cu", "replaces": "src/repro/kernels/scatter_add.py:43",
             "launches": launches[size]["scatter_add"], "max_abs_err": errs["accumulate"],
             "ms": scatter_ms if scatter_ms is not None else body_ms["accumulate"],
             "plain_ms": plain_body_ms["accumulate"], "bound_ms": sc_bound[0],
             "bound_by": sc_bound[1], "library_ms": lib_scatter,
             "body_ms": body_ms["accumulate"]},
        ]
        lines.append(
            f"sharded_hbm {size}: table [{n}, {d}] fp32 over S={S} shards of {rps} rows, {B} ids "
            f"(shard 0 owns {int(owned.sum())}, {n_owned_rows} rows); ShardedWorkingTable on NCCL "
            f"world 1 == WorkingTable (get_psum, accumulate, get_a2a) bitwise; S={S} bodies: "
            f"launches {launches[size]}, kernel == plain bitwise {errs}, assembled == "
            f"WorkingTable bitwise; plan_a2a host ms S={S} {plan_ms:.3f} (m={m}), S=1 "
            f"{plan1_ms:.3f}; shard 0 body ms (call) {({k: round(v, 5) for k, v in body_ms.items()})}"
            f", plain {({k: round(v, 5) for k, v in plain_body_ms.items()})}; kernel device ms "
            f"lookup {lookup_ms} scatter_add {scatter_ms}; library F.embedding {lib_lookup:.5f} "
            f"index_add_ {lib_scatter:.5f}; bound lookup {lk_bound[0]:.6f} ({lk_bound[1]}), "
            f"scatter {sc_bound[0]:.6f} ({sc_bound[1]}); card {card()}")
        del shards, table, grads
        torch.cuda.empty_cache()
    return records, launches, lines


def train_backward_kernels_phase(lm_inputs: dict, gmm_ops, seed: int):
    """The training path's backward kernels against their plain versions on
    the card, at the shapes the path gives them, and their times beside the
    plain versions, one PyTorch call each and the bound:

    * the lookup's backward through scatter_add at step 1's 8,192 zipf ids x
      4096 (dyadic values: every sum exact, so equal to the plain autograd
      bitwise);
    * fused_adagrad at [n_working, 4096] on step 1's table gradient, bitwise;
    * the flash Function's dq, dk, dv against autograd of the naive attention
      in fp32 at ``FLASH_BWD_SHAPES``, within ``FLASH_BWD_TOL``;
    * gmm dx (the wgmma + TMA kernel over w transposed) and dw at OLMoE layer
      0's kept rows against autograd of ``gmm_plain``; dw is one
      ``torch._grouped_mm`` (``ops.gmm_dw``), timed beside a per-expert
      fp32 loop as its plain version.

    Returns (JSON records, max_abs_err by record, lines)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import collectives as coll
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.flash_attention import (
        attention_mask,
        flash_attention_cuda,
        flash_attention_plain,
    )
    from repro_torch.kernels.fused_adagrad import adagrad_cuda, adagrad_plain
    from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.kernels.scatter_add import cost as scatter_add_cost
    from repro_torch.kernels.scatter_add import scatter_add_cuda_

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed)
    dy = lambda *shape: (torch.randint(-128, 128, shape, generator=g) / 16.0).to(dev)
    grad = lambda out, ins, cot: torch.autograd.grad(out, ins, cot, retain_graph=True)
    lines, records = [], {}

    # ---- the lookup's backward through scatter_add, bitwise
    ids, wt = lm_inputs["ids"], lm_inputs["wt"]
    (n_working, D), B = wt.shape, ids.numel()
    table, cot = dy(n_working, D), dy(B, D)
    tk, tp = table.clone().requires_grad_(), table.clone().requires_grad_()
    out_k, out_p = kops.embedding_lookup(tk, ids), embedding_lookup_plain(tp, ids)
    before = scatter_add_cuda_.launches
    (dk,) = grad(out_k, tk, cot)
    check(scatter_add_cuda_.launches == before + 1, "the lookup's backward did not launch "
          "scatter_add once")
    (dp,) = grad(out_p, tp, cot)
    check(torch.equal(out_k, out_p) and torch.equal(dk, dp),
          f"embedding_lookup backward at {B} ids x {D}: kernel path != plain autograd")
    try:
        kops.embedding_lookup(table.bfloat16().requires_grad_(), ids).sum().backward()
        check(False, "a bf16 gradient reached the card's scatter_add")
    except TypeError:
        pass
    sid, order = torch.sort(ids, stable=True)
    srows = cot[order].contiguous()
    work = torch.zeros_like(table)
    counts = torch.bincount(ids.long())
    ids64 = ids.long()
    lookup_bwd = {
        "ms": sum(device_kernel_ms(lambda: scatter_add_cuda_(work, sid, srows),
                                   ("scatter_add_kernel",)).values()) or None,
        "backward_ms": cuda_ms(lambda: grad(out_k, tk, cot)),
        "plain_ms": cuda_ms(lambda: grad(out_p, tp, cot)),
        "library_ms": cuda_ms(lambda: work.index_add_(0, ids64, cot)),
    }
    check(lookup_bwd["ms"] is not None, "the profiler saw no scatter_add_kernel device time")
    sc_flops, sc_bytes = scatter_add_cost(B, D, int(torch.unique(ids).numel()))
    lookup_bwd["bound_ms"], lookup_bwd["bound_by"] = bound_ms(nbytes=sc_bytes, flops=sc_flops)
    records["embedding_lookup_backward"] = lookup_bwd
    lines.append(
        f"lookup backward (scatter_add at D={D}): ids {B} over {n_working} rows, longest run "
        f"{int(counts.max())}, kernel device_ms={lookup_bwd['ms']:.5f} whole backward (sort, "
        f"gather, zeros, kernel) ms={lookup_bwd['backward_ms']:.5f} plain autograd "
        f"ms={lookup_bwd['plain_ms']:.5f} index_add_ ms={lookup_bwd['library_ms']:.5f} "
        f"bound_ms={lookup_bwd['bound_ms']:.6f} ({lookup_bwd['bound_by']}); equal bitwise")
    del tk, tp, out_k, out_p, dk, dp, work, srows

    # ---- fused_adagrad at the working set's shape, bitwise
    tg = lm_inputs["table_grad"]
    acc = torch.rand(n_working, D, generator=g).to(dev)
    kp, ka = adagrad_cuda(wt, acc, tg, 0.05)
    pp, pa = adagrad_plain(wt, acc, tg, 0.05)
    check(torch.equal(kp, pp) and torch.equal(ka, pa),
          f"fused_adagrad at [{n_working}, {D}] != plain")
    run_ag = lambda: adagrad_cuda(wt, acc, tg, 0.05)
    lib_p, lib_a, lib_g, lib_step = wt.clone(), acc.clone(), tg.clone(), torch.zeros((), device=dev)
    lib_ag = lambda: torch._fused_adagrad_([lib_p], [lib_g], [lib_a], [lib_step], lr=0.05,
                                           lr_decay=0.0, weight_decay=0.0, eps=1e-8,
                                           maximize=False)
    try:  # the yardstick only
        lib_ag()
        ag_lib = cuda_ms(lib_ag)
    except (AttributeError, RuntimeError, TypeError):
        ag_lib = None
    ag = {"ms": sum(device_kernel_ms(run_ag, ("adagrad_vec4_kernel", "adagrad_scalar_kernel"),
                                     iters=50).values()) or None,
          "plain_ms": cuda_ms(lambda: adagrad_plain(wt, acc, tg, 0.05)), "library_ms": ag_lib}
    check(ag["ms"] is not None, "the profiler saw no fused_adagrad device time")
    ag["bound_ms"], ag["bound_by"] = bound_ms(nbytes=5.0 * wt.numel() * 4, flops=7.0 * wt.numel())
    records["fused_adagrad_lm"] = ag
    lines.append(f"fused_adagrad at [{n_working}, {D}]: device_ms={ag['ms']:.5f} plain_ms="
                 f"{ag['plain_ms']:.5f} library_ms={ag_lib} bound_ms={ag['bound_ms']:.6f} "
                 f"({ag['bound_by']}); equal bitwise")
    del kp, ka, pp, pa

    # ---- the flash backward (recompute) against fp32 naive attention
    shapes, errs = {}, []
    mk = lambda *shape: torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    for name, Bq, H, Hkv, Sq, Skv, Dh, causal, window in FLASH_BWD_SHAPES:
        q, k, v = (t.requires_grad_() for t in (mk(Bq, H, Sq, Dh), mk(Bq, Hkv, Skv, Dh),
                                                   mk(Bq, Hkv, Skv, Dh)))
        do = mk(Bq, H, Sq, Dh)
        kw = dict(causal=causal, window=window)
        before = dict(flash_attention_cuda.launches_by_variant)
        out = kops.flash_attention(q, k, v, **kw)
        check(flash_attention_cuda.launches_by_variant["hopper"] == before["hopper"] + 1,
              f"flash backward {name}: the forward did not take the hopper kernel")
        got = grad(out, (q, k, v), do)
        ref_in = [t.detach().float().requires_grad_() for t in (q, k, v)]
        want = grad(attention_ref(*ref_in, **kw), ref_in, do.float())
        rels = [rel_err(f"flash backward {name} d{n}", a, b) for n, a, b in zip("qkv", got, want)]
        check(max(rels) <= FLASH_BWD_TOL, f"flash backward {name}: dq, dk, dv {rels} of max "
              f"|ref| > {FLASH_BWD_TOL}")
        errs.append(max(float((a.float() - b).abs().max()) for a, b in zip(got, want)))
        del want, ref_in
        torch.cuda.empty_cache()
        p_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        p_out = flash_attention_plain(*p_in, **kw)
        s_in = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        if window:  # SDPA has no window: an explicit mask
            mask = attention_mask(Sq, Skv, causal=causal, window=window, q_offset=0, device=dev)
            s_out = F.scaled_dot_product_attention(*s_in, attn_mask=mask, enable_gqa=True)
        else:
            s_out = F.scaled_dot_product_attention(*s_in, is_causal=causal, enable_gqa=True)
        kept = Bq * H * kept_pairs(Sq, Skv, causal=causal, window=window, q_offset=0)
        b_ms, b_by = bound_ms(nbytes=2.0 * (4 * q.numel() + 4 * k.numel()),
                              flops=10.0 * Dh * kept, peak=BF16_FLOPS)
        shapes[name] = {"ms": cuda_ms(lambda: grad(out, (q, k, v), do), iters=5, warmup=1),
                        "plain_ms": cuda_ms(lambda: grad(p_out, p_in, do), iters=3, warmup=1),
                        "library_ms": cuda_ms(lambda: grad(s_out, s_in, do), iters=10),
                        "bound_ms": b_ms, "bound_by": b_by, "max_rel_err": max(rels)}
        lines.append(
            f"flash backward {name} q {tuple(q.shape)} kv {tuple(k.shape)} causal={causal} "
            f"window={window} kept pairs {kept}: dq/dk/dv vs fp32 naive {[f'{r:.2e}' for r in rels]}"
            f" (tol {FLASH_BWD_TOL}); backward ms={shapes[name]['ms']:.3f} (blockwise recompute "
            f"fp32 + autograd) plain_ms={shapes[name]['plain_ms']:.3f} sdpa_backward_ms="
            f"{shapes[name]['library_ms']:.4f} (kernel {top_device_kernel(lambda: grad(s_out, s_in, do), iters=2)!r}) "
            f"bound_ms={b_ms:.5f} ({b_by})")
        del q, k, v, do, out, got, p_in, p_out, s_in, s_out
        torch.cuda.empty_cache()
    yi = dict(shapes["yi_9b"])
    records["flash_attention_backward"] = {
        **{k: yi[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "shapes": shapes,
        "note": "no kernel of the port: attention_blockwise recomputed under autograd, as the "
                "reference's _flash_bwd (a vjp of plain jnp, no Pallas kernel); ms per backward"}
    err = {"flash_attention_backward": max(errs), "embedding_lookup_backward": 0.0,
           "fused_adagrad_lm": 0.0}

    # ---- gmm dx and dw at OLMoE layer 0's kept rows
    x, w, gs, tiles = gmm_ops
    T, K = x.shape
    E, _, N = w.shape
    n_live, hit = int(gs.sum()), int((gs > 0).sum())
    cot = mk(T, N)
    xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
    xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(gmm_cuda.launches_by_variant)
    out_k = kops.gmm(xk, wk, gs, tiles=tiles)
    dxk, dwk = grad(out_k, (xk, wk), cot)
    check(gmm_cuda.launches_by_variant == {**before, "hopper": before["hopper"] + 2},
          f"gmm forward + dx took {gmm_cuda.launches_by_variant} from {before}, want 2 hopper")
    out_p = gmm_plain(xp, wp, gs)
    dxp, dwp = grad(out_p, (xp, wp), cot)
    err["moe_gmm_backward"] = max(gmm_close("dx at layer 0's kept rows", dxk, dxp),
                                  gmm_close("dw at layer 0's kept rows", dwk, dwp))
    wT = w.transpose(1, 2).contiguous()
    run_dx = lambda: gmm_cuda(cot, wT, gs, tiles=tiles)
    lib_dx = grouped_mm_call(cot, wT, gs)
    dx_rec = {"ms": sum(device_kernel_ms(run_dx, ("gmm_hopper_kernel",)).values()) or None,
              "plain_ms": cuda_ms(lambda: gmm_plain(cot, wT, gs), iters=3, warmup=1),
              "library_ms": cuda_ms(lib_dx) if lib_dx is not None else None,
              "transpose_ms": cuda_ms(lambda: w.transpose(1, 2).contiguous())}
    check(dx_rec["ms"] is not None, "the profiler saw no gmm_hopper_kernel device time")
    # dx reads dy's live rows and the weights of the experts that hold rows,
    # and writes all T rows (zeros past the last group)
    dx_rec["bound_ms"], dx_rec["bound_by"] = bound_ms(
        nbytes=2.0 * (n_live * N + hit * N * K + T * K), flops=2.0 * n_live * K * N,
        peak=BF16_FLOPS)

    def dw_plain():
        out = torch.zeros((E, K, N), dtype=w.dtype, device=dev)
        start = 0
        for e, n in enumerate(gs.tolist()):
            out[e] = (x[start:start + n].float().T @ cot[start:start + n].float()).to(w.dtype)
            start += n
        return out

    dw_ms = cuda_ms(lambda: kops.gmm_dw(x, cot, gs), iters=10)
    dw_rec = {"ms": dw_ms, "plain_ms": cuda_ms(dw_plain, iters=3, warmup=1), "library_ms": dw_ms}
    # dw reads x's and dy's live rows and writes every expert's [K, N]
    dw_rec["bound_ms"], dw_rec["bound_by"] = bound_ms(
        nbytes=2.0 * (n_live * K + n_live * N + E * K * N), flops=2.0 * n_live * K * N,
        peak=BF16_FLOPS)
    records["moe_gmm_backward"] = {**dx_rec, "dw": dw_rec,
                                   "note": "ms is dx on the moe_gmm kernel; dw is one "
                                           "torch._grouped_mm (the library call itself), as "
                                           "the reference's einsum autodiff"}
    fmt = lambda v: "null" if v is None else f"{v:.5f}"
    lines.append(
        f"gmm backward at layer 0's kept rows (x [{T}, {K}], w [{E}, {K}, {N}], {n_live} live "
        f"rows): dx on the hopper kernel over w^T device_ms={dx_rec['ms']:.5f} (+ w^T copy "
        f"{dx_rec['transpose_ms']:.5f}) plain_ms={dx_rec['plain_ms']:.5f} torch._grouped_mm_ms="
        f"{fmt(dx_rec['library_ms'])} bound_ms={dx_rec['bound_ms']:.6f} ({dx_rec['bound_by']}); "
        f"dw (one torch._grouped_mm over the live rows) ms={dw_rec['ms']:.5f} plain_ms="
        f"{dw_rec['plain_ms']:.5f} bound_ms={dw_rec['bound_ms']:.6f} "
        f"({dw_rec['bound_by']}); dx and dw vs autograd of gmm_plain max |diff| "
        f"{err['moe_gmm_backward']:.3e}; card {card()}")
    return records, err, lines


# (arch, model axis M, tokens a row, the published config's cuts), keyed by
# (arch, M): M gloo ranks on the one card, a (data 1, model M) mesh; each
# published width kept. Yi-9B at 2 of its 48 layers; OLMoE-1B-7B at 2 of its
# 16 (its 4-layer world-of-one step peaked at 55.96 GB, and the ranks share
# the card); whisper-tiny whole at M = 2 and at M = 4 (1.5 heads' columns a
# rank, kv replicated); xlstm-1.3b at 8 of its 48 blocks (7 mLSTM + 1
# sLSTM: its step is the sLSTM's eager loop, so fewer mLSTM blocks save no
# time) at 1,024 tokens a row (at 512 its bf16 table gradients differ from
# the world of one's by more than any of them, and the new rows' sign test
# has nothing left to hold); hymba-1.5b at 2 of its 32 layers (layer 0
# global, layer 1 windowed) at M = 5, the first axis that its 25 heads over
# 5 kv heads divide by (its MLP's 5,504 and vocabulary's 32,001 do not: they
# stay whole), and at M = 2, where the rules cut wq's columns inside a head
# (12.5 heads a rank: rank 0 attends with heads 0-11, rank 1 with 12-24,
# which start at offset 2 of kv group 2); phi3.5-moe-42b-a6.6b at 1 of its
# 32 layers at M = 5, which does not divide its 16 experts: model inside
# each expert's mlp (6,400 columns -> 1,280 a rank). Consecutive cells of
# one config share one world of one.
TP_CELLS = (
    ("yi-9b", 2, LM_PROMPT, {"n_layers": 2}),
    ("olmoe-1b-7b", 2, LM_PROMPT, {"n_layers": 2}),
    ("whisper-tiny", 2, AUDIO_PROMPT, {}),
    ("whisper-tiny", 4, AUDIO_PROMPT, {}),
    ("xlstm-1.3b", 2, LM_PROMPT // 2, {"n_layers": 8}),
    ("hymba-1.5b", 5, LM_PROMPT, {"n_layers": 2, "global_attn_layers": (0,)}),
    ("hymba-1.5b", 2, LM_PROMPT, {"n_layers": 2, "global_attn_layers": (0,)}),
    ("phi3.5-moe-42b-a6.6b", 5, LM_PROMPT, {"n_layers": 1}),
)
# the cells whose model-axis collective bytes a step are held equal to the
# dry run's count (the others' are printed, untraced)
TP_COLLECTIVE_CELLS = {("hymba-1.5b", 2), ("whisper-tiny", 4), ("phi3.5-moe-42b-a6.6b", 5)}
TP_STEPS = 2
HOST_CORES = 8  # the card's machine: each rank of a run of W ranks takes 8 // W threads
TP_RUN_TIMEOUT = 600  # seconds for one run of the pool
# the compute dtypes of step 1's gradients held against the world of one,
# per arch (bf16 among them: the steps' compute): the first is checked
# (within LM_TOL), the rest printed
TP_GRAD_DTYPES = {"xlstm-1.3b": ("fp32", "bf16"), "hymba-1.5b": ("fp32", "bf16")}
# the compute dtypes of the world of one's one-ulp weight-jitter witness,
# printed beside the TP gaps in that compute (xlstm's fp32 one, measured
# until its TP gap was settled as rounding, is left out for time)
TP_ULP_WITNESS = {"hymba-1.5b": ("fp32", "bf16")}
# the kernel wrappers a TP step reaches, by their names in ``kernels.ops``
TP_WRAPPERS = {"flash_attention": "flash_attention_cuda", "moe_gmm": "gmm_cuda",
               "embedding_lookup": "embedding_lookup_cuda", "scatter_add": "scatter_add_cuda_",
               "fused_adagrad": "adagrad_cuda"}


def _tp_cell(arch: str, M: int):
    """(cfg, seq) of the ``TP_CELLS`` entry of ``arch`` at a model axis of
    ``M``."""
    import dataclasses

    from repro_torch.configs import get_config

    _, _, seq, cuts = next(c for c in TP_CELLS if c[:2] == (arch, M))
    return dataclasses.replace(get_config(arch), **cuts), seq


def _cell_key(arch: str, M: int) -> str:
    return f"{arch}_m{M}"


# FSDP over data beside tensor parallelism: the TP_CELLS entry of this arch
# again on a (data FSDP_DATA, model M) mesh of data x M gloo ranks sharing
# the card, the same global batch (LM_BATCH sequences in TRAIN_MICROBATCHES
# microbatches: one microbatch of LM_BATCH / FSDP_DATA sequences a data rank)
FSDP_ARCH, FSDP_DATA = "yi-9b", 2


def _tp_mesh(M: int, data: int = 1, groups=None):
    """A (data, M) ``("data", "model")`` mesh for the placement functions;
    ``groups``: {axis: process group} it hands out (the installed ones)."""
    return types.SimpleNamespace(shape=(data, M), mesh_dim_names=("data", "model"),
                                 get_group=lambda axis: (groups or {}).get(axis))


# the collective doors a step calls, by their names in ``repro_torch.collectives``
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into", "reduce_scatter", "gather")


def counted_collectives(counts: dict, groups: dict):
    """``swapped`` keywords wrapping each door of ``repro_torch.collectives``
    so that it adds its operand bytes (as the dry run's recorder counts
    them: an all_reduce's or reduce_scatter's whole tensor, an all_gather's
    part) to ``counts[f"{kind}/{axis}"]``, the axis found among ``groups``
    ({axis: process group}), "world" otherwise."""
    from repro_torch import collectives as coll

    def wrap(name):
        fn = getattr(coll, name)
        kind = "all_gather" if name == "all_gather_into" else name

        def call(*args, **kw):
            group = kw.get("group")
            t = args[1] if name in ("all_gather", "all_gather_into", "reduce_scatter") else args[0]
            axis = next((a for a, g in groups.items() if g is not None and g is group), "world")
            key = f"{kind}/{axis}"
            counts[key] = counts.get(key, 0) + t.numel() * t.element_size()
            return fn(*args, **kw)
        return call

    return {name: wrap(name) for name in COLLECTIVES}


def _grads_by_dtype(cfg, settings, args) -> dict:
    """Step 1's (param grads, table grad, loss) for each of the cell's
    ``TP_GRAD_DTYPES`` (bf16 alone by default)."""
    import torch

    from repro_torch.train.train_step import make_lm_grads

    params, _, batch, wt, _ = args
    out = {}
    for name in TP_GRAD_DTYPES.get(cfg.name, ("bf16",)):
        dtype = torch.float32 if name == "fp32" else torch.bfloat16
        with compute_dtype(dtype):
            g, tg, m = make_lm_grads(cfg, settings, hier=True)(params, batch, wt)
        out[name] = (g, tg, float(m["loss"]))
    return out


def mask_mode(Sq: int, Skv: int, causal: bool, window: int) -> str:
    """A flash launch's mask mode: ``causal`` (whole causal self attention),
    ``window``, ``full`` (not causal) or ``cross`` (not causal, Sq != Skv)."""
    if window:
        return "window"
    if causal:
        return "causal"
    return "full" if Sq == Skv else "cross"


def ulp_jittered_grads(cfg, settings, args, seed: int, name: str = "fp32"):
    """Step 1's (param grads, table grad) with ``name``'s compute (fp32 or
    bf16; ``make_lm_grads``, as ``_grads_by_dtype``) from ``args``' weights
    each moved by one ulp of that dtype (2^-23 or 2^-8 of it), up or down
    by a seeded coin: how far rounding alone moves them at the cell's
    size."""
    import torch

    from repro_torch.train.train_step import make_lm_grads

    params, _, batch, wt, _ = args
    gen = torch.Generator(device=wt.device).manual_seed(seed + 1)
    dtype, ulp = (torch.float32, 2.0 ** -23) if name == "fp32" else (torch.bfloat16, 2.0 ** -8)

    def jitter(t):
        sign = torch.randint(0, 2, t.shape, generator=gen, device=t.device) * 2 - 1
        return t * (1 + sign * ulp)

    with compute_dtype(dtype):
        return make_lm_grads(cfg, settings, hier=True)(_tree_map(jitter, params), batch, wt)[:2]


def flash_mode(q, k, kw) -> str:
    """:func:`mask_mode` of a flash call's q, k and keywords."""
    return mask_mode(q.shape[2], k.shape[2], kw.get("causal", True), kw.get("window", 0))


def flash_key(mode: str) -> str:
    """The record name of flash's ``mode``: ``flash_attention`` (causal) or
    ``flash_attention_<mode>``."""
    return "flash_attention" if mode == "causal" else f"flash_attention_{mode}"


def tp_flash_shapes(cfg, M: int, seq: int, rank: int) -> dict:
    """The local q, k, v shapes of each flash mode a TP step of ``cfg``
    launches on ``rank`` of a model axis of ``M``: {mode: [q, k, v]}: its
    whole q heads (``common.block_range``, uneven where the rules cut
    ``wq``'s columns inside a head; all of them where ``M`` does not divide
    the columns) and the kv heads they read (their own where the rules put
    the kv heads on ``model``)."""
    from repro_torch.models.common import block_range, kv_heads_read

    b, Dh = LM_BATCH // TRAIN_MICROBATCHES, cfg.resolved_head_dim
    whole = (cfg.n_heads * Dh) % M != 0  # wq's columns whole: attention runs whole
    lo, hi = (0, cfg.n_heads) if whole else block_range(cfg.n_heads, rank, M)
    H = hi - lo
    kv_lo, kv_hi, _ = kv_heads_read(lo, hi, cfg.n_heads // cfg.n_kv_heads)
    Hkv = cfg.n_kv_heads // M if cfg.n_kv_heads % M == 0 and not whole else kv_hi - kv_lo
    shape = lambda h, s: [b, h, s, Dh]
    if cfg.family == "ssm":
        return {}
    if cfg.family == "audio":
        S, F = seq, cfg.n_frames
        return {"causal": [shape(H, S)] * 3, "full": [shape(H, F)] * 3,
                "cross": [shape(H, S), shape(Hkv, F), shape(Hkv, F)]}
    S = seq + cfg.n_meta_tokens
    qkv = [shape(H, S), shape(Hkv, S), shape(Hkv, S)]
    return {"causal": qkv, "window": qkv} if cfg.family == "hybrid" else {"causal": qkv}


def tp_attention_calls(cfg) -> dict:
    """Attention calls in one forward of ``cfg``, by mask mode."""
    if cfg.family == "audio":
        return {"causal": cfg.n_layers, "full": cfg.encoder_layers, "cross": cfg.n_layers}
    if cfg.family == "hybrid":
        n_global = len(cfg.global_attn_layers)
        return {"causal": n_global, "window": cfg.n_layers - n_global}
    return {} if cfg.family == "ssm" else {"causal": cfg.n_layers}


def offset_flash_record(args: list, kw: dict) -> dict:
    """Flash at a rank's first call of a mask mode whose q heads start
    inside a kv group (``head_offset`` > 0): the hopper kernel on the bf16
    inputs and the SIMT kernel on them in fp32, each against the plain
    version with the same offset (bf16 rtol 2^-6, atol 2e-5; fp32 2e-5),
    timed beside SDPA on kv expanded to one kv head per q head (the
    expansion not timed) -> the kernel record of the hopper run, with the
    SIMT one under ``simt``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        attention_mask,
        cost,
        flash_attention_cuda,
        flash_attention_plain,
    )

    q, k, v = args[:3]
    Bq, H, Sq, Dh = q.shape
    g, off = kw["group"], kw["head_offset"]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    heads = (torch.arange(H, device=q.device) + off) // g
    ke, ve = k[:, heads].contiguous(), v[:, heads].contiguous()  # one kv head per q head
    mask = attention_mask(Sq, k.shape[2], causal=causal, window=window,
                          q_offset=kw.get("q_offset", 0), device=q.device)
    rec = {}
    for variant, dtype in (("hopper", torch.bfloat16), ("simt", torch.float32)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        run = lambda: flash_attention_cuda(qq, kk, vv, variant=variant, **kw)
        got, want = run(), flash_attention_plain(qq, kk, vv, **kw)
        if dtype == torch.bfloat16:
            within = flash_within(got, want)
        else:
            within = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
        kernel = f"flash_attention_{variant}_kernel"
        flops, nbytes = cost(Bq, H, k.shape[1], Sq, k.shape[2], Dh, causal=causal,
                             window=window, q_offset=kw.get("q_offset", 0),
                             elem_bytes=qq.element_size())
        kl, vl = ke.to(dtype), ve.to(dtype)
        if window:  # SDPA has no window: an explicit mask
            sdpa = lambda: F.scaled_dot_product_attention(qq, kl, vl, attn_mask=mask)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qq, kl, vl, is_causal=causal)
        r = dict(ms=sum(device_kernel_ms(run, (kernel,)).values()),
                 plain_ms=cuda_ms(lambda: flash_attention_plain(qq, kk, vv, **kw), iters=3,
                                  warmup=1),
                 library_ms=cuda_ms(sdpa),
                 max_abs_err=float((got.float() - want.float()).abs().max()),
                 within_tol=within, tol=("rtol 2^-6, atol 2e-5 (bf16)" if dtype == torch.bfloat16
                                         else "2e-5 (fp32)"),
                 shape=[list(t.shape) for t in (q, k, v)], group=g, head_offset=off,
                 mode=flash_mode(q, k, kw))
        r["bound_ms"], r["bound_by"] = bound_ms(
            nbytes=nbytes, flops=flops, peak=BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS)
        rec[variant] = r
    return {**rec.pop("hopper"), "simt": rec["simt"]}


def tp_rank_main(arch: str, M: int, out: Path, seed: int, data: int = 1) -> int:
    """One rank of a ``tp_train`` run (called by :func:`tp_pool_main` with
    the ``torchrun`` environment set): ``launch.train.run(...,
    model_parallel=M, backend="gloo")``
    on ``data`` x M ranks (FSDP over ``data`` above 1) from the world of
    one's seeded weights (``TP_CELLS``), each data rank training its share
    of the global batch in ``TRAIN_MICROBATCHES / data`` microbatches.
    Before step 1 it computes that step's gradients (``make_lm_grads``, in
    each of the cell's ``TP_GRAD_DTYPES``) and gathers them over ``data``
    and ``model`` to rank 0, which writes them, and after step 1 its new
    working rows, gathered over ``model``; each kernel wrapper's shapes are
    recorded, and its launches over the steps read from the counts it keeps
    where it launches (flash's by mask mode); each step's collective
    operand bytes are counted by kind and mesh axis at the doors of
    ``repro_torch.collectives``; after each step every leaf is held, over
    each axis it is whole on, against that group's first rank's, bitwise. Then rank 0 times each kernel (flash by mask
    mode) at its first call's TP inputs against its plain version and one
    PyTorch call, while the other ranks wait, and records whether each is
    within its tolerance (``within_tol``; :func:`tp_train_phase` checks
    it); then each other rank whose heads start inside a kv group does the
    same, in turn, for flash at its first call of each mask mode with that
    head offset: the hopper kernel in bf16 and the SIMT one on the same
    inputs in fp32, each against the plain version (``offset_timing``).
    Writes ``rank{r}.json``."""
    import os

    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from repro_torch import collectives as coll
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels.embedding_lookup import embedding_lookup_plain
    from repro_torch.kernels.flash_attention import (
        attention_mask,
        flash_attention_cuda,
        flash_attention_plain,
    )
    from repro_torch.kernels.fused_adagrad import adagrad_plain
    from repro_torch.kernels.moe_gmm import gmm_cuda, gmm_plain
    from repro_torch.kernels.scatter_add import cost as scatter_add_cost
    from repro_torch.kernels.scatter_add import scatter_add_plain_
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.models import common, get_model
    from repro_torch.train.optim import AdamW, tree_leaves
    from repro_torch.train.train_step import TrainSettings, replicated_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = init_distributed("cuda", init_method=os.environ["INIT_METHOD"], backend="gloo")
    dev, root = info.device, info.rank == 0
    dist.barrier()  # the run's seconds count from the ranks' meeting
    t_start = time.time()
    cfg, seq = _tp_cell(arch, M)
    settings = TrainSettings(optimizer=AdamW(lr=TRAIN_LR),
                             microbatches=TRAIN_MICROBATCHES // data)
    schema = get_model(cfg).schema(cfg)
    shapes = {name: [] for name in TP_WRAPPERS}
    first = {}  # by kernel, flash by mask mode: the first call's inputs
    rec = {"losses": [], "step_ms": [], "replicated_equal": [], "collective_bytes": []}
    groups = lambda: {"data": common.data_group(), "model": common.model_group()}

    def table_whole(t):  # the working table's d-slices gathered, where it is cut
        return common.gather_from_model(t, -1) if t.shape[-1] < cfg.d_model else t

    def recorder(name, fn):
        def call(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            sig = [list(t.shape) for t in tensors]
            if sig not in shapes[name]:
                shapes[name].append(sig)
            key = flash_key(flash_mode(args[0], args[1], kw)) if name == "flash_attention" else name
            # rank 0 keeps each kernel's first call, the others flash's with a head offset
            if (root or kw.get("head_offset", 0) > 0) and key not in first:
                first[key] = ([a.detach().clone() if isinstance(a, torch.Tensor) else a
                               for a in args], dict(kw))
            return fn(*args, **kw)
        return call

    secs = {}  # this rank's seconds by part of the run

    def hook(i, step, args):
        if i == 0:  # step 1's gradients, gathered to rank 0, for the comparison
            t0 = time.perf_counter()
            mesh = _tp_mesh(M, data, groups())
            rules = shd.build_rules(cfg, mesh)
            for name, (g, tg, loss) in _grads_by_dtype(cfg, settings, args).items():
                whole = shd.gather_tree(g, schema, rules, mesh, dst=0)
                tgw = table_whole(tg).cpu()
                if root:
                    torch.save({"g": whole, "t": tgw, "loss": loss}, out / f"tp_grads_{name}.pt")
                del g, tg, whole, tgw
            torch.cuda.synchronize()
            dist.barrier()  # the other ranks wait for rank 0's writes here, not inside step 1
            secs["grads"] = time.perf_counter() - t0
            kops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
        counts = {}
        t0 = time.perf_counter()
        with swapped(kops, **{w: recorder(n, getattr(kops, w)) for n, w in TP_WRAPPERS.items()}), \
                swapped(coll, **counted_collectives(counts, groups())):
            res = step(*args)
        torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["collective_bytes"].append(counts)
        rec["losses"].append(float(res[2]["loss"]))
        if i == 0:  # step 1's new rows (fused_adagrad on the d-slices), whole
            new_rows = table_whole(res[3]).cpu()
            if root:
                torch.save(new_rows, out / "tp_rows.pt")
            del new_rows
        same = []
        for axis, group in groups().items():
            if group is None:
                continue
            src = dist.get_global_rank(group, 0)
            flags = tree_leaves(replicated_leaves(cfg, res[0], axis))
            for t, whole in zip(tree_leaves(res[0]), flags):
                if whole:
                    x = t.clone()
                    dist.broadcast(x, src=src, group=group)
                    same.append(bool(torch.equal(x, t)))
        rec["replicated_equal"].append(same)
        return res

    # the launcher holds the only reference, so its shards replace the whole weights
    t0 = time.perf_counter()
    init = [get_model(cfg).init(cfg, torch.Generator(device=dev).manual_seed(seed))]
    res = launch.run(cfg, settings, steps=TP_STEPS, batch=LM_BATCH, seq=seq, model_parallel=M,
                     base=str(out / "run"), ckpt_every=0, device=dev, backend="gloo",
                     params=init.pop(), step_hook=hook)
    secs["run"] = time.perf_counter() - t0 - secs["grads"]
    flash_modes = {}  # counted where flash launches, by (Sq, Skv, causal, window): by mask mode
    for mode, n in flash_attention_cuda.launches_by_mode.items():
        key = flash_key(mask_mode(*mode))
        flash_modes[key] = flash_modes.get(key, 0) + n
    rec.update(
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=kops.launch_counts(),
        flash_modes=flash_modes,
        shapes=shapes, flash_variants=dict(flash_attention_cuda.launches_by_variant),
        gmm_variants=dict(gmm_cuda.launches_by_variant), gmm_modes=dict(gmm_cuda.launches_by_mode),
        n_local_params=sum(t.numel() for t in tree_leaves(res.params)),
        n_working=res.n_working, device=str(dev), backend=dist.get_backend(),
        world=dist.get_world_size())
    del res
    torch.cuda.empty_cache()
    dist.barrier()
    t0 = time.perf_counter()
    if root:  # each kernel at its first TP call's inputs, the other ranks idle
        timing = {}
        for key in sorted(k for k in first if k.startswith("flash_attention")):
            (q, k, v), kw = first[key][0][:3], first[key][1]
            Bq, H, Sq, Dh = q.shape
            causal, window = kw.get("causal", True), kw.get("window", 0)
            pairs = Bq * H * kept_pairs(Sq, k.shape[2], causal=causal, window=window,
                                        q_offset=kw.get("q_offset", 0))
            run_fa = lambda: flash_attention_cuda(q, k, v, **kw)
            got, want = run_fa(), flash_attention_plain(q, k, v, **kw)
            ks, vs = k, v
            if kw.get("group", H // k.shape[1]) * k.shape[1] != H:  # heads not in whole groups:
                # SDPA on kv expanded to one kv head per q head (the expansion not timed)
                heads = (torch.arange(H, device=q.device) + kw.get("head_offset", 0)) // kw["group"]
                ks, vs = k[:, heads].contiguous(), v[:, heads].contiguous()
            if window:  # SDPA has no window: an explicit mask
                mask = attention_mask(Sq, k.shape[2], causal=causal, window=window,
                                      q_offset=kw.get("q_offset", 0), device=q.device)
                sdpa = lambda: F.scaled_dot_product_attention(q, ks, vs, attn_mask=mask,
                                                              enable_gqa=True)
            else:
                sdpa = lambda: F.scaled_dot_product_attention(q, ks, vs, is_causal=causal,
                                                              enable_gqa=True)
            timing[key] = dict(
                ms=sum(device_kernel_ms(run_fa, ("flash_attention_hopper_kernel",)).values()),
                plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, **kw), iters=3, warmup=1),
                library_ms=cuda_ms(sdpa), max_abs_err=float((got.float() - want.float()).abs().max()),
                within_tol=flash_within(got, want), tol="rtol 2^-6, atol 2e-5 (bf16)",
                shape=[list(t.shape) for t in (q, k, v)], mode=flash_mode(q, k, kw))
            timing[key]["bound_ms"], timing[key]["bound_by"] = bound_ms(
                nbytes=2.0 * (2 * q.numel() + k.numel() + v.numel()), flops=4.0 * Dh * pairs,
                peak=BF16_FLOPS)
        if "moe_gmm" in first:
            (x, w, gs), gkw = first["moe_gmm"][0][:3], first["moe_gmm"][1]
            K, N = x.shape[1], w.shape[2]
            rows, hit = int(gs.sum()), int((gs > 0).sum())
            run_g = lambda: gmm_cuda(x, w, gs, **gkw)
            got, want = run_g(), gmm_plain(x, w, gs)
            timing["moe_gmm"] = dict(
                ms=sum(device_kernel_ms(run_g, ("gmm_hopper_kernel",)).values()),
                plain_ms=cuda_ms(lambda: gmm_plain(x, w, gs), iters=3, warmup=1),
                library_ms=cuda_ms(grouped_mm_call(x, w, gs)),
                max_abs_err=float((got.float() - want.float()).abs().max()),
                within_tol=gmm_within(got, want),
                tol="rtol 2^-6, atol 1e-4 of the largest output (bf16)",
                shape=[list(x.shape), list(w.shape)], rows=rows)
            timing["moe_gmm"]["bound_ms"], timing["moe_gmm"]["bound_by"] = bound_ms(
                nbytes=2.0 * (rows * K + hit * K * N + rows * N), flops=2.0 * rows * K * N,
                peak=BF16_FLOPS)
        table, ids = first["embedding_lookup"][0][:2]
        run_el = lambda: kops.embedding_lookup_cuda(table, ids)
        uniq = int(torch.unique(ids).numel())
        el_equal = torch.equal(run_el(), embedding_lookup_plain(table, ids))
        timing["embedding_lookup"] = dict(
            ms=sum(device_kernel_ms(run_el, ("lookup_kernel",), iters=50).values()),
            plain_ms=cuda_ms(lambda: embedding_lookup_plain(table, ids), iters=50),
            library_ms=cuda_ms(lambda: F.embedding(ids.long(), table), iters=50),
            max_abs_err=float((run_el() - embedding_lookup_plain(table, ids)).abs().max()),
            within_tol=el_equal, tol="bitwise", shape=[list(table.shape), list(ids.shape)])
        timing["embedding_lookup"]["bound_ms"], timing["embedding_lookup"]["bound_by"] = bound_ms(
            nbytes=ids.numel() * 4 + (uniq + ids.numel()) * table.shape[1] * 4, flops=0.0)
        work, sid, srows = first["scatter_add"][0][:3]
        n_rows, D = work.shape
        zero = torch.zeros_like(work)
        run_sc = lambda: kops.scatter_add_cuda_(zero, sid, srows)
        ids64 = sid.long()
        diff = (kops.scatter_add_cuda_(torch.zeros_like(work), sid, srows)
                - scatter_add_plain_(torch.zeros_like(work), sid, srows)).abs()
        timing["scatter_add"] = dict(
            ms=sum(device_kernel_ms(run_sc, ("scatter_add_kernel",)).values()),
            plain_ms=cuda_ms(lambda: scatter_add_plain_(torch.zeros_like(work), sid, srows)),
            library_ms=cuda_ms(lambda: zero.index_add_(0, ids64, srows)),
            max_abs_err=float(diff.max()),
            within_tol=scatter_within(diff, torch.zeros_like(work), sid, srows),
            tol="1e-5 of each row's sum of |grads| + 1e-6",
            shape=[list(work.shape), list(srows.shape)])
        sc_flops, sc_bytes = scatter_add_cost(sid.numel(), D, int(torch.unique(sid).numel()))
        timing["scatter_add"]["bound_ms"], timing["scatter_add"]["bound_by"] = bound_ms(
            nbytes=sc_bytes, flops=sc_flops)
        (p, a, gr, lr), akw = first["fused_adagrad"][0][:4], first["fused_adagrad"][1]
        run_ag = lambda: kops.adagrad_cuda(p, a, gr, lr, *first["fused_adagrad"][0][4:], **akw)
        kp, ka = run_ag()
        pp, pa = adagrad_plain(p, a, gr, lr)
        lib = [p.clone(), gr.clone(), a.clone(), torch.zeros((), device=dev)]
        lib_ag = lambda: torch._fused_adagrad_([lib[0]], [lib[1]], [lib[2]], [lib[3]], lr=lr,
                                               lr_decay=0.0, weight_decay=0.0, eps=1e-8,
                                               maximize=False)
        try:  # the yardstick only
            lib_ag()
            ag_lib = cuda_ms(lib_ag)
        except (AttributeError, RuntimeError, TypeError):
            ag_lib = None
        timing["fused_adagrad"] = dict(
            ms=sum(device_kernel_ms(run_ag, ("adagrad_vec4_kernel", "adagrad_scalar_kernel"),
                                    iters=50).values()),
            plain_ms=cuda_ms(lambda: adagrad_plain(p, a, gr, lr)), library_ms=ag_lib,
            max_abs_err=max(float((kp - pp).abs().max()), float((ka - pa).abs().max())),
            within_tol=torch.equal(kp, pp) and torch.equal(ka, pa), tol="bitwise",
            shape=[list(p.shape)])
        timing["fused_adagrad"]["bound_ms"], timing["fused_adagrad"]["bound_by"] = bound_ms(
            nbytes=5.0 * p.numel() * 4, flops=7.0 * p.numel())
        rec["timing"] = timing
        first.clear()
    dist.barrier()
    secs["kernels"] = time.perf_counter() - t0
    for r in range(1, dist.get_world_size()):  # flash with a head offset, one rank at a time
        if info.rank == r and first:
            rec["offset_timing"] = {key: offset_flash_record(*first[key])
                                    for key in sorted(first)}
            first.clear()
        dist.barrier()
    secs["offset_kernels"] = time.perf_counter() - t0 - secs["kernels"]
    rec["secs"] = {k: round(v, 1) for k, v in secs.items()}
    rec["t"] = [t_start, time.time()]
    tmp = out / f"rank{info.rank}.json.tmp"  # renamed whole: the phase waits for the name
    tmp.write_text(json.dumps(rec))
    tmp.rename(out / f"rank{info.rank}.json")
    dist.destroy_process_group()
    return 0


def tp_pool_main(plan: Path, seed: int) -> int:
    """One process of ``tp_train``'s pool (``chip_smoke.py --tp-pool PLAN``,
    process p of the pool in ``LOCAL_RANK``): for each run i of the plan (a
    JSON list of [arch, M, data, out], in order), once the phase has written
    ``go{i}`` beside the plan, rank p of that run if its data x M ranks
    count p (:func:`tp_rank_main`, a process group of its own), its tensors
    freed before the next. The pool's processes start once for every run."""
    import gc
    import os

    import torch

    p = int(os.environ["LOCAL_RANK"])
    for i, (arch, M, data, out) in enumerate(json.loads(plan.read_text())):
        while not (plan.parent / f"go{i}").exists():
            time.sleep(0.2)
        world = data * M
        if p >= world:
            continue
        os.environ.update(RANK=str(p), WORLD_SIZE=str(world),
                          INIT_METHOD=f"file://{Path(out) / 'rendezvous'}")
        torch.set_num_threads(max(1, HOST_CORES // world))
        tp_rank_main(arch, M, Path(out), seed, data)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


class TpPool:
    """The ``tp_train`` runs ``(arch, M, data, out)`` on one pool of gloo
    ranks sharing the card (``tp_pool_main``: as many subprocesses as the
    largest run's data x M, started once with the pool); :meth:`run` lets
    the next run go and waits for its ranks' records, so that nothing else
    runs on the card beside it. A rank that fails stops the pool."""

    def __init__(self, runs: list, seed: int):
        import os

        self.runs, self.next = runs, 0
        size = max(M * data for _, M, data, _ in runs)
        for *_, out in runs:
            out.mkdir(parents=True)
        self.base = runs[0][3].parent
        plan = self.base / "tp_plan.json"
        plan.write_text(json.dumps([[a, M, data, str(out)] for a, M, data, out in runs]))
        self.logs = [self.base / f"pool{p}.log" for p in range(size)]
        self.t0, self.procs = time.time(), []
        for p, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--seed", str(seed),
                     "--tp-pool", str(plan)], stdout=f, stderr=subprocess.STDOUT,
                    env=dict(os.environ, LOCAL_RANK=str(p),
                             PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")))

    def run(self, out: Path) -> tuple[list, float]:
        """Run ``out``'s run (the next of the plan) -> (its rank records,
        the seconds from its ranks' meeting to their last record)."""
        i = self.next
        arch, M, data, path = self.runs[i]
        check(path == out, f"tp_train pool: run {i} is {path}, not {out}")
        self.next += 1
        (self.base / f"go{i}").touch()
        files = [out / f"rank{r}.json" for r in range(M * data)]
        t0 = time.time()
        while not all(f.exists() for f in files):
            failed = any(q.poll() not in (None, 0) for q in self.procs)
            if failed or time.time() - t0 > TP_RUN_TIMEOUT:
                self.stop()
                check(False, f"tp_train {arch} (data {data}, model {M}): pool rcs "
                      f"{[q.returncode for q in self.procs]} after {time.time() - t0:.0f}s\n"
                      + "\n".join(log.read_text()[-4000:] for log in self.logs))
            time.sleep(0.2)
        ranks = [json.loads(f.read_text()) for f in files]
        return ranks, max(rk["t"][1] for rk in ranks) - min(rk["t"][0] for rk in ranks)

    def stop(self) -> None:
        """Kill the pool's processes still running."""
        for q in self.procs:
            if q.poll() is None:
                q.kill()
                q.wait()

    def close(self) -> None:
        """Wait for the pool's processes (each ends after the plan's last
        run) and stop any still running."""
        try:
            for q in self.procs:
                q.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
        self.stop()
        check(all(q.returncode == 0 for q in self.procs), f"tp_train pool: rcs "
              f"{[q.returncode for q in self.procs]}\n"
              + "\n".join(log.read_text()[-4000:] for log in self.logs))


def _check_tp_ranks(arch: str, cfg, M: int, data: int, seq: int, ranks: list) -> dict:
    """The per-rank checks of :func:`tp_train_phase` on a (``data``, ``M``)
    mesh -> rank 0's kernel records, each with its launches."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models import get_model
    from repro_torch.models.common import abstract_params
    from repro_torch.train.optim import tree_leaves

    what = f"tp_train {arch} at M = {M}" if data == 1 else f"fsdp_train {arch}"
    want_flash = tp_flash_shapes(cfg, M, seq, 0)
    kernels = ranks[0]["timing"]
    check(set(kernels) == {"embedding_lookup", "scatter_add", "fused_adagrad"}
          | {flash_key(m) for m in want_flash}
          | ({"moe_gmm"} if cfg.is_moe else set()),
          f"{what}: kernels timed at the local shapes {sorted(kernels)}")
    for name, krec in kernels.items():
        check(krec["within_tol"] and (krec["tol"] != "bitwise" or krec["max_abs_err"] == 0),
              f"{what} {name} at {krec['shape']}: kernel vs plain max |diff| "
              f"{krec['max_abs_err']:.3e}, not within {krec['tol']}")
    mb = TRAIN_MICROBATCHES // data  # a data rank's microbatches
    gmm_products = 3 if cfg.is_moe else 0
    # each attention call launches flash twice a microbatch: forward and remat's recompute
    want_modes = {flash_key(m): 2 * n * mb * TP_STEPS
                  for m, n in tp_attention_calls(cfg).items()}
    per_step = {"embedding_lookup": mb, "scatter_add": mb, "fused_adagrad": 1,
                "moe_gmm": 3 * gmm_products * cfg.n_layers * mb}
    want = {n: per_step.get(n, 0) * TP_STEPS for n in ranks[0]["launches"]}
    want["flash_attention"] = sum(want_modes.values())
    mesh = _tp_mesh(M, data)
    schema = get_model(cfg).schema(cfg)
    n_local = sum(t.numel() for t in tree_leaves(shd.shard_tree(
        abstract_params(schema), schema, shd.build_rules(cfg, mesh), mesh, 0, 0)))
    d = cfg.d_model
    d_local = d // M if d % M == 0 else d  # the working table's d-slice, or all of it
    experts = cfg.n_experts // M if cfg.is_moe and cfg.n_experts % M == 0 else cfg.n_experts
    for r, rk in enumerate(ranks):
        want_flash_sigs = sorted({json.dumps(s) for s in tp_flash_shapes(cfg, M, seq,
                                                                         r % M).values()})
        check(rk["backend"] == "gloo" and rk["world"] == data * M and rk["device"] == "cuda:0",
              f"{what} rank {r} ran on {rk['backend']} {rk['device']}")
        check(all(all(s) for s in rk["replicated_equal"]) and len(rk["replicated_equal"])
              == TP_STEPS, f"{what} rank {r}: leaves whole over an axis differ from that "
              f"group's first rank's: {rk['replicated_equal']}")
        check(rk["n_local_params"] == n_local, f"{what} rank {r} holds "
              f"{rk['n_local_params']} parameters, its shards {n_local}")
        check(rk["launches"] == want and rk["flash_modes"] == want_modes,
              f"{what} rank {r} launches {rk['launches']}, want {want}; flash by "
              f"mask mode {rk['flash_modes']}, want {want_modes}")
        check(rk["flash_variants"]["hopper"] == want["flash_attention"]
              and rk["flash_variants"]["simt"] == 0
              and rk["gmm_variants"].get("hopper", 0) == want["moe_gmm"],
              f"{what} rank {r} by kernel: flash {rk['flash_variants']}, "
              f"gmm {rk['gmm_variants']}")
        check(rk["losses"] == ranks[0]["losses"] and all(
            map(lambda x: x == x and abs(x) < 1e30, rk["losses"])),
            f"{what} rank {r} losses {rk['losses']} vs rank 0's {ranks[0]['losses']}")
        sh = rk["shapes"]
        check(sorted(json.dumps(s) for s in sh["flash_attention"]) == want_flash_sigs
              and all(s[0][1] == d_local for name in ("embedding_lookup", "scatter_add",
                                                       "fused_adagrad")
                      for s in sh[name])
              and all(s[1][0] == experts for s in sh["moe_gmm"]),
              f"{what} rank {r}: kernel shapes {sh}")
    for name, krec in kernels.items():  # rank 0's launches, counted where each launches
        krec["launches"] = (ranks[0]["flash_modes"] if name.startswith("flash_attention")
                            else ranks[0]["launches"])[name]
    for r, rk in enumerate(ranks):  # flash with a head offset, at that rank's shapes
        for key, krec in rk.get("offset_timing", {}).items():
            for rec in (krec, krec["simt"]):
                check(rec["within_tol"], f"{what} rank {r} {key} with head offset "
                      f"{rec['head_offset']} at {rec['shape']}: kernel vs plain max |diff| "
                      f"{rec['max_abs_err']:.3e}, not within {rec['tol']}")
            krec["launches"] = rk["flash_modes"][key]
            kernels[f"{key}_offset_rank{r}"] = krec
    return kernels


def fsdp_dry_counts(cfg, M: int, data: int, seq: int, n_working: int) -> tuple[dict, dict]:
    """The dry run of one step of the ``fsdp_train`` cell for rank 0 of a
    (``data``, ``M``) mesh with a working table of ``n_working`` rows ->
    (collective operand bytes by ``kind/axis``, memory a rank)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import DryMesh

    counter, mem = DR.trace_cell(cfg, ShapeSpec("fsdp_train", "train", seq, LM_BATCH),
                                 DryMesh(data, M, 0),
                                 {"microbatches": TRAIN_MICROBATCHES // data},
                                 working=n_working)
    counts = {}
    for c in counter.collectives:
        key = f"{c.kind}/{c.group.axis}"
        counts[key] = counts.get(key, 0) + c.nbytes
    return counts, mem


def tp_train_phase(base: Path, seed: int) -> tuple[dict, dict, dict]:
    """Tensor parallelism over ``model`` on the one card: for each of
    ``TP_CELLS``, M gloo ranks (``tp_rank_main``; NCCL takes one rank a
    card) train ``TP_STEPS`` steps through ``launch.train.run(...,
    model_parallel=M)`` from the seeded weights; for ``FSDP_ARCH``'s cell,
    FSDP_DATA x M ranks do the same on a (FSDP_DATA, M) mesh
    (``fsdp_train``: the weights, gradients and AdamW state cut on both
    axes). Every run goes on one pool of subprocesses (``TpPool``),
    started once, one run at a time; after each cell's runs this process
    runs its config, seeds and steps on its NCCL world of one, which the
    cell's runs are held against.
    Checks: step 1's every gradient leaf (gathered to rank 0; with the
    cell's first ``TP_GRAD_DTYPES`` compute) and the working table's within
    ``LM_TOL`` of the world of one's largest, its loss within 1e-2; step
    1's new working rows (``fused_adagrad`` on each rank's d-slice) within
    ``LM_TOL * row_lr`` of the world of one's wherever the world of one's
    table gradient exceeds the largest difference of the two (the signs
    agree; elsewhere a first Adagrad step may flip by 2 * row_lr); each
    kernel (flash by mask mode) at its first call's local inputs within its
    tolerance of its plain version (``embedding_lookup`` and
    ``fused_adagrad`` bitwise, ``scatter_add`` its contract bound, flash and
    ``moe_gmm`` as their main-path checks hold them); every leaf bitwise
    equal over each axis it is whole on after each step; each rank's
    parameters its shards' count; each rank's launches exactly what its
    steps' code launches, flash and moe_gmm all on their wgmma + TMA
    kernels, flash's by mask mode, at the local shapes; finite losses; and
    for ``fsdp_train``, each step's collective operand bytes over ``data``
    equal to the dry run's count of that step, and for the cells of
    ``TP_COLLECTIVE_CELLS`` each step's over ``model`` on every rank (the
    q heads' gathers and their reduce-scatters among them) equal to the dry
    run's count of that step for rank 0; flash with a head offset on the
    ranks whose heads start inside a kv group (hopper in bf16, SIMT in fp32)
    within its tolerance of its plain version. Printed beside the fp32 and
    bf16 gradient gaps of the cells of ``TP_ULP_WITNESS``: the world of one
    against itself with every weight one ulp of that compute dtype off.
    Prints each cell's lines as it ends. Returns (rank 0's launches by cell,
    rank 0's kernel times at the local shapes with its launches of each,
    rank 0's record by cell), keyed ``{arch}_m{M}``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch
    from repro_torch.models import get_model
    from repro_torch.train.optim import AdamW, tree_leaves
    from repro_torch.train.train_step import TrainSettings

    import gc

    lines, launches, timing, rank0 = [], {}, {}, {}
    gc.collect()  # the earlier phases' tensors, cycles included
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_allocated() / 1e9, torch.cuda.memory_reserved() / 1e9,
            (lambda free, total: (total - free) / 1e9)(*torch.cuda.mem_get_info()))
    pool_runs = []  # every run's ranks on one pool of processes, started once
    for arch, M, _, _ in TP_CELLS:
        cell = _cell_key(arch, M)
        pool_runs.append((arch, M, 1, base / f"tp_{cell}"))
        if arch == FSDP_ARCH:
            pool_runs.append((arch, M, FSDP_DATA, base / f"fsdp_{cell}"))
    pool = TpPool(pool_runs, seed)
    print(f"tp_train pool: the ranks of {len(pool_runs)} runs on one pool of {len(pool.procs)} gloo "
          f"processes sharing the card, started once; this process held {held[0]:.2f} GB "
          f"allocated, {held[1]:.2f} reserved and the card {held[2]:.2f} GB in use as they "
          f"started", flush=True)
    groups = []  # the cells of one config: one world of one for all their runs
    for arch, M, seq, cuts in TP_CELLS:
        if groups and groups[-1][0] == (arch, seq, cuts):
            groups[-1][1].append(M)
        else:
            groups.append(((arch, seq, cuts), [M]))
    try:
        for (arch, seq, cuts), Ms in groups:
            for ln in lines:  # the previous group's
                print(ln, flush=True)
            lines = []
            cfg = _tp_cell(arch, Ms[0])[0]
            gc.collect()  # the previous world of one's tensors, cycles included
            torch.cuda.empty_cache()
            runs = {("tp", M): base / f"tp_{_cell_key(arch, M)}" for M in Ms}
            if arch == FSDP_ARCH:
                runs["fsdp", Ms[0]] = base / f"fsdp_{_cell_key(arch, Ms[0])}"
            ranks, secs = {}, {}
            for run, path in runs.items():
                ranks[run], secs[run] = pool.run(path)
            if pool.next == len(pool.runs):
                pool.close()  # its last run is in
            for M in Ms:
                rank0[_cell_key(arch, M)] = ranks["tp", M][0]

            # the world of one: the same config, seeds and steps on this process's NCCL group
            t_one = time.perf_counter()
            settings = TrainSettings(optimizer=AdamW(lr=TRAIN_LR), microbatches=TRAIN_MICROBATCHES)
            one = {"losses": [], "step_ms": [], "errs": {}, "row_max": {}, "row_share": {},
                   "secs": {}}

            def hook(i, step, args):
                if i == 0:
                    clear = {}
                    t0 = time.perf_counter()
                    for name, (g, tg, loss) in _grads_by_dtype(cfg, settings, args).items():
                        for run, path in runs.items():
                            tp = torch.load(path / f"tp_grads_{name}.pt", mmap=True)
                            errs = _leaf_errs(_tree_map(lambda t: t.cuda(), tp["g"]), g)
                            tp_t = tp["t"].cuda()
                            errs["working_table"] = rel_err("working table grad", tp_t, tg)
                            errs["loss"] = abs(tp["loss"] - loss) / abs(loss)
                            one["errs"].setdefault(run, {})[name] = errs
                            if name == "bf16":  # where the bf16 steps' table gradients share a sign
                                clear[run] = tg.abs() > (tp_t - tg).abs().max()
                            del tp_t, tp
                            (path / f"tp_grads_{name}.pt").unlink()
                        if name in TP_ULP_WITNESS.get(arch, ()):  # the yardstick for TP's gaps
                            # in this compute: the world of one against itself with every
                            # weight moved by one ulp of the compute dtype
                            t1 = time.perf_counter()
                            gj, tgj = ulp_jittered_grads(cfg, settings, args, seed, name)
                            ulp = one.setdefault("ulp_errs", {})[name] = _leaf_errs(gj, g)
                            ulp["working_table"] = rel_err("ulp table grad", tgj, tg)
                            del gj, tgj
                            one["secs"][f"witness_{name}"] = time.perf_counter() - t1
                        del g, tg
                    one["secs"]["grads"] = time.perf_counter() - t0 - sum(one["secs"].values())
                    one["clear"] = clear
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                res = step(*args)
                torch.cuda.synchronize()
                one["step_ms"].append((time.perf_counter() - t0) * 1e3)
                one["losses"].append(float(res[2]["loss"]))
                if i == 0:  # step 1's new rows against the ranks' (fused_adagrad on d-slices)
                    for run, path in runs.items():
                        clear = one["clear"].pop(run)
                        rows_diff = (torch.load(path / "tp_rows.pt").cuda() - res[3]).abs()
                        one["row_max"][run] = float(rows_diff[clear].max())
                        one["row_share"][run] = float(clear.float().mean())
                        del clear, rows_diff
                return res

            init = [get_model(cfg).init(cfg, torch.Generator(device="cuda").manual_seed(seed))]
            res = launch.run(cfg, settings, steps=TP_STEPS, batch=LM_BATCH, seq=seq,
                             base=str(base / f"one_{_cell_key(arch, Ms[0])}"), ckpt_every=0,
                             device="cuda", params=init.pop(), step_hook=hook)
            one["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            n_params = sum(t.numel() for t in tree_leaves(res.params))
            del res
            torch.cuda.empty_cache()
            for path in runs.values():
                (path / "tp_rows.pt").unlink()
            one["secs"]["all"] = time.perf_counter() - t_one
            one_secs = {k: round(v, 1) for k, v in one["secs"].items()}

            # checks
            dtypes = TP_GRAD_DTYPES.get(arch, ("bf16",))
            summary = {}
            for run in runs:
                what = f"tp_train {arch} M={run[1]}" if run[0] == "tp" else f"fsdp_train {arch}"
                errs = one["errs"][run][dtypes[0]]
                grad_loss_rel = errs.pop("loss")
                worst = max(errs, key=errs.get)
                loss_rel = (abs(ranks[run][0]["losses"][0] - one["losses"][0])
                            / abs(one["losses"][0]))
                check(errs[worst] <= LM_TOL and max(loss_rel, grad_loss_rel) <= 1e-2,
                      f"{what} step 1 vs the world of one: loss rel {loss_rel:.3e} "
                      f"({dtypes[0]} compute {grad_loss_rel:.3e}), worst leaf ({dtypes[0]} compute) "
                      f"{worst} {errs[worst]:.3e} of its max |ref| > {LM_TOL}")
                check(one["row_max"][run] <= LM_TOL * settings.row_lr,
                      f"{what} step 1 new rows vs the world of one's {one['row_max'][run]:.3e} "
                      f"where the table gradients share a sign, > {LM_TOL} * row_lr")
                summary[run] = (errs, grad_loss_rel, worst, loss_rel)
            ms = lambda xs: [round(x, 1) for x in xs]
            published = get_config(arch)
            depth = ", ".join(f"{k} {v} of {getattr(published, k)}" for k, v in cuts.items())
            for M in Ms:
                cell, run = _cell_key(arch, M), ("tp", M)
                kernels = _check_tp_ranks(arch, cfg, M, 1, seq, ranks[run])
                launches[cell] = ranks[run][0]["launches"]
                timing[cell] = kernels
                coll_line = tp_collective_line(arch, cfg, M, seq, ranks[run])
                errs, grad_loss_rel, worst, loss_rel = summary[run]
                rk0 = ranks[run]
                errs_by = {n: e for n, e in one["errs"][run].items() if n != dtypes[0]}
                lines.append(
                    f"tp_train: {arch} L={cfg.n_layers} (depth cut: {depth or 'none, full depth'}) "
                    f"d={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
                    + (f"experts={cfg.n_experts}/top{cfg.top_k} " if cfg.is_moe else "")
                    + f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} batch={LM_BATCH}x{seq} "
                    f"microbatches={TRAIN_MICROBATCHES} steps={TP_STEPS}; {M} gloo ranks on one "
                    f"card, mesh (data 1, model {M}), launch.train.run(model_parallel={M}) in "
                    f"{secs[run]:.1f}s from the ranks' meeting to their records (rank 0's "
                    f"seconds {rk0[0]['secs']}), against this process's NCCL world of one "
                    f"(seconds {one_secs}, shared by the runs of this config: {len(runs)}): "
                    f"losses TP {[round(x, 5) for x in rk0[0]['losses']]} "
                    f"vs one {[round(x, 5) for x in one['losses']]} (step 1 rel {loss_rel:.3e}); "
                    f"step 1 gradients ({dtypes[0]} compute, checked) gathered over model (rank 0 "
                    f"writes them, this process reads them after its own step 1) worst leaf "
                    f"{worst} {errs[worst]:.3e} of its max |ref| (tol {LM_TOL}), working table "
                    f"{errs['working_table']:.3e}, loss rel {grad_loss_rel:.3e}; "
                    + "".join(f"with {n} compute (unchecked) worst leaf {w} {e[w]:.3e}, loss rel "
                              f"{e['loss']:.3e}; " for n, e in errs_by.items()
                              for w in [max((k for k in e if k != "loss"), key=e.get)])
                    + "".join(f"the world of one against itself with every weight one {n} ulp "
                              f"off ({n} compute, unchecked) worst leaf {w} {e[w]:.3e}, at the "
                              f"TP worst leaf {e[worst]:.3e}; "
                              for n, e in one.get("ulp_errs", {}).items()
                              for w in [max(e, key=e.get)])
                    + f"step 1 new rows max |TP - one| {one['row_max'][run]:.3e} where the table "
                    f"gradients share a sign ({one['row_share'][run]:.3e} of the elements; tol "
                    f"{LM_TOL} * row_lr); each kernel at the TP shapes within its tolerance of its "
                    f"plain version; replicated leaves bitwise equal on every rank after each step "
                    f"({len(rk0[0]['replicated_equal'][0])} leaves); params per rank "
                    f"{[rk['n_local_params'] for rk in rk0]} of {n_params}; peak_mem_gb per rank "
                    f"{[round(rk['peak_gb'], 2) for rk in rk0]} vs world of one "
                    f"{one['peak_gb']:.2f}; step_ms per rank (gloo through the host on one card, "
                    f"the ranks sharing it: not a figure for NCCL across cards) "
                    f"{[ms(rk['step_ms']) for rk in rk0]} vs world of one {ms(one['step_ms'])}; "
                    f"launches per rank {rk0[0]['launches']} (flash by kernel "
                    f"{rk0[0]['flash_variants']}, moe_gmm by kernel {rk0[0]['gmm_variants']} and "
                    f"by mode {rk0[0]['gmm_modes']}); local kernel shapes {rk0[0]['shapes']}; "
                    f"card {card()}")
                for n, e in one["errs"][run].items():
                    lines.append(f"tp_train {arch} M={M} gradient leaves ({n} compute), max |TP - "
                                 f"one| / max |one|: " + json.dumps({k: float(f"{v:.3e}")
                                                                      for k, v in e.items()}))
                for n, e in one.get("ulp_errs", {}).items():
                    lines.append(f"tp_train {arch} M={M} gradient leaves ({n} compute), max |one "
                                 f"with every weight one {n} ulp off - one| / max |one|: "
                                 + json.dumps({k: float(f"{v:.3e}") for k, v in e.items()}))
                lines.append(coll_line)
                lines.append(f"tp_train {arch} M={M} kernels at the TP shapes (rank 0, the others "
                             f"idle; flash with a head offset on the rank named): "
                             + json.dumps(timing[cell]))
            if ("fsdp", Ms[0]) in runs:
                M, run = Ms[0], ("fsdp", Ms[0])
                lines += fsdp_lines(arch, cfg, M, seq, ranks[run], secs[run], one,
                                    summary[run], dtypes[0], n_params, depth)
                key = f"{_cell_key(arch, M)}_fsdp"
                timing[key] = _check_tp_ranks(arch, cfg, M, FSDP_DATA, seq, ranks[run])
                launches[key] = ranks[run][0]["launches"]
                lines.append(f"fsdp_train {arch} kernels at the local shapes (rank 0, the others "
                             f"idle): " + json.dumps(timing[key]))
    finally:
        pool.stop()  # after a failed check too
    for ln in lines:
        print(ln, flush=True)
    return launches, timing, rank0


def tp_collective_line(arch: str, cfg, M: int, seq: int, ranks: list) -> str:
    """Each step's collective operand bytes over ``model`` (counted at the
    doors of ``repro_torch.collectives``): for the cells of
    ``TP_COLLECTIVE_CELLS`` equal on every rank to the dry run's count of
    that step for rank 0 (its working table at the step's rows); for the
    others rank 0's, printed (a dry-run trace of xlstm's sLSTM loop takes
    ~18 s a step)."""
    on = lambda counts: {k: v for k, v in counts.items() if k.endswith("/model")}
    counted = [on(c) for c in ranks[0]["collective_bytes"]]
    if (arch, M) not in TP_COLLECTIVE_CELLS:
        return (f"tp_train {arch} M={M} model-axis collective operand bytes a step by kind "
                f"(rank 0, printed) {counted}")
    dry = [fsdp_dry_counts(cfg, M, 1, seq, n)[0] for n in ranks[0]["n_working"]]
    for r, rk in enumerate(ranks):
        for i, counts in enumerate(rk["collective_bytes"]):
            check(on(counts) == on(dry[i]),
                  f"tp_train {arch} M={M} rank {r} step {i + 1}: collective bytes over model "
                  f"{on(counts)}, the dry run's {on(dry[i])}")
    return (f"tp_train {arch} M={M} model-axis collective operand bytes a step by kind (rank 0) "
            f"{counted} vs the dry run's {[on(c) for c in dry]} (equal on every rank, checked)")


def fsdp_lines(arch: str, cfg, M: int, seq: int, ranks: list, secs: float, one: dict,
               summary: tuple, dtype: str, n_params: int, depth: str) -> list[str]:
    """The ``fsdp_train`` cell's checks against the dry run, and its lines:
    each step's collective operand bytes over ``data`` (counted at the
    doors of ``repro_torch.collectives`` on every rank) equal to the dry
    run's count of that step for rank 0 (its working table at the step's
    rows), on every rank; the peak a rank printed beside the dry run's."""
    errs, grad_loss_rel, worst, loss_rel = summary
    data = FSDP_DATA
    dry, mem = [], None
    for i, n_working in enumerate(ranks[0]["n_working"]):
        counts, mem_i = fsdp_dry_counts(cfg, M, data, seq, n_working)
        dry.append(counts)
        mem = mem or mem_i
    on = lambda counts, axis: {k: v for k, v in counts.items() if k.endswith("/" + axis)}
    for r, rk in enumerate(ranks):
        for i, counts in enumerate(rk["collective_bytes"]):
            check(on(counts, "data") == on(dry[i], "data"),
                  f"fsdp_train {arch} rank {r} step {i + 1}: collective bytes over data "
                  f"{on(counts, 'data')}, the dry run's {on(dry[i], 'data')}")
    ms = lambda xs: [round(x, 1) for x in xs]
    per_step = [sum(on(c, "data").values()) for c in ranks[0]["collective_bytes"]]
    return [
        f"fsdp_train: {arch} L={cfg.n_layers} (depth cut: {depth}) d={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"batch={LM_BATCH}x{seq} ({LM_BATCH // data} sequences a data rank in "
        f"{TRAIN_MICROBATCHES // data} microbatch) steps={TP_STEPS}; {data * M} gloo ranks on "
        f"one card, mesh (data {data}, model {M}): weights, gradients and AdamW state cut on "
        f"both axes, launch.train.run(model_parallel={M}) in {secs:.1f}s (rank 0's seconds "
        f"{ranks[0]['secs']}), against the NCCL "
        f"world of one: losses {[round(x, 5) for x in ranks[0]['losses']]} vs one "
        f"{[round(x, 5) for x in one['losses']]} (step 1 rel {loss_rel:.3e}); step 1 gradients "
        f"({dtype} compute, checked) gathered over data and model worst leaf {worst} "
        f"{errs[worst]:.3e} of its max |ref| (tol {LM_TOL}), working table "
        f"{errs['working_table']:.3e}, loss rel {grad_loss_rel:.3e}; step 1 new rows max "
        f"|FSDP - one| {one['row_max']['fsdp', M]:.3e} where the table gradients share a sign "
        f"({one['row_share']['fsdp', M]:.3e} of the elements; tol {LM_TOL} * row_lr); leaves "
        f"bitwise equal over each axis they are whole on after each step "
        f"({len(ranks[0]['replicated_equal'][0])} leaf checks a rank); params per rank "
        f"{[rk['n_local_params'] for rk in ranks]} of {n_params}; peak_mem_gb per rank "
        f"{[round(rk['peak_gb'], 2) for rk in ranks]} vs the dry run's {mem['peak_bytes'] / 1e9:.2f} "
        f"(args {mem['argument_bytes'] / 1e9:.2f}) and the world of one's {one['peak_gb']:.2f}; "
        f"step_ms per rank (gloo through the host, {data * M} ranks sharing the card: not a "
        f"figure for NCCL across cards) {[ms(rk['step_ms']) for rk in ranks]} vs world of one "
        f"{ms(one['step_ms'])}; data-axis collective operand bytes per step {per_step} (rank 0 "
        f"by kind {[on(c, 'data') for c in ranks[0]['collective_bytes']]}), equal on every rank "
        f"to the dry run's {[on(c, 'data') for c in dry]}; model-axis "
        f"{[on(c, 'model') for c in ranks[0]['collective_bytes']]} vs the dry run's "
        f"{[on(c, 'model') for c in dry]}; launches per rank {ranks[0]['launches']} (flash by "
        f"mask mode {ranks[0]['flash_modes']}); card {card()}",
        f"fsdp_train {arch} gradient leaves ({dtype} compute), max |FSDP - one| / max |one|: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()}),
    ]


# the dryrun phase's band for the predicted peak over the measured one
DRYRUN_PEAK_BAND = (0.9, 1.1)


def dryrun_phase(measured: dict, tp_rank0: dict) -> list[str]:
    """The dry run (``repro_torch.launch.dryrun``: one rank's step traced on
    the meta device, no card) of the cells the card just ran, held against
    what the card measured: ``lm_train``'s and ``moe_train``'s cells (their
    cut configs, 4 x 2048 tokens, their microbatches, remat and AdamW, on a
    (1, 1) mesh, a working table of the most rows their steps pulled).
    Checks, for each: the predicted peak (the step's, plus what the card
    held outside the run) within ``DRYRUN_PEAK_BAND`` of the measured
    ``max_memory_allocated``; each kernel's calls per step equal to the
    card's launches per step; the bound max(t_compute, t_memory,
    t_collective) at most the measured warm step. Prints, unchecked,
    whisper-tiny's ``tp_train`` rank 0 at (1, 2) predicted against
    measured, and every cell's roofline fraction."""
    import dataclasses

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as DR

    lines = []
    for name, m in measured.items():
        cfg = m["cfg"]
        shape = ShapeSpec(name, "train", LM_PROMPT, LM_BATCH)
        overrides = {"optimizer": m["settings"].optimizer,
                     "microbatches": m["settings"].microbatches}
        r = DR.run_cell(cfg.name, name, (1, 1), cfg=cfg, shape=shape,
                        settings_overrides=overrides, working=m["n_working"], verbose=False)
        mem = r["memory_per_rank"]
        predicted = mem["peak_bytes"] + m["outside_bytes"]
        ratio = predicted / m["peak_bytes"]
        calls = {k: r["kernel_calls"].get(k, 0) for k in m["per_step"]}
        bound = max(r["t_compute"], r["t_memory"], r["t_collective"])
        lines.append(
            f"dryrun {name}: {cfg.name} L={cfg.n_layers} {LM_BATCH}x{LM_PROMPT} mesh 1x1 traced in "
            f"{r['trace_seconds']:.2f}s: predicted peak {predicted / 1e9:.3f} GB (step "
            f"{mem['peak_bytes'] / 1e9:.3f} + outside the run {m['outside_bytes'] / 1e9:.3f}; args "
            f"{mem['argument_bytes'] / 1e9:.3f}) vs measured {m['peak_bytes'] / 1e9:.3f} GB, ratio "
            f"{ratio:.4f} (band {DRYRUN_PEAK_BAND}); kernel calls per step {calls} vs launches "
            f"per step {m['per_step']}; t_compute {r['t_compute'] * 1e3:.2f} ms t_memory "
            f"{r['t_memory'] * 1e3:.2f} ms t_collective {r['t_collective'] * 1e3:.2f} ms -> "
            f"{r['bottleneck']}, bound {bound * 1e3:.2f} ms vs measured warm step "
            f"{m['warm_step_s'] * 1e3:.2f} ms ({bound / m['warm_step_s']:.3f} of it); flops "
            f"{r['flops_per_rank']:.4e} hbm bytes {r['bytes_per_rank']:.4e}; roofline fraction "
            f"{r['roofline_fraction']:.4f} (6ND over the bound), of the measured step "
            f"{r['model_flops_global'] / 989e12 / m['warm_step_s']:.4f}; card {card()}")
        check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
              f"dryrun {name}: predicted peak {predicted} / measured {m['peak_bytes']} = {ratio}")
        check(calls == m["per_step"], f"dryrun {name}: kernel calls per step {calls}, the card "
              f"launched {m['per_step']}")
        check(bound <= m["warm_step_s"], f"dryrun {name}: bound {bound} s above the measured "
              f"warm step {m['warm_step_s']} s")
    arch, M = "whisper-tiny", 2
    rk = tp_rank0[_cell_key(arch, M)]
    cfg, seq = _tp_cell(arch, M)
    r = DR.run_cell(arch, "tp_train", (1, M), rank=0, cfg=cfg,
                    shape=ShapeSpec("tp_train", "train", seq, LM_BATCH),
                    settings_overrides={"microbatches": TRAIN_MICROBATCHES},
                    working=max(rk["n_working"]), verbose=False)
    mem = r["memory_per_rank"]
    warm = rk["step_ms"][1] / 1e3
    lines.append(
        f"dryrun tp_train {arch} rank 0 of mesh 1x{M} (printed, unchecked): predicted step peak "
        f"{mem['peak_bytes'] / 1e9:.3f} GB (args {mem['argument_bytes'] / 1e9:.3f}) vs measured "
        f"{rk['peak_gb']:.3f} GB; kernel calls per step {r['kernel_calls']} vs rank 0's launches "
        f"over {TP_STEPS} steps {rk['launches']}; collectives {r['collective_counts']} operand "
        f"bytes {r['collective_bytes_by_kind']}; t_compute {r['t_compute'] * 1e3:.3f} ms "
        f"t_memory {r['t_memory'] * 1e3:.3f} ms t_collective {r['t_collective'] * 1e3:.3f} ms "
        f"(NVLink 450 GB/s assumed) -> {r['bottleneck']} vs measured warm step {warm * 1e3:.1f} "
        f"ms (gloo through the host, two ranks on one card); roofline fraction "
        f"{r['roofline_fraction']:.4f}; card {card()}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp-pool", metavar="PLAN",
                    help="run one process of the tp_train phase's rank pool over the runs "
                         "of PLAN (started by that phase)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    if args.tp_pool:
        return tp_pool_main(Path(args.tp_pool), args.seed)
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
    phase_s, last = {}, [time.perf_counter()]

    def phase_done(name: str) -> None:
        """Record the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[name] = round(now - last[0], 1)
        last[0] = now

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
    phase_done("build")

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
    phase_done("publish")

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
    phase_done("serve")

    # ---------------------------------------------------------------- train
    train_launches, train_line = train_phase(cfg, width, Path(snap) / "train", args.seed, plain)
    print(train_line, flush=True)
    phase_done("train")

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
    phase_done("kernels")

    # --------------------------------------------------------------- ingest
    fe_launches, ingest_line = ingest_phase(cfg, width, Path(snap) / "ingest")
    print(ingest_line, flush=True)
    fe_timing, fe_err, fe_line = feature_extract_phase(cfg, args.seed)
    print(fe_line, flush=True)
    phase_done("ingest")

    # -------------------------------------------------------------- grouped
    print(grouped_lr_phase(args.seed, plain), flush=True)
    phase_done("grouped")

    # ------------------------------------------------------------------- lm
    lm_timing, lm_err, lm_launches, flash_variants, lines = lm_phase(Path(snap) / "lm", args.seed)
    for ln in lines:
        print(ln, flush=True)
    phase_done("lm")

    # ------------------------------------------------------------------ moe
    moe_timing, moe_err, moe_launches, gmm_variants, lines = moe_phase(Path(snap) / "moe",
                                                                        args.seed)
    for ln in lines:
        print(ln, flush=True)
    phase_done("moe")

    # ------------------------------------------------------------------ vlm
    for ln in vlm_phase(Path(snap) / "vlm", args.seed):
        print(ln, flush=True)
    phase_done("vlm")

    # ------------------------------------------------- hybrid, ssm, audio
    path_launches = {"lm": lm_launches, "moe": moe_launches}
    for name in FAMILIES:
        path_launches[name], shapes, lines = family_phase(name, Path(snap) / name, args.seed)
        flash_variants["hopper"].setdefault("shapes", {}).update(shapes)
        for ln in lines:
            print(ln, flush=True)
        phase_done(name)

    # ------------------------------------------------- lm_train, moe_train
    lmt_launches, lmt_recomputes, lines, lm_inputs, lmt_measured = lm_train_phase(
        Path(snap) / "lm_train", args.seed)
    for ln in lines:
        print(ln, flush=True)
    phase_done("lm_train")
    moet_launches, moet_dx, lines, gmm_ops, moet_measured = moe_train_phase(
        Path(snap) / "moe_train", args.seed)
    for ln in lines:
        print(ln, flush=True)
    phase_done("moe_train")
    bwd, bwd_err, lines = train_backward_kernels_phase(lm_inputs, gmm_ops, args.seed)
    for ln in lines:
        print(ln, flush=True)
    phase_done("train_backward_kernels")
    lm_ids, n_lm = lm_inputs["ids"], lm_inputs["wt"].shape[0]
    del lm_inputs, gmm_ops
    path_launches["lm_train"], path_launches["moe_train"] = lmt_launches, moet_launches

    # ------------------------------------------------- launch_cli, sharded_hbm
    cli_launches, lines = launch_cli_phase(Path(snap) / "launch")
    for ln in lines:
        print(ln, flush=True)
    path_launches.update({f"launch_cli_{a}": n for a, n in cli_launches.items()})
    phase_done("launch_cli")
    sharded_records, sharded_launches, lines = sharded_hbm_phase(cfg, n_lm, lm_ids, args.seed)
    for ln in lines:
        print(ln, flush=True)
    path_launches.update({f"sharded_hbm_{k}": n for k, n in sharded_launches.items()})
    phase_done("sharded_hbm")
    del lm_ids

    # ------------------------------------------------------------- tp_train
    tp_launches, tp_timing, tp_rank0 = tp_train_phase(Path(snap) / "tp_train", args.seed)
    path_launches.update({(f"fsdp_train_{a[:-len('_fsdp')]}_rank0" if a.endswith("_fsdp")
                           else f"tp_train_{a}_rank0"): n for a, n in tp_launches.items()})
    phase_done("tp_train")

    # --------------------------------------------------------------- dryrun
    for ln in dryrun_phase({"lm_train": lmt_measured, "moe_train": moet_measured}, tp_rank0):
        print(ln, flush=True)
    phase_done("dryrun")

    # --------------------------------------------------------------- device
    print(f"phase_s: {json.dumps(phase_s)} total {sum(phase_s.values()):.1f}", flush=True)
    print(card(), flush=True)

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
        by_path = {p: n[name] for p, n in path_launches.items() if n.get(name)}
        if by_path:  # the LM-side kernels launch on several serving paths
            record[-1]["launches_by_path"] = by_path
        if name == "flash_attention":  # its two kernels: hopper on the path, simt beside it
            record[-1]["variants"] = flash_variants
        if name == "moe_gmm":  # the compacted prefill above; the capacity layout and decode
            record[-1]["variants"] = gmm_variants
    # the training path's backward, at its shapes with its launches: the
    # lookup's through scatter_add and fused_adagrad at D = 4096 (lm_train),
    # the flash Function's (a recompute of attention_blockwise under
    # autograd, no kernel of the port: the reference's _flash_bwd is no
    # Pallas kernel either; launches = its recomputes), and gmm's dx through
    # the moe_gmm kernel (moe_train's moe_gmm launches counted as "dx") with
    # dw beside it
    backward = {
        "embedding_lookup_backward": ("src/repro_torch/csrc/scatter_add.cu",
                                      "src/repro/kernels/scatter_add.py:43",
                                      lmt_launches["scatter_add"]),
        "fused_adagrad_lm": ("src/repro_torch/csrc/fused_adagrad.cu",
                             "src/repro/kernels/fused_adagrad.py:33", lmt_launches["fused_adagrad"]),
        "flash_attention_backward": ("src/repro_torch/kernels/ops.py",
                                     "src/repro/kernels/ops.py:479", lmt_recomputes),
        "moe_gmm_backward": ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm.py:45",
                             moet_dx),
    }
    for name, (src, replaces, n) in backward.items():
        check(n > 0, f"{name} never ran on its path")
        rec = bwd[name]
        record.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                       "launches": n, "max_abs_err": bwd_err[name], "ms": rec["ms"],
                       "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                       "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                       **{k: v for k, v in rec.items() if k not in (
                           "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    # the sharded working table's per-shard bodies (sharded_hbm), at
    # ctr-C-scaled's working set and lm_train's table, with their launches
    for rec in sharded_records:
        check(rec["launches"] > 0, f"{rec['name']} never launched on its path")
        record.append(rec)
    # the five LM kernels on tp_train's and fsdp_train's local shards (rank
    # 0's first call of each, flash's of each mask mode, timed with the other
    # ranks idle), with rank 0's launches on that path (flash's of that mode)
    for key, kernels in tp_timing.items():
        arch, path = (key[:-len("_fsdp")], "fsdp") if key.endswith("_fsdp") else (key, "tp")
        for name, rec in kernels.items():
            check(rec["launches"] > 0 and rec["ms"] > 0, f"{name} on {path}_train {arch}: "
                  f"{rec['launches']} launches, device ms {rec['ms']}")
            kernel = "flash_attention" if name.startswith("flash_attention") else name
            record.append({"name": f"{name}_{path}_{arch}", "route": "cuda",
                           "source": sources[kernel][0], "replaces": sources[kernel][1], **rec})
    retr.close()
    tmp.cleanup()
    torch.distributed.destroy_process_group()
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
