#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

Drives the port's ad-serving path (``repro_torch``) at the full width of
``ctr-C-scaled`` — emb_dim 8, 500 nonzeros per example over 125 slots,
600,000 keys, ``[emb | adagrad]`` rows 16 floats wide — through the entry
points a user calls, and holds every kernel of that path against its plain
PyTorch version on the card. Phases, one line each:

1. build    — compile the CUDA kernels from ``src/repro_torch/csrc``.
2. publish  — seeded dyadic rows for all 600k keys into a 2-node Cluster,
              one published snapshot version.
3. serve    — ServingCluster -> ServingEngine -> RetrievalEngine: search
              k=10 and k=100 (topk_mips kernel), rerank (embedding_bag
              kernel), lookup_device with device residency; launch counts
              read from this run, results equal to the same path on the
              plain versions, bitwise.
4. kernels  — each kernel against its plain version at the main-path
              shapes and on edge cases; kernel, plain, library times and
              the bound.
5. device   — the card's name and power limit (nvidia-smi).

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
def plain_kernels(kops, topk_plain, bag_plain):
    """Route the dispatcher to the plain versions (the comparison run of the
    same serving path; kernel launch counters stay untouched)."""
    saved = kops.topk_mips, kops.embedding_bag
    kops.topk_mips = lambda q, c, k, *, n_valid=None: topk_plain(q, c, k, n_valid=n_valid)
    kops.embedding_bag = bag_plain
    try:
        yield
    finally:
        kops.topk_mips, kops.embedding_bag = saved


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
          and cfg.n_sparse_keys == N_KEYS, f"unexpected ctr-C-scaled widths {cfg}")
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
    check(all(n > 0 for n in launches.values()), f"a kernel never ran on the path: {launches}")
    check(reused > 0, "lookup_device reused no device-resident row")
    for k in TOPK:
        r = res[k]
        check(r.scores.shape == (BATCH, k) and np.isfinite(r.scores).all() and r.valid.all(),
              f"search k={k}: shape {r.scores.shape}, all finite and valid")
    check(rr.scores.shape == (BATCH, TOPK[0]) and np.isfinite(rr.scores).all(), "rerank shape")
    # the same path on the plain versions, on the card: equal bitwise
    with plain_kernels(kops, topk_mips_plain, embedding_bag_plain):
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
    # library yardstick: F.embedding_bag over the nonzeros pre-sorted into
    # (example, slot) bags (the sort is set-up, not timed)
    kept = (bag_valid & (bag_slot >= 0) & (bag_slot < cfg.n_slots)).reshape(-1)
    seg = (torch.arange(BATCH, device=dev).repeat_interleave(cfg.nnz_per_example)
           * cfg.n_slots + bag_slot.reshape(-1).long())[kept]
    order = torch.sort(seg, stable=True).indices
    lib_in = bag_ids.reshape(-1)[kept][order].long()
    offsets = torch.searchsorted(seg[order], torch.arange(BATCH * cfg.n_slots, device=dev))
    lib_out = torch.nn.functional.embedding_bag(lib_in, bag_table, offsets, mode="sum")
    check(torch.equal(lib_out.reshape(kb.shape), kb), "library embedding_bag != kernel")
    bag_lib_ms = cuda_ms(
        lambda: torch.nn.functional.embedding_bag(lib_in, bag_table, offsets, mode="sum"), iters=50)
    n_kept = int(kept.sum())
    n_rows_read = int(torch.unique(bag_ids.reshape(-1)[kept]).numel())
    bag_bound, bag_by = bound_ms(
        nbytes=bag_ids.numel() * (4 + 4 + 1) + n_rows_read * cfg.emb_dim * 4 + kb.numel() * 4,
        flops=float(n_kept * cfg.emb_dim),
    )
    timing = {
        "topk_mips": (topk_ms, topk_dev_ms, topk_plain_ms, topk_lib_ms, topk_bound, topk_by),
        "embedding_bag": (bag_ms, bag_dev_ms, bag_plain_ms, bag_lib_ms, bag_bound, bag_by),
    }
    print(
        "kernels: "
        + "; ".join(
            f"{n} launches={launches[n]} call_ms={t[0]:.5f} device_ms={t[1]} plain_ms={t[2]:.5f} "
            f"library_ms={t[3]:.5f} bound_ms={t[4]:.6f} ({t[5]})" for n, t in timing.items())
        + f"; topk shape Q={BATCH} N={idx.n_rows} D={corpus.shape[1]} k={k_main}; bag shape "
        f"B={BATCH} nnz={cfg.nnz_per_example} n_slots={cfg.n_slots} D={cfg.emb_dim} "
        f"kept={n_kept} rows_read={n_rows_read}; edge cases passed: {edge}",
        flush=True,
    )

    # --------------------------------------------------------------- device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)

    sources = {
        "topk_mips": ("src/repro_torch/csrc/topk_mips.cu", "src/repro/kernels/topk_mips.py:101"),
        "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                          "src/repro/kernels/embedding_bag.py:63"),
    }
    record = []
    for name, (src, replaces) in sources.items():
        call_ms, dev_ms, plain_ms, lib_ms, b_ms, b_by = timing[name]
        dev_ms = sum(dev_ms.values()) if dev_ms else None
        record.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max_err[name],
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
