"""Time embedding_lookup's and feature_extract's kernels on the card.

At each named shape the script holds both ``embedding_lookup`` kernels
(``subwarp``, ``warp``) against the plain version (bitwise) and times them
per launch (``chip_smoke.lookup_held``: torch.profiler, warm L2) beside the
floor probe, ``F.embedding`` and the bytes bound; ``fe`` does the same for
``feature_extract``'s ``recip`` and ``div`` kernels at ctr-C-scaled's ingest
batch. ``plans`` instead sweeps the subwarp kernel's launch numbers at each
shape: rows a task, chunks a lane, warps a block, and a grid capped at 4
blocks an SM (each warp looping over the tasks), against the plan's own.
``profiler`` checks the profiler itself: at each shape, ``REPEATS``
profiles of 50 subwarp launches read two ways (``key_averages``' mean, as
``chip_smoke.device_kernel_ms`` reads it, with its event count; and each
launch's event, as ``chip_smoke.kernel_launches_ms``), beside CUDA events
around the same 50 launches. The LM prefill shapes take ``TokenStream``
prompts' ids into a table of their distinct tokens, as the serving path
does; the others seeded random ids (for the ``sharded_`` shapes a quarter of
them owned, the rest row 0, as ``psum_body`` gives shard 0). Needs a card;
runs from the repository's root:

    python tools/lookup_timing.py [plans | profiler] [NAME ...]

Each NAME is one of ``SHAPES`` below or ``fe``; with none, everything. One
JSON line a shape, the card's name and power limit first.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import embedding_lookup as el  # noqa: E402

# name: table rows (0: a prefill's distinct tokens of a 64,000 vocabulary), D, ids
SHAPES = {
    "yi_prefill": (0, 4096, 8_192),
    "yi_decode": (3_729, 4096, 4),
    "hymba_prefill": (0, 1600, 8_192),
    "xlstm_prefill": (0, 2048, 8_192),
    "whisper_prefill": (509, 384, 896),
    "sharded_ctr": (67_415, 8, 256_000),
    "sharded_lm": (933, 4096, 8_192),
    "tp_yi": (3_729, 2048, 4_096),
    "tp_olmoe": (3_698, 1024, 4_096),
    "tp_hymba_m2": (3_603, 800, 4_096),
    "tp_hymba_m5": (3_603, 320, 4_096),
    "tp_xlstm_m2": (1_531, 1024, 1_536),
    "tp_xlstm_m8": (1_531, 256, 1_536),
    "tp_whisper_m2": (509, 192, 448),
    "tp_whisper_m4": (509, 96, 448),
}


def inputs(name: str, n: int, d: int, b: int):
    from repro_torch.data.tokens import TokenStream

    g = torch.Generator().manual_seed(n + d + b)
    if n == 0:
        tok = TokenStream(64000, 4, b // 4, seed=0).next_batch()[:, : b // 4].reshape(-1)
        uniq, inv = np.unique(tok, return_inverse=True)
        n, ids = len(uniq), torch.from_numpy(inv.astype(np.int32))
    else:
        ids = torch.randint(0, n, (b,), generator=g, dtype=torch.int32)
        if name.startswith("sharded_"):
            ids = torch.where(ids % 4 == 0, ids // 4, 0).to(torch.int32)
    return torch.randn(n, d, generator=g).cuda(), ids.cuda()


def plans_row(table, ids) -> dict:
    """The subwarp kernel at each launch plan near the chosen one."""
    (_, D), B = table.shape, ids.shape[0]
    own = el.lookup_plan(B, D, 4, True, el._n_sms(0))
    L, C, R = own.lanes, own.chunks, 32 // own.lanes
    want, out = el.embedding_lookup_plain(table, ids), {}
    for rb, k in ((1, 1), (2, 1), (4, 1), (8, 1), (1, 2), (1, 4), (1, 8)):
        if (k > 1 and (L != 32 or k // 2 * L >= C)) or (rb > 1 and L < C):
            continue
        P = -(-C // (L * k))
        T = -(-B // (R * rb)) * P
        for wpb, cap in ((8, None), (4, None), (2, None), (8, 4 * el._n_sms(0))):
            grid = -(-T // wpb) if cap is None else min(-(-T // wpb), cap)
            plan = own._replace(row_batches=rb, per_lane=k, pieces=P, tasks=T, grid=grid,
                                block=32 * wpb)

            def run(plan=plan):
                got = torch.empty((B, D), device=table.device)
                el._run(table, ids, got, plan, first_only=False)
                return got

            cs.check(torch.equal(run(), want), f"{plan}: kernel != plain")
            key = f"rb{rb} k{k} block{32 * wpb}" + ("" if cap is None else f" grid<={cap}")
            out[key] = cs.kernel_launches_ms(run, "lookup_kernel", iters=40)["ms"]
    best = sorted(out.items(), key=lambda kv: float("inf") if kv[1] is None else kv[1])
    return {"plan": f"rb{own.row_batches} k{own.per_lane} block{own.block}",
            "ms": dict(best)}


REPEATS = 10


def profiler_row(table, ids) -> dict:
    """The subwarp kernel's time per launch, read each way, ``REPEATS``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = lambda: el.embedding_lookup_cuda(table, ids)
    run()
    torch.cuda.synchronize()
    reads = []
    for _ in range(REPEATS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(50):
                run()
            torch.cuda.synchronize()
        avg = [(ev.key, ev.count, ev.self_device_time_total / ev.count / 1e3)
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and "lookup_kernel" in ev.key]
        us = sorted(ev.time_range.elapsed_us() for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA and "lookup_kernel" in ev.name)
        reads.append({
            "key_averages": [{"key": k[:60], "count": c, "mean_ms": m} for k, c, m in avg],
            "events": len(us), "median_ms": us[len(us) // 2] / 1e3 if us else None,
            "min_ms": us[0] / 1e3 if us else None, "max_ms": us[-1] / 1e3 if us else None,
            "cuda_events_ms": cs.cuda_ms(run, iters=50)})
    return {"reads": reads}


def fe_row() -> dict:
    from repro_torch.configs.ctr_models import SCALED
    from repro_torch.data.synthetic_ctr import SyntheticCTRStream, extract_host
    from repro_torch.kernels.feature_extract import feature_extract_cuda

    cfg = SCALED["C"]
    first = next(SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots,
                                    cfg.batch_size, seed=cs.TRAIN_STREAM_SEED).raw_records())
    want_k, want_s, want_v = extract_host(first.raw_ids, first.lengths, cfg.n_sparse_keys,
                                          cfg.n_slots)
    raw = torch.from_numpy(np.ascontiguousarray(first.raw_ids).view(np.int64)).cuda()
    valid = torch.from_numpy(want_v).cuda()
    n, n_valid = raw.numel(), int(valid.sum())
    rec = {"shape": list(raw.shape), "valid": n_valid,
           "bound_ms": (8 * n_valid + 13 * n) / cs.HBM_BYTES_PER_S * 1e3}
    for v in ("recip", "div"):
        run = lambda: feature_extract_cuda(raw, valid, n_keys=cfg.n_sparse_keys,
                                           n_slots=cfg.n_slots, key_seed=17, slot_seed=31,
                                           variant=v)
        k, s = run()
        cs.check(np.array_equal(k.cpu().numpy().view(np.uint64), want_k)
                 and np.array_equal(s.cpu().numpy(), want_s), f"feature_extract {v} != host")
        rec[f"{v}_ms"] = sum(cs.device_kernel_ms(run, ("feature_extract_kernel",),
                                                 iters=50).values())
        rec[f"{v}_sass"] = cs.sass_static(build.library_path("feature_extract"),
                                          f"feature_extract_kernel_{v}")
    return rec


def main() -> int:
    args = sys.argv[1:]
    mode = args[0] if args[:1] in (["plans"], ["profiler"]) else None
    only = args[1:] if mode else args
    print(cs.card(), flush=True)
    build.build_all()
    for name, (n, d, b) in SHAPES.items():
        if not only or name in only:
            table, ids = inputs(name, n, d, b)
            rec = (plans_row(table, ids) if mode == "plans" else
                   profiler_row(table, ids) if mode == "profiler" else
                   cs.lookup_held(name, table, ids, beside=True))
            print(name, json.dumps(rec), flush=True)
    if not mode and (not only or "fe" in only):
        print("fe", json.dumps(fe_row()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
