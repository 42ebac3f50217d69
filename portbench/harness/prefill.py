"""The ``prefill`` mode: time to first token through the serving path, one
client in a closed loop.

Set-up makes the weights (in the type they are served in) and a token
table of every id from the seed, publishes the table as one snapshot
version to ``nodes`` PS nodes under the run's temporary directory, builds
``ServingEngine(ServingCluster(dir), device_hot_rows=...)``, looks every
id of the table up once (so that the engine's caches hold what a server
that has run for a while holds), and serves ``warm`` requests. Each request is ``rows`` prompts of ``seq`` tokens, a new
draw from the seed; its time to first token runs from the hand-off of its
ids to ``engine.lookup_device`` through ``make_prefill_step`` to
``greedy_sample``'s token on the host. The next request follows at once.

Checked after the window: every request's rows on the card against the
table (exact), and for a sample of the requests, drawn from the seed, the
first token and the last position's logits against the plain reference
over the same prompt.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from harness import compare, weights
from harness.trace import Calls, Profile, Spans
from harness.traffic import Tokens
from reference import lm as ref


def run(cell, seed: int, seconds: float, trace: bool, device, *, clock=None,
        faults=None) -> dict:
    from repro_torch.convert import publish_arrays
    from repro_torch.core.tables import RowSchema, TableSpec
    from repro_torch.kernels import ops as kops
    from repro_torch.models import get_model
    from repro_torch.serve import ServingCluster, ServingEngine
    from repro_torch.serve import serve_step

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    clock = clock or time.perf_counter
    mix, m, arch = cell.mix, cell.model(), cell.arch()
    flat = weights.make(m, seed, torch.bfloat16, device)
    schema = {k: tuple(v.shape) for k, v in ref.leaves(get_model(arch).schema(arch)).items()}
    if schema != {k: tuple(v.shape) for k, v in flat.items()}:
        raise RuntimeError("the benchmark's weights are not the program's layout")
    params = ref.unflatten(flat)
    table = weights.table_rows(m.vocab, m.d, seed, device)
    base = tempfile.mkdtemp(prefix="portbench_serve_")
    spans, prof = Spans(), Profile()
    calls = Calls(kops, {"flash_attention_cuda": "flash_fwd"})
    sample = serve_step.greedy_sample
    if faults and "sample" in faults:
        sample = faults["sample"](sample)
    try:
        spec = TableSpec("tok_emb", RowSchema.embedding(m.d))
        publish_arrays(base, n_nodes=int(mix["nodes"]), dim=m.d, tables={
            "tok_emb": (spec, np.arange(m.vocab, dtype=np.uint64), table.cpu().numpy())})
        engine = ServingEngine(ServingCluster(base), device_hot_rows=int(mix["device_hot_rows"]),
                               device=device)
        engine.lookup_device("tok_emb", np.arange(m.vocab, dtype=np.uint64))
        prefill = serve_step.make_prefill_step(arch)
        tokens = Tokens(mix, m.vocab, seed, targets=False)
        bad = torch.zeros((), dtype=torch.int64, device=device)
        served = []  # (prompt, token, last logits) of each request of the window

        def request(keep: bool) -> float:
            prompt = tokens.draw()
            t0 = time.perf_counter()
            spans.begin("lookup")
            slots, wt = engine.lookup_device("tok_emb", prompt.astype(np.uint64))
            spans.end("lookup")
            spans.begin("prefill")
            slots_dev = torch.from_numpy(np.ascontiguousarray(slots)).to(device)
            logits, cache = prefill(params, {"tokens": slots_dev, "working_table": wt})
            spans.end("prefill")
            spans.begin("sample")
            tok = sample(logits).cpu().numpy()
            spans.end("sample")
            ttft = time.perf_counter() - t0
            ids = torch.from_numpy(prompt.astype(np.int64)).to(device)
            bad.add_((wt[slots_dev.long()] != table[ids]).any(dim=-1).any(dim=-1).sum())
            if keep:
                served.append((prompt, tok, logits[:, -1].float().clone()))
            return ttft

        for _ in range(int(mix["warm"])):
            request(False)
        sync()
        setup_s = clock()
        if cuda:
            peak_setup = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        spans.reset()
        if trace:
            if cuda:
                calls.install()
                prof.start()
            spans.marking = cuda
            calls.on = True
            spans.begin("window")
        ttfts = []
        hot = engine.device_hot_stats("tok_emb")
        moved = hot.rows_transferred if hot else 0
        t_start = time.perf_counter()
        while True:
            ttfts.append(request(True))
            t_end = time.perf_counter()
            if t_end - t_start >= seconds:
                break
        if trace:
            calls.on = False
            spans.end("window")
            spans.marking = False
            if cuda:
                prof.stop()
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
        out = dict(mode="prefill", setup_s=setup_s, window_s=t_end - t_start,
                   attempted=len(ttfts), failed=0, ttft_s=ttfts, tokens=len(ttfts) * int(mix["rows"]) * int(mix["seq"]),
                   spans=dict(spans.total), span_counts=dict(spans.count),
                   peak_bytes=max(peak_window, peak_setup if cuda else 0),
                   peak_window_bytes=peak_window, model=m, mix=mix)
        if trace:
            out["profile"] = prof.summary() if cuda else None
            out["calls"] = calls.timed() if cuda else []
        n_bad = int(bad)
        hot = engine.device_hot_stats("tok_emb")
        lookups = dict(rows_moved_to_card=(hot.rows_transferred - moved) if hot else None,
                       rows_reused=hot.rows_reused if hot else None)
        del engine
    finally:
        calls.uninstall()
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference, once the program's state is gone
    ref.strict_fp32()
    rng = np.random.default_rng([int(seed), 0xC4EC])
    pick = rng.choice(len(served), size=min(len(served), int(mix["check_requests"])),
                      replace=False)
    gaps, errs = [], []
    for i in sorted(pick):
        prompt, tok, got = served[i]
        for r in range(prompt.shape[0]):
            x = table[torch.from_numpy(prompt[r].astype(np.int64)).to(device)][None]
            want = ref.prompt_logits(m, params, x)[0]
            gaps.append(float(want.max() - want[int(tok[r, 0])]))
            errs.append(float((got[r] - want).abs().max() / want.abs().max()))
    numbers = {"rows": n_bad, "gap": max(gaps), "logits": max(errs)}
    out["correct"], out["checks"] = compare.judge(numbers, cell.limits)
    k = len(ttfts) // 3
    out["where"] = dict(readings=numbers, checked_requests=len(pick), lookups=lookups,
                        ttft_p50_ms_by_third=[1e3 * float(np.median(ttfts[i * k:(i + 1) * k]))
                                              for i in range(3)] if k else [],
                        span_ms_by_third=spans.by_third(("lookup", "prefill", "sample")))
    return out
