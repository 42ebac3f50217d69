"""Serve a small LM with batched requests on the PyTorch port: prefill + greedy decode.

Serving subsystem walkthrough (DESIGN.md §7)
--------------------------------------------
This example runs the full train->serve handoff on one host:

1. **Publish** — the trainer-side cluster publishes a versioned snapshot
   (``SnapshotPublisher``): because the SSD-PS is log-structured, publishing
   just writes a manifest and repoints — no copy of the table — and the
   referenced parameter files are retained against compaction.
2. **Open read-only** — ``client.serving_view(snapshots=...)`` builds a
   ``ServingEngine`` over the published version: a version-keyed hot-row
   cache in DRAM, plus a ``DeviceHotSet`` that keeps the hottest token
   embeddings device-resident across decode steps (only the delta rows
   cross the host->device link).
3. **Decode** — each decode step is ONE ``engine.lookup_device`` call for
   the whole request batch; concurrent request streams would coalesce
   through ``engine.lookup``/``lookup_many`` into shared deduped pulls.

On the card the token rows are gathered by the port's ``embedding_lookup``
kernel (once per prefill and per step), and a prefill of at least 128
tokens runs attention through its ``flash_attention`` kernel.

``--wire-quantize`` opts remote shard reads into the int8 row-sparse wire
format (serving reads tolerate quantization; training pulls stay exact).
Serving counters (lookups, hot hits, device reuse, version rolls) come from
``engine.counters``.

Run:  PYTHONPATH=src python examples/torch_port/serve_lm.py [--new-tokens 32] [--device cpu]
"""

import argparse
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config, replace
from repro_torch.core.client import PSClient
from repro_torch.core.node import Cluster, NetworkModel
from repro_torch.core.tables import RowSchema, TableSpec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.attention import KVCache
from repro_torch.serve import SnapshotPublisher
from repro_torch.serve.serve_step import greedy_sample
from repro_torch.train.optim import tree_map


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--wire-quantize", action="store_true",
                    help="int8 wire format for remote serving reads")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the port's kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    cfg = replace(
        get_smoke_config("yi-9b"),
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_ff=256,
        head_dim=16, vocab_size=2048,
    )
    params = tree_map(lambda t: t.to(dev), T.init(cfg, torch.Generator().manual_seed(0)))
    max_len = args.prompt_len + args.new_tokens

    tmp = tempfile.mkdtemp(prefix="hps_serve_")
    cluster = Cluster(2, f"{tmp}/train", dim=cfg.d_model, cache_capacity=4096,
                      file_capacity=256, init_scale=0.02)
    # serving table: embedding only, no optimizer slots in the row
    client = PSClient(cluster, [TableSpec("tok_emb", RowSchema.embedding(cfg.d_model))])

    # --- train->serve handoff: publish a version, open it read-only
    publisher = SnapshotPublisher(cluster, f"{tmp}/snapshots")
    version = publisher.publish()
    engine = client.serving_view(
        snapshots=publisher,
        network=NetworkModel(wire_quantize=args.wire_quantize),
        cache_rows=4096, device_hot_rows=1024, device=dev,
    )

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)
    ).astype(np.uint64)
    on_dev = lambda slots: torch.as_tensor(slots, device=dev)

    # --- prefill: one engine lookup for the whole prompt working set
    t0 = time.perf_counter()
    slots, wt = engine.lookup_device("tok_emb", prompts)
    logits, cache = T.prefill(cfg, params, on_dev(slots), working_table=wt)
    pad = max_len - args.prompt_len
    cache = KVCache(*(F.pad(a, (0, 0, 0, pad)) for a in cache))
    sync()
    t_prefill = time.perf_counter() - t0

    # --- decode loop: ONE engine lookup per step for the whole batch; hot
    # token rows stay device-resident (DeviceHotSet), the rest read through
    # the version-keyed hot-row cache
    out_tokens = []
    tok_ids = greedy_sample(logits).cpu().numpy().astype(np.uint64)
    t0 = time.perf_counter()
    for i in range(args.new_tokens):
        slots, wt = engine.lookup_device("tok_emb", tok_ids)
        logits, cache = T.decode_step(
            cfg, params, on_dev(slots), cache, args.prompt_len + i, working_table=wt,
        )
        tok_ids = greedy_sample(logits).cpu().numpy().astype(np.uint64)
        out_tokens.append(tok_ids[:, 0])
    t_decode = time.perf_counter() - t0

    tps = args.batch * args.new_tokens / t_decode
    print(f"serving snapshot v{version} (publish = manifest repoint, no copy)")
    print(f"prefill: {args.batch}x{args.prompt_len} tokens in {t_prefill*1e3:.0f} ms")
    print(f"decode: {args.new_tokens} steps x {args.batch} seqs = {tps:,.0f} tok/s")
    c = engine.counters.snapshot()
    hot = c["hot_hits"] / max(1, c["hot_hits"] + c["hot_misses"])
    dev_stats = engine.device_hot_stats("tok_emb")
    print(f"hot-row cache hit rate: {hot:.1%} over {c['lookups']} lookups")
    print(f"device-resident reuse: {dev_stats.device_hit_rate:.1%} "
          f"({dev_stats.bytes_saved/2**10:.0f} KiB host->device saved)")
    if args.wire_quantize:
        net = engine.source.network
        print(f"wire-quantized replies: {net.quantized_messages} "
              f"({net.quantize_bytes_saved/2**10:.0f} KiB saved on the NIC)")
    print("sampled:", np.stack(out_tokens, axis=1)[0][:16], "...")
    cluster.destroy()


if __name__ == "__main__":
    main()
