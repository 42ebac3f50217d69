"""End-to-end driver on the PyTorch port: train a ~100M-parameter CTR model
through the full hierarchical PS for a few hundred batches.

~100M trained parameters = 6M sparse keys x emb 8 (params + adagrad state
stream through MEM-PS/SSD-PS as one row on the named "ctr" table) + dense
tower. Runs the complete production path: raw-record streaming ingestion
(double-buffered staging + device feature extraction, DESIGN.md §11) ahead
of the 4-stage pipeline over PSClient batch sessions, multi-node pulls,
cache eviction, SSD compaction, async checkpoints (manifest records the
table specs), and AUC eval on held-out traffic through read-only sessions
(no pins, no registry). On the card the ingest feed hashes keys and slots
through the port's ``feature_extract`` kernel, and the step runs
``embedding_bag``, ``scatter_add`` and ``fused_adagrad``.

Run:  PYTHONPATH=src python examples/torch_port/train_ctr_e2e.py [--batches 200] [--device cpu]
      (--host-feeder falls back to the classic numpy host extraction)
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.ctr_models import CTRConfig
from repro_torch.core.node import Cluster
from repro_torch.data.synthetic_ctr import SyntheticCTRStream, to_ctr_batch
from repro_torch.models import ctr as ctr_model
from repro_torch.train.trainer import CTRTrainer, TrainerConfig


def evaluate_auc(tr: CTRTrainer, cfg: CTRConfig, n_batches: int = 4) -> float:
    from repro_torch.metrics import auc

    stream = SyntheticCTRStream(
        cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots, cfg.batch_size, seed=777
    )
    scores, labels = [], []
    on_dev = lambda a: torch.as_tensor(a, device=tr.device)
    for _ in range(n_batches):
        b = stream.next_batch()
        # read-only session: no pins, no in-flight registry — eval traffic
        # can never taint the training pipeline's device residency
        with tr.client.session(tr.table, b.keys, read_only=True) as s, torch.no_grad():
            logits = ctr_model.forward(
                cfg, tr.tower, on_dev(s.params),
                on_dev(s.slots), on_dev(b.slot_of), on_dev(b.valid),
            )
        scores.append(logits.cpu().numpy())
        labels.append(b.labels)
    return auc(np.concatenate(labels), np.concatenate(scores))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--keys", type=int, default=6_000_000)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--host-feeder", action="store_true",
                    help="classic host numpy feeder instead of the "
                    "streaming ingest pipeline (same batches bitwise)")
    ap.add_argument("--wire-quantize-train", action="store_true",
                    help="int8 quantized gradient push with error feedback "
                    "+ repeat-key pull dedup (DESIGN.md §13); prints the "
                    "per-conflict-class bytes-on-wire report")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the port's kernels) or cpu (their plain versions)")
    args = ap.parse_args()

    cfg = CTRConfig(
        name="ctr-100M",
        n_sparse_keys=args.keys,
        nnz_per_example=100,
        emb_dim=8,
        n_slots=25,
        mlp_hidden=(256, 128, 64),
        batch_size=4096,
        minibatches_per_batch=4,
    )
    total = cfg.sparse_params + cfg.dense_params
    print(f"model: {cfg.sparse_params/1e6:.0f}M sparse + {cfg.dense_params/1e3:.0f}k dense "
          f"= {total/1e6:.0f}M params (+{cfg.sparse_params/1e6:.0f}M adagrad rows on SSD)")

    tmp = tempfile.mkdtemp(prefix="hps_e2e_")
    cluster = Cluster(
        args.nodes, tmp + "/ps", dim=cfg.emb_dim * 2,
        cache_capacity=600_000, file_capacity=8192, init_cols=cfg.emb_dim,
    )
    tr = CTRTrainer(
        cfg, cluster,
        TrainerConfig(checkpoint_every=50, checkpoint_dir=tmp + "/ckpt",
                      ingest=not args.host_feeder,
                      wire_quantize_train=args.wire_quantize_train,
                      wire_dedup_window=4 if args.wire_quantize_train else 0),
        device=args.device,
    )
    if args.wire_quantize_train:
        print("wire: int8 quantized push + error feedback, dedup window 4")
    stream = SyntheticCTRStream(
        cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots, cfg.batch_size,
        seed=0, zipf_a=1.05, noise=0.5,
    )
    # both feeds derive from the same raw records, so --host-feeder trains
    # on bitwise-identical batches through the classic numpy extraction
    if args.host_feeder:
        src = (
            to_ctr_batch(r, cfg.n_sparse_keys, cfg.n_slots, cfg.nnz_per_example)
            for r in stream.raw_records()
        )
        mode = "host feeder (numpy extraction)"
    else:
        src = stream.raw_records()
        mode = "streaming ingest (device extraction + staging ring)"
    print(f"feed: {mode}")

    auc0 = evaluate_auc(tr, cfg)
    print(f"AUC before training: {auc0:.4f}")
    t0 = time.perf_counter()
    results = tr.run(src, args.batches)
    dt = time.perf_counter() - t0
    losses = [r["loss"] for r in results]
    ex_per_s = args.batches * cfg.batch_size / dt
    print(f"trained {args.batches} batches in {dt:.0f}s  ({ex_per_s:,.0f} examples/s)")
    print(f"loss: first10={np.mean(losses[:10]):.4f}  last10={np.mean(losses[-10:]):.4f}")
    auc1 = evaluate_auc(tr, cfg)
    print(f"AUC after training: {auc1:.4f}  (+{auc1 - auc0:.4f})")

    rep = tr.last_pipeline.report()
    busy = {k: f"{v['busy_s']:.1f}s" for k, v in rep.items()}
    print(f"pipeline stage busy times: {busy}; bottleneck={tr.last_pipeline.bottleneck()}")
    if tr.ingestor is not None:
        c = tr.ingestor.counters.snapshot()
        print(f"ingest: {c.get('ingest_batches', 0)} batches staged "
              f"({c.get('staging_bytes', 0)/2**20:.0f} MiB through the ring), "
              f"slot wait {c.get('ingest_wait_us', 0)/1e6:.2f}s, "
              f"overlap {c.get('ingest_overlap_us', 0)/1e6:.2f}s")
    if args.wire_quantize_train:
        wc = tr.client.wire_counters()
        ratio = wc["wire_push_raw_bytes"] / max(1, wc["wire_push_enc_bytes"])
        print(f"wire push: {wc['wire_push_rows']:,} rows, "
              f"{wc['wire_push_raw_bytes']/2**20:.1f} MiB raw -> "
              f"{wc['wire_push_enc_bytes']/2**20:.1f} MiB encoded "
              f"({ratio:.2f}x); NIC saved {cluster.network.push_bytes_saved/2**20:.1f} MiB")
        print("wire pull bytes saved by conflict class: "
              f"device-served {wc['wire_pull_device_bytes_saved']/2**20:.1f} MiB "
              f"({wc['wire_pull_device_rows']:,} rows), "
              f"forwarded {wc['wire_pull_forwarded_bytes_saved']/2**20:.1f} MiB "
              f"({wc['wire_pull_forwarded_rows']:,} rows), "
              f"dedup {wc['wire_pull_dedup_bytes_saved']/2**20:.1f} MiB "
              f"({wc['wire_pull_dedup_rows']:,} rows); fresh pulls "
              f"{wc['wire_pull_fresh_bytes']/2**20:.1f} MiB "
              f"({wc['wire_pull_fresh_rows']:,} rows)")
    hits = sum(n.mem.stats.hits for n in cluster.nodes)
    misses = sum(n.mem.stats.misses for n in cluster.nodes)
    live = sum(n.ssd.n_live_rows for n in cluster.nodes)
    amp = max(n.ssd.space_amplification() for n in cluster.nodes)
    print(f"MEM-PS hit rate {hits/(hits+misses):.1%}; SSD live rows {live:,}; "
          f"space amp {amp:.2f}; remote bytes {cluster.network.bytes_moved/2**20:.0f} MiB")


if __name__ == "__main__":
    main()
