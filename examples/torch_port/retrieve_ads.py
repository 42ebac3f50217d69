"""End-to-end ad retrieval demo on the PyTorch port: train -> publish -> index -> top-k serve.

The retrieval subsystem (DESIGN.md §12) as a production handoff:

1. a short CTR training run grows an embedding table through the full
   hierarchical PS (the same path ``train_ctr_e2e.py`` exercises at scale);
2. the trained state publishes as an immutable snapshot version (manifest
   repoint, no parameter copy);
3. a :class:`RetrievalEngine` binds that version — it scans the table's
   live rows into a device-resident corpus — and serves
   ``search(queries, k)`` via exact top-k MIPS;
4. each served user's pooled feature embedding becomes the query, and the
   feature-interaction ``rerank`` stage re-scores the candidates;
5. a second training burst + publish + ``roll_forward`` shows the index
   rolling to the new version atomically.

On the card the search runs the port's ``topk_mips`` kernel and the rerank
its ``embedding_bag`` kernel; training runs ``embedding_bag``, ``scatter_add``
and ``fused_adagrad``. The corpus is the table's live rows with their
features padded to a multiple of 4, and no rows padded
(``repro_torch.retrieval.index``).

Run:  PYTHONPATH=src python examples/torch_port/retrieve_ads.py [--batches 6] [--device cpu]
"""

import argparse
import tempfile

import numpy as np

from repro_torch.configs.ctr_models import TINY
from repro_torch.core.node import Cluster
from repro_torch.data.synthetic_ctr import SyntheticCTRStream
from repro_torch.retrieval import RetrievalEngine
from repro_torch.serve import SnapshotPublisher
from repro_torch.train.trainer import CTRTrainer, TrainerConfig


def pooled_user_queries(engine, table, batch, dim):
    """Sum-pool each example's feature embeddings into its query vector."""
    emb = engine.lookup(table, batch.keys)  # [B, nnz, dim]
    return np.einsum("bn,bnd->bd", batch.valid.astype(np.float32), emb), batch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the port's kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    cfg = TINY

    with tempfile.TemporaryDirectory() as tmp:
        cluster = Cluster(2, f"{tmp}/train", dim=cfg.emb_dim * 2,
                          cache_capacity=4096, file_capacity=256,
                          init_cols=cfg.emb_dim)
        trainer = CTRTrainer(cfg, cluster, TrainerConfig(), device=args.device)
        stream = SyntheticCTRStream(cfg.n_sparse_keys, cfg.nnz_per_example,
                                    cfg.n_slots, cfg.batch_size, seed=3)
        print(f"== training {args.batches} batches on {cfg.name!r}")
        for r in trainer.run(iter(stream), args.batches):
            print(f"   batch {r['batch_id']}: loss {r['loss']:.4f}")

        publisher = SnapshotPublisher(cluster, f"{tmp}/snap")
        v1 = publisher.publish()
        print(f"== published snapshot version {v1}")

        engine = trainer.client.serving_view(snapshots=publisher,
                                             cache_rows=4096, device=args.device)
        retr = RetrievalEngine(engine, trainer.table, retain_cluster=cluster,
                               device=args.device)
        idx = retr._index
        print(f"== index: {idx.n_rows} ads, corpus {tuple(idx.corpus.shape)}, "
              f"version {retr.version}")

        queries, batch = pooled_user_queries(
            engine, trainer.table, stream.next_batch(), cfg.emb_dim
        )
        res = retr.search(queries[:4], args.topk)
        print(f"== top-{args.topk} ads for 4 users (version {res.version})")
        for b in range(4):
            pairs = ", ".join(
                f"{int(k)}:{s:.3f}"
                for k, s in zip(res.ad_keys[b], res.scores[b])
            )
            print(f"   user {b}: {pairs}")

        rr = retr.rerank(res, batch.keys[:4], batch.slot_of[:4],
                         batch.valid[:4], n_slots=cfg.n_slots)
        print("== after feature-interaction rerank")
        for b in range(4):
            pairs = ", ".join(
                f"{int(k)}:{s:.3f}" for k, s in zip(rr.ad_keys[b], rr.scores[b])
            )
            print(f"   user {b}: {pairs}")

        print(f"== training {args.batches} more batches, then rolling forward")
        for _ in trainer.run(iter(stream), args.batches):
            pass
        v2 = publisher.publish()
        retr.roll_forward()
        res2 = retr.search(queries[:4], args.topk)
        print(f"== rolled {v1} -> {v2}; top ad for user 0 now "
              f"{int(res2.ad_keys[0, 0])}:{res2.scores[0, 0]:.3f}")

        print("== retrieval counters")
        for name, val in sorted(retr.counters.snapshot().items()):
            if val:
                print(f"   {name}: {val}")
        retr.close()


if __name__ == "__main__":
    main()
