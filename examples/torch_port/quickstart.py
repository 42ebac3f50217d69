"""Quickstart on the PyTorch port: the hierarchical parameter server in ~70 lines.

Builds a 2-node PS cluster (MEM-PS cache over SSD-PS files), opens a named
table on it, pulls a batch session's working set, trains k mini-batches on
the device, commits the updates back — Algorithm 1 of the paper, end to
end, through the multi-table client API (PSClient / TableSpec /
BatchSession). On the card the step runs the port's CUDA kernels
(embedding_bag, its backward through scatter_add, fused_adagrad).

Run:  PYTHONPATH=src python examples/torch_port/quickstart.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs.ctr_models import TINY
from repro_torch.core.client import PSClient
from repro_torch.core.node import Cluster
from repro_torch.core.tables import RowSchema, TableSpec
from repro_torch.data.synthetic_ctr import SyntheticCTRStream
from repro_torch.device import resolve_device
from repro_torch.models import ctr as ctr_model
from repro_torch.train.optim import AdamW
from repro_torch.train.train_step import make_ctr_train_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the port's kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = TINY
    tmp = tempfile.mkdtemp(prefix="hps_quickstart_")

    # 3-tier PS: SSD files <- DRAM cache <- device working table. The
    # cluster hosts one named table whose rows pack [emb | adagrad accum].
    cluster = Cluster(
        n_nodes=2, base_dir=tmp, dim=cfg.emb_dim * 2,
        cache_capacity=4096, file_capacity=128,
    )
    client = PSClient(cluster, [TableSpec("ctr", RowSchema.with_adagrad(cfg.emb_dim))])

    tower = ctr_model.init_tower(cfg, torch.Generator().manual_seed(0), dev)
    opt = AdamW(lr=1e-3)
    opt_state = opt.init(tower)
    step = make_ctr_train_step(cfg, row_lr=0.05, tower_opt=opt)

    stream = SyntheticCTRStream(
        cfg.n_sparse_keys, cfg.nnz_per_example, cfg.n_slots, cfg.batch_size, seed=0
    )
    for i in range(10):
        batch = stream.next_batch()
        # session = pull + dedup + renumber (pinned); commit = push + unpin
        with client.session("ctr", batch.keys) as s:
            k = cfg.minibatches_per_batch
            mb = cfg.batch_size // k
            stack = lambda a: torch.as_tensor(a.reshape((k, mb) + a.shape[1:]), device=dev)
            minibatches = {
                "slot_ids": stack(s.slots),
                "slot_of": stack(batch.slot_of),
                "valid": stack(batch.valid),
                "labels": stack(batch.labels),
            }
            tower, opt_state, table, accum, metrics = step(
                tower, opt_state, torch.as_tensor(s.params, device=dev),
                torch.as_tensor(s.opt_state, device=dev), minibatches
            )
            s.commit(table.cpu().numpy(), accum.cpu().numpy())
        print(f"batch {i}: loss={float(metrics['loss']):.4f} working_set={s.n_working}")

    hits = sum(n.mem.stats.hits for n in cluster.nodes)
    misses = sum(n.mem.stats.misses for n in cluster.nodes)
    print(f"MEM-PS hit rate: {hits / (hits + misses):.1%}; "
          f"remote bytes: {cluster.network.bytes_moved:,}")
    cluster.destroy()


if __name__ == "__main__":
    main()
