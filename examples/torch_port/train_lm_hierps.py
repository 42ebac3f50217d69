"""Train an LM with the hierarchical-PS embedding path on the PyTorch port
(paper technique on an assigned architecture family).

A reduced yi-style decoder trains on synthetic zipf tokens; the token
embedding lives in a named PS table ("tok_emb", rows = [emb | adagrad]),
pulled per batch as a working-table session, while the backbone trains
under AdamW — the exact integration the full-scale dry-run lowers for all
10 archs. Because tables are named and key-namespaced, this LM table can
co-host with CTR slot tables on the same cluster (tests/test_system.py).
On the card the step gathers the working rows through the port's
``embedding_lookup`` kernel (its backward through ``scatter_add``), runs
attention through ``flash_attention`` (128 tokens a row) and updates the
rows through ``fused_adagrad``.

Run:  PYTHONPATH=src python examples/torch_port/train_lm_hierps.py [--steps 100] [--device cpu]
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config, replace
from repro_torch.core.client import PSClient
from repro_torch.core.node import Cluster
from repro_torch.core.tables import RowSchema, TableSpec
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as T
from repro_torch.device import resolve_device
from repro_torch.train.optim import AdamW, tree_map
from repro_torch.train.train_step import TrainSettings, make_lm_train_step_hier


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the port's kernels) or cpu (their plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = replace(
        get_smoke_config("yi-9b"),
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, d_ff=512,
        head_dim=16, vocab_size=8192, embedding_mode="hier_ps",
    )
    params = tree_map(lambda t: t.to(dev), T.init(cfg, torch.Generator().manual_seed(0)))
    from repro_torch.models.common import param_count

    print(f"backbone params: {param_count(T.schema(cfg))/1e6:.1f}M + "
          f"{cfg.vocab_size * cfg.d_model/1e6:.1f}M embedding rows on the PS")

    tmp = tempfile.mkdtemp(prefix="hps_lm_")
    cluster = Cluster(2, tmp, dim=cfg.d_model * 2, cache_capacity=6000,
                      file_capacity=512, init_scale=0.02)
    client = PSClient(
        cluster, [TableSpec("tok_emb", RowSchema.with_adagrad(cfg.d_model))]
    )

    settings = TrainSettings(optimizer=AdamW(lr=3e-4), microbatches=1, row_lr=0.1)
    step = make_lm_train_step_hier(cfg, settings)
    opt_state = settings.optimizer.init(params)

    stream = TokenStream(cfg.vocab_size, batch_size=8, seq_len=128, seed=0)
    on_dev = lambda a: torch.as_tensor(a, device=dev)
    losses = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        toks = stream.next_batch()
        inputs, targets = toks[:, :-1], toks[:, 1:]
        with client.session("tok_emb", inputs.astype(np.uint64)) as s:
            batch = {"tokens": on_dev(s.slots), "targets": on_dev(targets.astype(np.int64))}
            params, opt_state, metrics, new_t, new_acc = step(
                params, opt_state, batch, on_dev(s.params), on_dev(s.opt_state)
            )
            s.commit(new_t.cpu().numpy(), new_acc.cpu().numpy())
        losses.append(float(metrics["loss"]))
        if (i + 1) % 20 == 0:
            print(f"step {i+1}: loss {np.mean(losses[-20:]):.4f} "
                  f"(working set {s.n_working} rows)")
    dt = time.perf_counter() - t0
    print(f"{args.steps} steps in {dt:.0f}s; loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}")
    hits = sum(n.mem.stats.hits for n in cluster.nodes)
    misses = sum(n.mem.stats.misses for n in cluster.nodes)
    print(f"embedding-row cache hit rate: {hits/(hits+misses):.1%}")
    cluster.destroy()


if __name__ == "__main__":
    main()
