"""The end-to-end CTR trainer: Algorithm 1 + the 4-stage pipeline, in PyTorch.

The port of the reference's ``train/trainer.py``; the stages keep their
structure:

  stage 1 (read)      — synthetic HDFS stream -> CTRBatch
  stage 2 (pull/push) — PSClient.session on the "ctr" table: applies the
                        deferred push of completed batches, pulls the new
                        batch's fresh keys (MEM-PS + SSD-PS + remote
                        pulls), and resolves cross-batch conflicts by
                        per-key version forwarding — all SSD/MEM-PS
                        traffic stays on this stage's thread, overlapped
                        with device compute
  stage 3 (transfer)  — host -> device copies of the minibatch tensors and
                        only the *delta* working rows; rows shared with the
                        previous batch stay device-resident
                        (DeviceWorkingSet remap)
  stage 4 (train)     — k mini-batches, each with the bag's backward through
                        the scatter_add kernel, AdamW on the tower and
                        row-Adagrad through the fused_adagrad kernel;
                        results are committed with ``defer=True`` for the
                        pull/push stage to push, keeping this stage device
                        compute

The overlap is lossless: pipelined and serial execution produce bitwise-
identical loss trajectories and parameter state, because every kernel on
the path sums in a fixed order (no float atomics).

The trainer runs on ``device`` ("cuda" unless the caller asks for "cpu",
where the kernels' plain versions run). Its tower is drawn from a
``torch.Generator`` seeded with ``seed``; to start from the reference's
weights, assign ``convert.tower_from_numpy`` output to ``tower``.

Fault tolerance: periodic async checkpoints persist tower/opt state and the
PS cluster manifest; ``resume`` restores and continues deterministically;
``ride_through`` recovers a killed node mid-run, bitwise.

Serving handoff: with ``publish_every``/``publish_dir`` set, the trainer
periodically publishes versioned serving snapshots (repro_torch.serve.snapshot)
at the same consistent cut a checkpoint would capture.

Streaming ingestion: with ``TrainerConfig(ingest=True)`` the stream yields
``RawRecordBatch`` (unhashed ids, ragged nnz) and an ingest stage ahead of
pull/push stages them through the double-buffered ring and extracts keys and
slots on the device (the ``feature_extract`` kernel on the card), bitwise
equal to the host feeder.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.ctr_models import CTRConfig, table_specs
from repro_torch.core.client import PSClient
from repro_torch.core.compression import WireConfig
from repro_torch.core.hbm_ps import DeviceWorkingSet
from repro_torch.core.node import Cluster, NodeDownError
from repro_torch.core.pipeline import Pipeline, Stage
from repro_torch.data.synthetic_ctr import CTRBatch
from repro_torch.device import resolve_device
from repro_torch.models import ctr as ctr_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamW
from repro_torch.train.train_step import make_ctr_train_step


@dataclass
class TrainerConfig:
    row_lr: float = 0.05
    tower_lr: float = 1e-3
    checkpoint_every: int = 0  # batches; 0 = off
    checkpoint_dir: str = ""
    publish_every: int = 0  # batches; 0 = off — versioned serving snapshots
    publish_dir: str = ""
    publish_keep: int = 2  # auto-release published versions beyond this many
    queue_capacity: int = 2
    # straggler threshold for the read stage (the paper's HDFS-read
    # stragglers); the stateful stages (pull/push pins rows, transfer
    # advances the reuse plan, train owns the model) are never speculated
    stage_timeout: float | None = None
    device_reuse: bool = True  # cross-batch device working-set residency
    # ride-through recovery: on a NodeDownError mid-pipeline, recover the
    # dead node (restart + redo-log replay), land the trained prefix's
    # deferred pushes, drain the untrained remainder, replay it serially
    # from the batch replay buffer, then resume pipelining — the recovered
    # run's losses stay bitwise-equal to a fault-free run
    ride_through: bool = False
    max_recoveries: int = 4  # distinct faults survived per run() call
    redo_rows: int = 262_144  # redo-log auto-flush bound (ride_through)
    # streaming ingestion: the stream yields RawRecordBatch (unhashed ids,
    # ragged nnz) and an ingest stage ahead of pull/push stages them through
    # the double-buffered ring + extracts features on the device; False =
    # classic host feeder (stream yields CTRBatch)
    ingest: bool = False
    # ring slots (2 = the paper-style slot pair); kept for parity with the
    # reference's TrainerConfig, whose runs all use the default
    staging_depth: int = 2
    # training wire: wire_quantize_train turns on the int8 delta push with
    # per-key error feedback — LOSSY (bitwise serial parity no longer
    # holds); the error-feedback residual rides checkpoints under the
    # "wire_ef" subtree. wire_dedup_window > 0 additionally serves
    # repeat-key pulls from the pushed-row window (lossless)
    wire_quantize_train: bool = False
    wire_dedup_window: int = 0


class CTRTrainer:
    def __init__(self, cfg: CTRConfig, cluster: Cluster, tcfg: TrainerConfig | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.cluster = cluster
        # each trainer gets its own config object — a shared mutable default
        # instance would leak one caller's mutations into every other trainer
        self.tcfg = tcfg if tcfg is not None else TrainerConfig()
        tcfg = self.tcfg
        # one named table per slot group (SSD row = [emb | adagrad accum])
        assert len(cfg.groups) == 1, "CTRTrainer pipelines a single table"
        self.device = resolve_device(device)
        self.wire = WireConfig(
            quantize_push=tcfg.wire_quantize_train,
            dedup_window=tcfg.wire_dedup_window,
        )
        self.client = PSClient(cluster, table_specs(cfg), wire=self.wire)
        self.table = cfg.groups[0].name
        self.ps = self.client.engine(self.table)  # per-table engine (stats, tests)
        self.dev_ws = DeviceWorkingSet(row_bytes=2 * cfg.emb_dim * 4)
        self.tower = ctr_model.init_tower(cfg, torch.Generator().manual_seed(seed), self.device)
        self.opt = AdamW(lr=tcfg.tower_lr)
        self.opt_state = self.opt.init(self.tower)
        self.step_fn = make_ctr_train_step(cfg, tcfg.row_lr, self.opt)
        self.batches_done = 0
        self.losses: list[float] = []
        self._prev_table = None  # previous batch's final device rows
        self._prev_accum = None
        self._train_seq = 0  # device-table generation (guards reuse plans)
        # ride-through state: batches enter _replay when the feeder hands
        # them to the pipeline and leave when their train stage completes,
        # so a mid-pipeline failure knows exactly which batches still need
        # (re-)training; _results collects every completed batch's result
        # dict even when the pipeline dies before yielding it downstream
        self._replay: dict[int, CTRBatch] = {}
        self._results: dict[int, dict] = {}
        self.recovery_time_s = 0.0
        # streaming ingestion: raw records are staged + device-extracted by
        # a dedicated pipeline stage; the ring shares the client's
        # DependencyRegistry so pipeline aborts wake staging waiters
        self.ingestor = None
        if tcfg.ingest:
            from repro_torch.ingest import DeviceIngestor

            self.ingestor = DeviceIngestor(
                n_keys=cfg.n_sparse_keys,
                n_slots=cfg.n_slots,
                pack_width=cfg.nnz_per_example,
                network=cluster.network,
                deps=self.client.deps,
                depth=tcfg.staging_depth,
                device=self.device,
            )
        if self.tcfg.ride_through:
            cluster.enable_redo(self.tcfg.redo_rows)
        self.ckpt = (
            ckpt.AsyncCheckpointer(tcfg.checkpoint_dir) if tcfg.checkpoint_every else None
        )
        # versioned serving snapshots: publishing repoints the log-structured
        # SSD files behind a manifest — no copy of the table
        self.publisher = None
        if tcfg.publish_every or tcfg.publish_dir:
            if not tcfg.publish_dir:
                raise ValueError("publish_every requires publish_dir to be set")
            from repro_torch.serve.snapshot import SnapshotPublisher

            self.publisher = SnapshotPublisher(
                cluster, tcfg.publish_dir, keep=tcfg.publish_keep
            )

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------ stages
    def _stage_ingest(self, raw):
        # stage the raw planes into the next ring slot (overlapping the
        # previous batch's pull/transfer/train) and extract (keys, slot_of,
        # valid) on the device; the result duck-types CTRBatch downstream
        return self.ingestor.ingest(raw)

    def _drain_release(self, item):
        """on_drain hook: free the staging slot of a batch the pipeline
        dropped at shutdown (stage outputs carry the batch first)."""
        batch = item[0] if isinstance(item, tuple) else item
        staged = getattr(batch, "staged", None)
        if staged is not None:
            self.ingestor.ring.drain_release(staged)

    def _stage_pull(self, batch: CTRBatch):
        # opening the session also applies completed predecessors' deferred
        # pushes on this thread, then pulls fresh keys / forwards
        # conflicting ones; batch_id dedups straggler re-execution (no
        # double pinning). With device reuse on, keys shared with the
        # immediately-preceding batch are served from the device-resident
        # copy (no host value, no wait)
        sess = self.client.session(
            self.table, batch.keys, batch_id=batch.batch_id,
            device_resident_prev=self.tcfg.device_reuse,
        )
        return batch, sess

    def _stage_transfer(self, item):
        batch, sess = item
        k = self.cfg.minibatches_per_batch
        B = batch.keys.shape[0]
        mb = B // k
        # an ingested batch's slot_of/valid/labels are already on the
        # device: reshaping them moves nothing
        sl = lambda a: self._to_device(a.reshape((k, mb) + a.shape[1:]))
        minibatches = {
            "slot_ids": sl(sess.slots),
            "slot_of": sl(batch.slot_of),
            "valid": sl(batch.valid),
            "labels": sl(batch.labels),
        }
        if self.tcfg.device_reuse:
            # only the delta crosses the host->device link; rows shared with
            # the previous batch are remapped on device at train time
            plan = self.dev_ws.plan(sess.keys, batch_id=batch.batch_id)
            params = self._to_device(sess.params[plan.fresh_dst])
            accum = self._to_device(sess.opt_state[plan.fresh_dst])
        else:
            plan = None
            params = self._to_device(sess.params)
            accum = self._to_device(sess.opt_state)
        return batch, sess, minibatches, plan, params, accum

    def _stage_train(self, item):
        batch, sess, minibatches, plan, params, accum = item
        if plan is None:
            table, row_accum = params, accum
        else:
            # a plan that reuses rows must remap from the table produced by
            # the generation right before it (full-transfer plans resync
            # after a reset/aborted run, where no residency is assumed)
            if plan.n_reused and plan.seq != self._train_seq + 1:
                raise RuntimeError(
                    f"device working-set plan {plan.seq} does not match table "
                    f"generation {self._train_seq} (pipeline stage skipped?)"
                )
            table = DeviceWorkingSet.assemble(self._prev_table, params, plan)
            row_accum = DeviceWorkingSet.assemble(self._prev_accum, accum, plan)
        self.tower, self.opt_state, new_table, new_accum, metrics = self.step_fn(
            self.tower, self.opt_state, table, row_accum, minibatches
        )
        self._prev_table, self._prev_accum = new_table, new_accum
        if plan is not None:
            self._train_seq = plan.seq
        # deferred commit: the pull/push stage thread pushes the rows
        # through MEM-PS -> SSD-PS and forwards them to any successor batch
        # waiting on these keys — this stage stays device compute
        sess.commit(new_table.cpu().numpy(), new_accum.cpu().numpy(), defer=True)
        loss = float(metrics["loss"])
        self.losses.append(loss)
        self.batches_done += 1
        if self.ckpt and self.batches_done % self.tcfg.checkpoint_every == 0:
            # flush deferred pushes so the manifest captures a consistent
            # cut: all batches up to and including this one. The manifest
            # records the hosted table specs alongside the SSD file map.
            self.client.apply_ready_pushes()
            tree = {"tower": self.tower, "opt": self.opt_state}
            wire_ef = self.client.wire_state()
            if wire_ef:
                # the lossy wire's per-key quantization residuals are model
                # state: resuming without them re-applies error the next
                # pushes already carried
                tree["wire_ef"] = wire_ef
            self.ckpt.save(
                self.batches_done,
                tree,
                extra={"losses": self.losses[-16:]},
                ps_manifest=self.client.manifest(),
            )
        if (
            self.publisher
            and self.tcfg.publish_every
            and self.batches_done % self.tcfg.publish_every == 0
        ):
            self.publish()
        # the staged planes have been consumed: free the ring slot so the
        # batch depth slots ahead can start staging (double-buffer release)
        staged = getattr(batch, "staged", None)
        if staged is not None:
            self.ingestor.ring.release(staged)
        result = {"batch_id": batch.batch_id, "loss": loss, "n_working": sess.n_working}
        # recorded here (not at the pipeline sink): a batch whose result
        # dict is still in a queue when the pipeline dies has already
        # trained — it must count as done, not be replayed
        self._results[batch.batch_id] = result
        self._replay.pop(batch.batch_id, None)
        return result

    def publish(self) -> int:
        """Publish a serving snapshot at a consistent cut: every batch up to
        and including the last trained one has its deferred push applied and
        its dirty rows flushed before the version manifest is written."""
        assert self.publisher is not None, "configure publish_dir/publish_every"
        self.client.apply_ready_pushes()
        return self.publisher.publish()

    # ------------------------------------------------------------ running
    def build_pipeline(self) -> Pipeline:
        t = self.tcfg
        stages = [
            # only the read stage is side-effect free, so it alone gets
            # straggler speculation (the paper's HDFS-read stragglers)
            Stage("read", lambda b: b, capacity=t.queue_capacity,
                  timeout=t.stage_timeout),
        ]
        rel = self._drain_release if self.ingestor is not None else None
        if self.ingestor is not None:
            # a fresh pipeline run resets the registry (Pipeline.run ->
            # deps.reset), dropping the previous run's slot-free tokens —
            # the ring's sequence space must restart with it
            self.ingestor.ring.reset()
            # stage() claims a monotone ring sequence number: re-execution
            # would burn slots, so never speculated
            stages.append(
                Stage("ingest", self._stage_ingest, capacity=t.queue_capacity,
                      idempotent=False, on_drain=rel)
            )
        stages += [
            # pull/push pins MEM-PS rows and registers in-flight batches,
            # transfer advances the device-reuse plan, train owns the
            # model state: NOT idempotent, never speculated
            Stage("pull_push", self._stage_pull, capacity=t.queue_capacity,
                  idempotent=False, on_drain=rel),
            Stage("transfer", self._stage_transfer, capacity=t.queue_capacity,
                  idempotent=False, on_drain=rel),
            # train mutates tower/opt state before it can fail, so a
            # retry would apply the batch's gradient step twice
            Stage("train", self._stage_train, capacity=t.queue_capacity,
                  idempotent=False, max_retries=0),
        ]
        return Pipeline(stages, deps=self.client.deps)

    def _serial_step(self, batch):
        """One batch through the full stage chain on the calling thread —
        the serial baseline and the ride-through replay path."""
        if self.ingestor is not None:
            batch = self._stage_ingest(batch)
        return self._stage_train(self._stage_transfer(self._stage_pull(batch)))

    def _record(self, src):
        """Tee the source into the replay buffer: every batch handed to the
        pipeline is retained until its train stage completes."""
        for b in src:
            self._replay[b.batch_id] = b
            yield b

    @staticmethod
    def _node_down_in(e: BaseException | None) -> bool:
        """Is a NodeDownError anywhere in the cause chain? (The pipeline
        wraps stage errors in PipelineError ``from`` the root cause.)"""
        seen: set[int] = set()
        while e is not None and id(e) not in seen:
            if isinstance(e, NodeDownError):
                return True
            seen.add(id(e))
            e = e.__cause__ or e.__context__
        return False

    def _ride_through(self) -> None:
        """Recover from a node kill mid-pipeline, preserving the bitwise
        serial-parity contract:

        1. restart + redo-replay every dead node (exact pre-kill values);
        2. drain: the trained prefix's deferred pushes land (train runs in
           batch order, so trained in-flight entries are always a prefix),
           the untrained remainder is unpinned and forgotten;
        3. replay the untrained batches serially — serial and pipelined
           execution are bitwise-identical, so the recovered trajectory
           equals the fault-free one;
        4. the caller then resumes pipelined execution on the rest of the
           stream. A second fault during replay lands back here."""
        t0 = time.perf_counter()
        self.cluster.recover_dead_nodes()
        # strict drain: after recovery, a push failure is a real error
        self.client.drain()
        self.dev_ws.reset()
        if self.ingestor is not None:
            # the aborted pipeline left ring slots occupied; replay re-stages
            # every unfinished batch from its raw record, so restart the ring
            self.ingestor.ring.reset()
        self._prev_table = self._prev_accum = None
        for bid in sorted(self._replay):
            batch = self._replay[bid]  # popped by _stage_train on success
            self._serial_step(batch)
        self.recovery_time_s += time.perf_counter() - t0

    def run(self, stream, n_batches: int, pipelined: bool = True):
        src = (next(it) for it in [iter(stream)] for _ in range(n_batches))
        self._replay.clear()
        self._results.clear()
        recorded = self._record(src)
        recoveries = 0
        while True:
            try:
                if pipelined:
                    pipe = self.build_pipeline()
                    for _ in pipe.run(recorded):
                        pass  # results are recorded at the train stage
                    self.last_pipeline = pipe
                else:  # serial baseline (the "no pipeline" ablation)
                    if self.ingestor is not None:
                        self.ingestor.ring.reset()
                    for b in recorded:
                        self._serial_step(b)
                break
            except BaseException as e:
                # a further kill *during* the replay lands back here too:
                # keep recovering until the replay completes or the budget
                # (or a non-node-down failure) stops it
                while (
                    self.tcfg.ride_through
                    and recoveries < self.tcfg.max_recoveries
                    and self._node_down_in(e)
                ):
                    recoveries += 1
                    try:
                        self._ride_through()
                        e = None
                        break
                    except BaseException as e2:
                        e = e2
                if e is None:
                    continue  # resume pipelining on the remaining stream
                # failure path: release pins without masking the primary error
                self.client.drain(strict=False)
                self.dev_ws.reset()
                if self.ingestor is not None:
                    self.ingestor.ring.reset()
                raise e
        # success path: the tail batches' deferred pushes MUST land (a
        # failure here is a real error) — then drop cross-run device
        # residency: a later run may follow a resume(), where the cached
        # rows no longer match the cluster state
        self.client.drain()
        self.dev_ws.reset()
        if self.ingestor is not None:
            self.ingestor.ring.reset()
        if self.ckpt:
            self.ckpt.wait()
        return [self._results[b] for b in sorted(self._results)]

    # ------------------------------------------------------------ recovery
    def resume(self) -> int:
        """Restore tower/opt + PS manifest from the latest checkpoint."""
        tree, step, extra, ps_manifest = ckpt.restore(
            self.tcfg.checkpoint_dir, {"tower": self.tower, "opt": self.opt_state}
        )
        tree = ckpt.tree_map(self._to_device, tree)
        self.tower, self.opt_state = tree["tower"], tree["opt"]
        self.batches_done = step
        if ps_manifest is not None:
            # rebuild with the original capacities/network model — restoring
            # with defaults would silently change cache behaviour. The
            # manifest's recorded table specs win over the live registry
            # (they describe what the checkpointed rows actually contain).
            kw = self.cluster.ctor_kwargs()
            kw["tables"] = None  # defer to the manifest's table specs
            self.cluster = Cluster.restore(ps_manifest, self.cluster.base_dir, **kw)
            # re-adding the config's specs is a no-op when the manifest
            # already recorded them (and covers pre-multi-table manifests)
            self.client = PSClient(self.cluster, table_specs(self.cfg), wire=self.wire)
            self.ps = self.client.engine(self.table)
            if self.publisher is not None:
                # re-take live versions' retention refs on the restored SSDs
                self.publisher.rebind(self.cluster)
        if self.wire.quantize_push:
            # rebind the error-feedback residuals captured at the same cut
            # as the manifest (absent in pre-wire checkpoints -> fresh EF)
            self.client.load_wire_state(
                ckpt.restore_extra_arrays(self.tcfg.checkpoint_dir, "wire_ef/", step=step)
            )
        self.dev_ws.reset()
        self._prev_table = self._prev_accum = None
        return step
