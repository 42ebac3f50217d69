"""Device-side feature extraction over staged raw records, in PyTorch.

The port of the reference's ``ingest/extract.py``. :class:`DeviceIngestor`
is the ingest pipeline stage's engine: it takes a
:class:`~repro_torch.data.synthetic_ctr.RawRecordBatch` (unhashed uint64
feature-id surrogates, ragged per-example nnz), stages the raw planes
through the :class:`~repro_torch.ingest.staging.StagingRing`, and runs the
hash + slot-bucket kernel (:func:`repro_torch.kernels.ops.feature_extract`,
the ``feature_extract`` CUDA kernel on the card) on the staged tensors —
emitting the exact ``(keys, slot_of, valid)`` layout the embedding-bag
kernel consumes.

Parity contract: for any raw batch, the produced planes are **bitwise
equal** to the host feeder's numpy extraction
(:func:`repro_torch.data.synthetic_ctr.extract_host`) at the same pack width.

The raw ids travel as one u64 plane (an int64 tensor holding the bit
pattern): 8 bytes per id, as the reference's two u32 planes, so
``staging_bytes`` counts the same. The pull/push stage needs the batch's
keys on the host (the PS hierarchy is a host subsystem), so the extracted
u64 key plane makes one device->host hop, also modelled through the NIC.
Everything else (slot_of, valid, labels) stays on the device: the transfer
stage reshapes those tensors instead of uploading host ones again.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from repro_torch.data.synthetic_ctr import KEY_SEED, SLOT_SEED, RawRecordBatch
from repro_torch.ingest.staging import StagedBatch, StagingRing
from repro_torch.kernels import ops as kops


@dataclass
class IngestedBatch:
    """A train-ready batch whose planes live on the device.

    Duck-types ``CTRBatch`` for the trainer's pull/transfer/train stages:
    ``keys`` is host uint64 (the PS pull needs host keys); ``slot_of`` /
    ``valid`` / ``labels`` are device tensors from the staging slot. The
    train stage releases ``staged`` when the batch's step commits.
    """

    keys: np.ndarray  # uint64 [B, P] — host, for the PS pull
    slot_of: Any  # int32 [B, P] — device
    valid: Any  # bool [B, P] — device
    labels: Any  # float32 [B] — device
    batch_id: int
    staged: StagedBatch | None = None


class DeviceIngestor:
    """Raw records -> staged, device-extracted batches."""

    def __init__(
        self,
        *,
        n_keys: int,
        n_slots: int,
        pack_width: int,
        network=None,
        deps=None,
        counters=None,
        depth: int = 2,
        key_seed: int = KEY_SEED,
        slot_seed: int = SLOT_SEED,
        device="cuda",
    ):
        self.n_keys = n_keys
        self.n_slots = n_slots
        self.pack_width = pack_width
        self.key_seed = key_seed
        self.slot_seed = slot_seed
        self.network = network
        self.ring = StagingRing(
            depth=depth, network=network, deps=deps, counters=counters, device=device
        )
        self.counters = self.ring.counters

    def ingest(self, raw: RawRecordBatch) -> IngestedBatch:
        """Stage one raw batch and extract its features on the device."""
        B, L = raw.raw_ids.shape
        P = self.pack_width
        ids = np.asarray(raw.raw_ids, dtype=np.uint64)[:, :P]
        if L < P:  # reader rows narrower than the pack width: pad (invalid)
            ids = np.pad(ids, ((0, 0), (0, P - L)))
        lengths = np.asarray(raw.lengths, dtype=np.int32)
        valid = np.arange(P, dtype=np.int32)[None, :] < lengths[:, None]
        staged = self.ring.stage(
            raw.batch_id,
            {
                "raw": np.ascontiguousarray(ids).view(np.int64),  # u64 bits
                "valid": valid,
                "labels": np.asarray(raw.labels, dtype=np.float32),
            },
        )
        keys_dev, slot_dev = kops.feature_extract(
            staged.tensors["raw"],
            staged.tensors["valid"],
            n_keys=self.n_keys,
            n_slots=self.n_slots,
            key_seed=self.key_seed,
            slot_seed=self.slot_seed,
        )
        # the one device->host hop: the PS pull wants host u64 keys. The copy
        # waits for the extraction on the shared stream, so downstream stages
        # never see a half-written plane.
        keys = keys_dev.cpu().numpy().view(np.uint64)
        if self.network is not None:
            self.network.transfer(int(keys.nbytes))
        self.counters.inc("ingest_examples", B)
        return IngestedBatch(
            keys=keys,
            slot_of=slot_dev,
            valid=staged.tensors["valid"],
            labels=staged.tensors["labels"],
            batch_id=raw.batch_id,
            staged=staged,
        )

    def release(self, batch: IngestedBatch) -> None:
        if batch.staged is not None:
            self.ring.release(batch.staged)

    def reset(self) -> None:
        """Restart the staging ring's sequence space (a new pipeline run);
        the caller owns ordering, as for :meth:`StagingRing.reset`."""
        self.ring.reset()
