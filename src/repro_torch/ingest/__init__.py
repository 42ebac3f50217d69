"""Streaming on-device ingestion, in PyTorch.

Raw log records (unhashed feature-id surrogates + ragged nnz) in,
train-ready batches on the device out. Two pieces:

* :class:`~repro_torch.ingest.staging.StagingRing` — a depth-2 host->device
  staging ring; staging batch k+1 overlaps the pull/transfer/train of batch
  k, and slot reuse is sequenced through the pipeline's DependencyRegistry
  so an abort can never strand a waiter.
* :class:`~repro_torch.ingest.extract.DeviceIngestor` — stages a raw batch
  and runs the hash/slot-bucket extraction
  (:func:`repro_torch.kernels.ops.feature_extract`, the ``feature_extract``
  CUDA kernel on the card) over the staged planes, yielding an
  :class:`~repro_torch.ingest.extract.IngestedBatch` that duck-types
  ``CTRBatch`` for the trainer's pull/transfer/train stages.

The extraction is bitwise-equal to the host feeder
(:func:`repro_torch.data.synthetic_ctr.extract_host`).
"""

from repro_torch.ingest.extract import DeviceIngestor, IngestedBatch
from repro_torch.ingest.staging import StagedBatch, StagingRing

__all__ = ["DeviceIngestor", "IngestedBatch", "StagedBatch", "StagingRing"]
