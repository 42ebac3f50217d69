"""Double-buffered host->device batch staging, in PyTorch.

The port of the reference's ``ingest/staging.py``. The staging ring owns a
fixed pool of ``depth`` device buffer slots (the paper-style slot pair at
``depth=2``). Staging batch *k* copies its host planes to the ring's
``device`` and returns, so the copy of batch *k+1* overlaps the
pull/transfer/train of batch *k*; batch *k+depth* cannot stage until batch
*k*'s slot is released by the train stage — that back-pressure is what
bounds device memory to ``depth`` staged batches.

Buffer-ownership protocol (who may touch a slot, in order):

1. **stage(k)** — the ingest stage thread claims sequence number ``seq``
   under ``_lock``, then *outside the lock* waits for token
   ``("ingest_free", seq - depth)``, models the PCIe copy on the simulated
   NIC (``network.transfer`` — which is also where an injected NIC_STALL
   fault bites), and copies the host planes to the device. The slot now
   belongs to the staged batch.
2. **downstream stages** — pull/transfer/train read the slot's tensors but
   never write or free them.
3. **release(k)** — the train stage (or a drain/abort path) frees the slot:
   signals ``("ingest_free", seq)`` and collapses older tokens behind a
   floor so the registry stays bounded. Release is idempotent — the drain
   hook and the trainer's failure path may both call it.

All waits go through the pipeline's :class:`DependencyRegistry`, so
``Pipeline._shutdown``'s ``deps.abort()`` wakes a staging thread blocked on
a slot that will never free (it raises ``DependencyAborted`` instead of
hanging). ``reset()`` restarts the sequence space after ``deps.reset()``
(which drops all signalled tokens) — a new pipeline run on a mid-sequence
ring would otherwise wait forever on tokens from the previous run.

Every copy goes on PyTorch's current stream, which all the pipeline's
threads share (the default stream), so a slot's tensors are written before
any later launch that reads them.

pscheck: ``StagingRing._lock`` is declared non-blocking in the lock-order
table — the ``deps.wait`` / ``network.transfer`` / device copy calls all
happen outside it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.pipeline import DependencyRegistry
from repro_torch.device import resolve_device
from repro_torch.metrics import Counters

_FREE = "ingest_free"  # token family: ("ingest_free", seq) = slot seq freed


@dataclass
class StagedBatch:
    """One occupied ring slot: the device-resident planes of one batch."""

    seq: int  # monotone staging sequence number (ring slot = seq % depth)
    batch_id: int
    tensors: dict[str, Any]  # name -> device tensor
    nbytes: int
    t_staged: float  # perf_counter at stage() — overlap window start
    released: bool = field(default=False)


class StagingRing:
    """Fixed-depth ring of device staging slots with explicit ownership."""

    def __init__(
        self,
        depth: int = 2,
        network=None,  # NetworkModel: models the H2D copy + absorbs NIC faults
        deps: DependencyRegistry | None = None,
        counters: Counters | None = None,
        device="cuda",
    ):
        if depth < 1:
            raise ValueError("staging ring needs depth >= 1")
        self.depth = depth
        self.network = network
        self.deps = deps if deps is not None else DependencyRegistry()
        self.counters = counters if counters is not None else Counters()
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._seq = 0
        self._live: dict[int, StagedBatch] = {}  # seq -> occupied slot

    # ------------------------------------------------------------ protocol
    def stage(self, batch_id: int, host: dict[str, np.ndarray]) -> StagedBatch:
        """Claim the next slot and copy the host planes to the device.

        Blocks (via the DependencyRegistry, abort-safely) until the slot
        ``depth`` batches back has been released; time spent blocked is
        recorded as ``ingest_wait_us`` — with real overlap it stays near
        zero because train releases slots faster than ingest claims them.
        """
        with self._lock:
            seq = self._seq
            self._seq += 1
        if seq >= self.depth:
            t0 = time.perf_counter()
            self.deps.wait((_FREE, seq - self.depth))
            self.counters.inc(
                "ingest_wait_us", int((time.perf_counter() - t0) * 1e6)
            )
        nbytes = sum(int(np.asarray(v).nbytes) for v in host.values())
        if self.network is not None:
            # the modelled PCIe/NIC hop: counts bytes and (under fault
            # injection) is where a NIC_STALL lands mid-staging
            self.network.transfer(nbytes)
        # a copy, on the CPU too: the slot owns its planes
        tensors = {k: torch.tensor(np.asarray(v), device=self.device) for k, v in host.items()}
        staged = StagedBatch(
            seq=seq,
            batch_id=batch_id,
            tensors=tensors,
            nbytes=nbytes,
            t_staged=time.perf_counter(),
        )
        with self._lock:
            self._live[seq] = staged
        self.counters.inc("ingest_batches")
        self.counters.inc("staging_bytes", nbytes)
        return staged

    def release(self, staged: StagedBatch) -> None:
        """Free the slot for batch ``seq + depth``. Idempotent: the train
        stage, the pipeline drain hook, and the trainer's failure path may
        each call it without double-counting."""
        with self._lock:
            if staged.released:
                return
            staged.released = True
            self._live.pop(staged.seq, None)
        self.counters.inc(
            "ingest_overlap_us",
            int((time.perf_counter() - staged.t_staged) * 1e6),
        )
        self.deps.signal((_FREE, staged.seq))
        # collapse the token tail so the done-set stays bounded over long
        # runs; releases can arrive out of order on drain, so only the
        # contiguous released prefix is floored — later out-of-order
        # releases stay as individual tokens until the gap closes
        self.deps.set_floor(_FREE, self._contiguous_floor())

    def _contiguous_floor(self) -> int:
        """Highest seq S such that every slot <= S has been released."""
        with self._lock:
            live = sorted(self._live)
            top = self._seq - 1
        if not live:
            return top
        return live[0] - 1

    def drain_release(self, staged: StagedBatch) -> None:
        """Release path for batches the pipeline drained unconsumed."""
        self.counters.inc("ingest_drained")
        self.release(staged)

    def reset(self) -> None:
        """Restart the sequence space (new pipeline run). The caller owns
        ordering: only call with no stage() in flight, after the previous
        run's pipeline has shut down."""
        with self._lock:
            self._live.clear()
            self._seq = 0

    # ------------------------------------------------------------ inspect
    @property
    def live_slots(self) -> int:
        with self._lock:
            return len(self._live)

    @property
    def staged_total(self) -> int:
        with self._lock:
            return self._seq
