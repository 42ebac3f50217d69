"""Roofline terms of one rank's step on an H100, from the dry run's counts.

Three terms per (arch x shape x mesh), in seconds a step on one rank:

  compute    = sum over dtypes of FLOPs / the card's peak for that dtype
  memory     = HBM bytes / HBM bandwidth
  collective = sum over mesh axes of link bytes / that axis's link bandwidth

The counts come from ``launch/op_analysis.py`` (one rank's step traced on
the meta device), so they are per rank already.

Constants. The card's (NVIDIA H100 SXM data sheet; the same figures bound
each kernel in ``chip_smoke.py``): bf16 dense tensor cores 989 TFLOP/s,
fp32 outside the tensor cores 67 TFLOP/s (the port does not enable TF32),
HBM3 3.35 TB/s. The links are a deployment assumption, not a measurement:
``model`` inside one 8-card NVLink node, 450 GB/s each way a card
(NVLink 4, 18 links); ``data`` (and ``pod``) across nodes over one 400 Gb/s
NDR InfiniBand port a card, 50 GB/s, as in NVIDIA's DGX H100.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

import torch

PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float16: PEAK_FLOPS_BF16,
              torch.float32: PEAK_FLOPS_FP32}
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s each way a card, inside a node (assumed deployment)
NET_BW = 50e9  # bytes/s a card across nodes: one 400 Gb/s NDR port (assumed deployment)
LINK_BW = {"model": NVLINK_BW, "data": NET_BW, "pod": NET_BW}


def compute_seconds(flops_by_dtype: dict) -> float:
    """FLOPs of each dtype over the card's peak for it (fp32's for any
    other)."""
    return sum(f / PEAK_FLOPS.get(dt, PEAK_FLOPS_FP32) for dt, f in flops_by_dtype.items())


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_rank: float
    bytes_per_rank: float
    collective_bytes_per_rank: float  # operand bytes, all kinds
    collective_counts: dict
    collective_bytes_by_kind: dict
    link_bytes_by_axis: dict  # what the rank's links carry, per mesh axis
    model_flops_global: float  # 6ND for training, 2ND for inference
    n_ranks: int
    memory_per_rank: dict
    t_compute: float
    trace_seconds: float = 0.0
    kernel_calls: dict = field(default_factory=dict)
    flops_by_dtype: dict = field(default_factory=dict)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_rank / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(b / LINK_BW[axis] for axis, b in self.link_bytes_by_axis.items())

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """model FLOPs / (counted FLOPs x ranks): above 1 the count misses
        work, below 1 remat and attention add work that 6ND leaves out."""
        counted = self.flops_per_rank * self.n_ranks
        return self.model_flops_global / counted if counted else float("inf")

    @property
    def roofline_fraction(self) -> float:
        """The useful compute's share of the bounding term: (model FLOPs /
        ranks / bf16 peak) / max(term)."""
        t_useful = self.model_flops_global / self.n_ranks / PEAK_FLOPS_BF16
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        d = asdict(self)
        d["flops_by_dtype"] = {str(k).replace("torch.", ""): v
                               for k, v in self.flops_by_dtype.items()}
        d.update(t_memory=self.t_memory, t_collective=self.t_collective,
                 bottleneck=self.bottleneck, useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def analyze(arch: str, shape: str, mesh_name: str, counter, model_flops_global: float,
            n_ranks: int, memory_per_rank: dict) -> Roofline:
    """A :class:`Roofline` from an ``op_analysis.OpCounter``'s totals."""
    counts, by_kind, link = counter.collective_stats()
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_rank=counter.flops, bytes_per_rank=float(counter.hbm_bytes),
        collective_bytes_per_rank=float(sum(by_kind.values())), collective_counts=counts,
        collective_bytes_by_kind=by_kind, link_bytes_by_axis=link,
        model_flops_global=model_flops_global, n_ranks=n_ranks,
        memory_per_rank=memory_per_rank,
        t_compute=compute_seconds(counter.flops_by_dtype), trace_seconds=counter.seconds,
        kernel_calls=counter.kernel_calls(), flops_by_dtype=dict(counter.flops_by_dtype))


def model_flops(cfg, shape, n_params_active: int) -> float:
    """6*N*D for training; 2*N*D for inference (fwd only). D = tokens."""
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * toks
    toks = shape.global_batch * 1
    return 2.0 * n_params_active * toks
