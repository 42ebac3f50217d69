"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, flops_peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the memory's, whichever is longer."""
    return max(flops / flops_peak, nbytes / HBM_BYTES_PER_S)
