"""Device selection for the port's entry points.

Entry points take ``device=`` and default to ``"cuda"``: the port runs on
the card unless the caller asks for the CPU. Without a card, a CUDA device
fails here, loudly, instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
