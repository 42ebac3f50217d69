"""Operations and bytes of one attention backward call (``flash_bwd``): dq,
dk, dv of q [B, H, Sq, hd] over k, v [B, Hkv, Skv, hd] from the saved
output and log-sum-exp and the output's gradient, the masks as
``flash_fwd``'s.

Operations: five matmuls of 2 * hd each per kept pair and head (the scores
again, dP = dO V^T, dV += P^T dO, dQ += dS K, dK += dS^T Q). Bytes: q, k,
v, the output and its gradient read once and the log-sum-exp (float32),
dq, dk and dv written once."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_count_flash_fwd",
                                               Path(__file__).with_name("flash_fwd.py"))
_fwd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fwd)


def count(*, q, kv, causal=True, window=0, elem=2, **_) -> tuple[float, float]:
    B, H, sq, hd = q
    _, hkv, skv, _ = kv
    pairs = _fwd.kept_pairs(sq, skv, causal, window)
    flops = 10.0 * hd * pairs * B * H
    q_like, kv_like = B * H * sq * hd, B * hkv * skv * hd
    nbytes = elem * (4 * q_like + 4 * kv_like) + 4 * B * H * sq
    return flops, float(nbytes)
