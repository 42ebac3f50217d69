"""Operations and bytes of one attention forward call (``flash_fwd``):
q [B, H, Sq, hd] over k, v [B, Hkv, Skv, hd], causal and window masks by
absolute position with the queries at the last Sq positions of the keys.

Operations: two matmuls of 2 * hd each per kept (query, key) pair and
head (scores, then probabilities times values); the softmax is left out.
Bytes: q, k and v read once, the output written once in the inputs' type,
and, where asked for (``lse``), one float32 log-sum-exp per query row."""


def kept_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the masks, queries at positions
    skv - sq .. skv - 1."""
    total = 0
    for i in range(skv - sq, skv):
        hi = i + 1 if causal else skv
        lo = max(0, i - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def count(*, q, kv, causal=True, window=0, elem=2, lse=False, **_) -> tuple[float, float]:
    B, H, sq, hd = q
    _, hkv, skv, _ = kv
    pairs = kept_pairs(sq, skv, causal, window)
    flops = 4.0 * hd * pairs * B * H
    nbytes = elem * (2 * B * H * sq * hd + 2 * B * hkv * skv * hd) + (4 * B * H * sq if lse else 0)
    return flops, float(nbytes)
