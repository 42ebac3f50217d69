"""The attention backward's share of its roofline over the window: the sum
over its calls of the least time the card
could take (``counts/flash_bwd.py``, ``harness/peaks.py``) over the sum of
the calls' device time (CUDA events around each call)."""

from harness import cell, peaks

OP = "flash_bwd"


def read(run):
    calls = [c for c in run.get("calls", ()) if c["op"] == OP]
    if not calls:
        return None
    count = cell.count(OP)
    bound = sum(peaks.bound_s(*count(**c)) for c in calls)
    return 100.0 * bound / (sum(c["ms"] for c in calls) / 1e3)
