"""The 95th percentile of time to first token over every request of the
window (``statistics.quantiles``, inclusive of the ends)."""

import statistics


def read(run):
    if run["mode"] != "prefill" or len(run.get("ttft_s") or ()) < 2:
        return None
    return statistics.quantiles(run["ttft_s"], n=20, method="inclusive")[-1] * 1e3
