"""The median time to first token over every request of the window."""

import statistics


def read(run):
    if run["mode"] != "prefill" or not run.get("ttft_s"):
        return None
    return statistics.median(run["ttft_s"]) * 1e3
