"""The window's model operations (``counts/lm_prefill.py`` for every
request) over its wall time, as a share of the card's bf16 peak."""

from harness import cell, peaks


def read(run):
    if run["mode"] != "prefill" or not run["attempted"]:
        return None
    flops, _ = cell.count("lm_prefill")(model=run["model"], rows=int(run["mix"]["rows"]),
                                        seq=int(run["mix"]["seq"]))
    return 100.0 * flops * run["attempted"] / run["window_s"] / peaks.BF16_FLOPS
