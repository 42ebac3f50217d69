"""The window's model operations (``counts/lm_train.py`` over the tokens
of its steps) over its wall time, as a share of the card's bf16 peak."""

from harness import cell, peaks


def read(run):
    if run["mode"] != "train" or not run["attempted"]:
        return None
    flops, _ = cell.count("lm_train")(model=run["model"], tokens=run["tokens"],
                                      seq=int(run["mix"]["seq"]))
    return 100.0 * flops / run["window_s"] / peaks.BF16_FLOPS
