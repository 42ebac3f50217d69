"""Tokens of every step completed in the window over the window's wall time."""


def read(run):
    if run["mode"] != "train" or not run["attempted"]:
        return None
    return run["tokens"] / run["window_s"]
