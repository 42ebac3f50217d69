"""The share of the traced window in which nothing ran on the device: one
less the union of its kernels', copies' and sets' intervals over the
window (torch.profiler)."""


def read(run):
    prof = run.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
