"""The most device memory allocated at once during the window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run["peak_window_bytes"] / 2**30 if run["peak_window_bytes"] else None
