"""Host milliseconds of the train step (forward, backward, AdamW, row
Adagrad), ending in a synchronisation, mean a step of the window."""


def read(run):
    n = run["span_counts"].get("step", 0)
    return run["spans"]["step"] / n * 1e3 if n else None
