"""Host milliseconds of ``ServingEngine.lookup_device`` (plan, pull of the
rows not yet on the card, their copy and the working table's assembly),
mean a request of the window."""


def read(run):
    n = run["span_counts"].get("lookup", 0)
    return run["spans"]["lookup"] / n * 1e3 if n else None
