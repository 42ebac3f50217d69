"""Host milliseconds a step of the window spent in the PS client's session
(the pull of its working rows from MEM-PS/SSD-PS), mean a step."""


def read(run):
    n = run["span_counts"].get("pull", 0)
    return run["spans"]["pull"] / n * 1e3 if n else None
