"""Host milliseconds a step of the window spent from the end of its train
step to the end of its commit (the new rows' copy to the host, then
``session.commit``), mean a step."""


def read(run):
    n = run["span_counts"].get("commit", 0)
    if not n:
        return None
    return (run["spans"].get("d2h", 0.0) + run["spans"]["commit"]) / n * 1e3
