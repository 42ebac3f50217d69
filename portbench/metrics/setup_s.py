"""Seconds from the process's start to the window's start: making the
inputs and weights, building the program's state, warming up."""


def read(run):
    return run["setup_s"]
