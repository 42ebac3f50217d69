"""Whole runs of each cell at small widths on the CPU: the program's plain
path against the plain reference comes out correct, every end-to-end
metric reads, and each fault a cell can have, planted under the timed
path, makes ``correct`` false."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import small
from harness import cell as cells

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
TRAIN = [w for w in CELLS if ".train." in w]
PREFILL = [w for w in CELLS if ".prefill." in w]
SEED = 2**31 + 11


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    out = small.run(workload, SEED)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    c = small.load(workload)
    for m in c.end_to_end:
        v = cells.reader(m["name"])(out)
        assert v is not None and v > 0, m["name"]


def _unchanged(step):
    def broken(params, opt, batch, wt, acc):
        new = step(params, opt, batch, wt, acc)
        return (params, opt, new[2], wt, acc)
    return broken


def _half_batch(step):
    def broken(params, opt, batch, wt, acc):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(params, opt, half, wt, acc)
    return broken


def _rows_altered(step):
    def broken(params, opt, batch, wt, acc):
        p, o, met, t, a = step(params, opt, batch, wt, acc)
        return p, o, met, t + 0.05 * torch.randn_like(t), a
    return broken


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _rows_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_training_fault_is_caught(workload, fault):
    out = small.run(workload, SEED, faults={"step": fault})
    assert not out["correct"], out["checks"]


def _ps_drops_late_pushes(cluster):
    """From the sixth push on (past the three checked steps), one node's
    MEM-PS keeps every other pushed row as it was."""
    mem = cluster.nodes[0].mem
    push, n = mem.push, [0]

    def broken(keys, values, unpin=True):
        n[0] += 1
        if n[0] > 5:
            keys = np.asarray(keys)
            values = np.array(values, copy=True)
            values[::2] = mem.pull(keys[::2], pin=False)
        return push(keys, values, unpin=unpin)
    mem.push = broken


@pytest.mark.parametrize("workload", TRAIN)
def test_ps_fault_in_the_window_is_caught(workload):
    out = small.run(workload, SEED, faults={"ps": _ps_drops_late_pushes})
    assert not out["correct"], out["checks"]
    checks = {name: (v, lim) for name, v, lim in out["checks"]}
    assert checks["ps_rows"][0] > 0 and checks["table3"][0] <= checks["table3"][1]


def _runner_up(sample):
    def broken(logits):
        return torch.topk(logits[:, -1], 2, dim=-1).indices[:, 1:].to(torch.int32)
    return broken


@pytest.mark.parametrize("workload", PREFILL)
def test_serving_fault_is_caught(workload):
    out = small.run(workload, SEED, faults={"sample": _runner_up})
    assert not out["correct"], out["checks"]
