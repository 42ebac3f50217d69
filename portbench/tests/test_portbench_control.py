"""The lower-precision control (``control.py``: the plain reference with
every matmul's operands rounded to float8, in the program's place) comes
out not correct, at small widths on the CPU."""

import json
from pathlib import Path

import pytest

import control
import small
from harness import compare

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_control_is_not_correct(workload):
    c = small.load(workload)
    fn = control.train if c.mode == "train" else control.prefill
    readings = {r["reading"]: r["numbers"] for r in fn(c, 2**31 + 11, "cpu")}
    numbers = dict(readings["control_fp8"])
    if "rows" in c.limits:
        numbers["rows"] = 0  # the control places no rows on a card
    ok, rows = compare.judge(numbers, c.limits)
    assert not ok, rows
