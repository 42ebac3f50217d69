"""Everything ``BENCHMARK.json`` names resolves to a file of its own under
``portbench/``, and the file keeps to the contract's shapes."""

import json
import re
from pathlib import Path

import pytest

from harness import cell

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and SPEC["command"][1].startswith("portbench/")
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = ROOT / c["file"]
    assert path.parts[len(ROOT.parts)] == "portbench" and path.is_file()
    data = json.loads(path.read_text())
    assert data["name"] == c["name"] and data["source"] == c["source"]
    assert sorted(data["reduced"]) == sorted(c["reduced"])
    assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    c = cell.load(name)
    assert c.mode in ("train", "prefill")
    assert (ROOT / "portbench" / "harness" / f"{c.mode}.py").is_file()
    assert c.chips == 1
    ends = {m["name"] for m in c.end_to_end}
    assert "setup_s" in ends and len(ends) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in ends
    assert set(c.limits) and all(isinstance(v, (int, float)) for v in c.limits.values())
    c.model()


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_reader(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert callable(cell.reader(m["name"]))
    for w in m.get("workloads", []):
        assert w in CELLS
    if m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_names_are_unique_and_small():
    for group in (SPEC["configs"], SPEC["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
