"""The profile's reduction: busy time as the union of device intervals
within the window, and idle gaps put down to the host span they fall in."""

import pytest

from harness.trace import summarize

S = 1_000_000_000  # ns a second


def test_busy_is_the_union_within_the_window():
    dev = [(1 * S, 3 * S, "a"), (2 * S, 4 * S, "b"), (6 * S, 7 * S, "a"), (9 * S, 12 * S, "c")]
    out = summarize((0, 10 * S), [], dev)
    assert out["busy_s"] == pytest.approx(3 + 1 + 1)
    assert out["window_s"] == 10
    assert dict(map(tuple, out["device_ops"])) == pytest.approx({"a": 3, "b": 2, "c": 1})


def test_idle_gaps_by_host_span():
    dev = [(2 * S, 3 * S, "k"), (5 * S, 9 * S, "k")]
    spans = [(0, 2 * S + S // 2, "pull"), (2 * S + S // 2, 6 * S, "step"), (9 * S, 10 * S, "commit")]
    out = summarize((0, 10 * S), spans, dev)
    # gaps: [0, 2] in pull, [3, 5] in step, [9, 10] in commit
    assert dict(map(tuple, out["idle_gaps"])) == pytest.approx({"pull": 2, "step": 2, "commit": 1})
    assert out["busy_s"] == pytest.approx(5)


def test_no_device_work_is_all_idle():
    out = summarize((0, 4 * S), [(0, 4 * S, "lookup")], [])
    assert out["busy_s"] == 0 and out["idle_gaps"] == [["lookup", 4.0]]
