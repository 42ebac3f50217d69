"""The token generator: the same seed gives the same draws, every seed the
same sizes."""

import json
from pathlib import Path

import numpy as np
import pytest

from harness.traffic import Tokens

MIXES = sorted((Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))
SEEDS = [0, 7, 2**31 + 5, 2**40 + 3]


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_draws(path, seed):
    mix = json.loads(path.read_text())
    a = Tokens(mix, 64000, seed, targets=mix["mode"] == "train")
    b = Tokens(mix, 64000, seed, targets=mix["mode"] == "train")
    for _ in range(3):
        x, y = a.draw(), b.draw()
        assert x.dtype == np.int32 and np.array_equal(x, y)
        assert x.shape == (mix["rows"], mix["seq"] + (mix["mode"] == "train"))
        assert x.min() >= 0 and x.max() < 64000


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seeds_differ_in_ids_not_in_work(path):
    mix = json.loads(path.read_text())
    streams = [Tokens(mix, 50304, s, targets=True) for s in SEEDS]
    seen = [set() for _ in SEEDS]
    for _ in range(3):
        draws = [t.draw() for t in streams]
        assert len({d.shape for d in draws}) == 1
        assert not np.array_equal(draws[0], draws[1])
        # as many distinct ids, and as many new ones, in every seed's draw
        assert len({len(np.unique(d)) for d in draws}) == 1
        fresh = set()
        for ids, d in zip(seen, draws):
            new = set(np.unique(d).tolist()) - ids
            fresh.add(len(new))
            ids |= new
        assert len(fresh) == 1


def test_zipf_and_repeats_by_the_mix():
    mix = {"rows": 64, "seq": 512, "dist": "zipf", "zipf_a": 1.1, "repeat_prev": 0.2,
           "shape_seed": 0}
    x = Tokens(mix, 64000, 1, targets=False).draw()
    repeat = float(np.mean(x[:, 1:] == x[:, :-1]))
    assert 0.15 < repeat < 0.35  # the planted repeats (of the drawn neighbour) and zipf's head
    assert np.bincount(x.reshape(-1)).max() / x.size > 0.05  # the zipf head


def test_uniform_ids():
    mix = {"rows": 64, "seq": 512, "dist": "uniform", "repeat_prev": 0.0, "shape_seed": 0}
    x = Tokens(mix, 1000, 1, targets=False).draw()
    assert np.bincount(x.reshape(-1), minlength=1000).max() / x.size < 0.01
    assert len(np.unique(x)) == 1000
