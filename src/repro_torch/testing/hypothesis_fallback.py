"""Fixed-seed fallback for ``hypothesis`` when it is not installed.

The property tests in this repo use a small slice of the hypothesis API:
``@given`` with positional or keyword strategies, ``@settings`` (in either
decorator order), ``HealthCheck``, and the ``lists`` / ``integers`` /
``floats`` / ``tuples`` / ``sampled_from`` / ``booleans`` strategies with
``.map`` / ``.filter``. This module reimplements exactly that slice as a
deterministic fixed-seed example generator, so the suite still *runs* the
property tests (rather than skipping them) in environments without
hypothesis. Test modules import it as:

    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st
    except ImportError:
        from repro_torch.testing.hypothesis_fallback import given, settings, st

It is NOT a general hypothesis replacement: no shrinking, no coverage
guidance, no database — just N deterministic examples per test (default 20,
honouring ``settings(max_examples=...)``), seeded from the test's qualified
name so runs are reproducible and order-independent.
"""

from __future__ import annotations

import inspect
import random
import types
import zlib


class Strategy:
    """A deterministic value generator: ``draw(rnd)`` -> example."""

    def __init__(self, draw):
        self._draw = draw

    def draw(self, rnd: random.Random):
        return self._draw(rnd)

    def map(self, fn) -> "Strategy":
        return Strategy(lambda rnd: fn(self._draw(rnd)))

    def filter(self, pred) -> "Strategy":
        def draw(rnd):
            for _ in range(1000):
                x = self._draw(rnd)
                if pred(x):
                    return x
            raise ValueError("filter predicate rejected 1000 consecutive examples")

        return Strategy(draw)


def integers(min_value: int, max_value: int) -> Strategy:
    return Strategy(lambda rnd: rnd.randint(min_value, max_value))


def floats(min_value: float, max_value: float, allow_nan: bool = False, **_kw) -> Strategy:
    return Strategy(lambda rnd: rnd.uniform(min_value, max_value))


def booleans() -> Strategy:
    return Strategy(lambda rnd: rnd.random() < 0.5)


def sampled_from(elements) -> Strategy:
    elements = list(elements)
    return Strategy(lambda rnd: rnd.choice(elements))


def tuples(*strategies: Strategy) -> Strategy:
    return Strategy(lambda rnd: tuple(s.draw(rnd) for s in strategies))


def lists(elements: Strategy, min_size: int = 0, max_size: int = 10, unique: bool = False) -> Strategy:
    def draw(rnd):
        size = rnd.randint(min_size, max_size)
        if not unique:
            return [elements.draw(rnd) for _ in range(size)]
        seen: list = []
        for _ in range(50 * max(1, size)):
            x = elements.draw(rnd)
            if x not in seen:
                seen.append(x)
            if len(seen) == size:
                break
        return seen if len(seen) >= min_size else seen + [elements.draw(rnd)]

    return Strategy(draw)


st = types.SimpleNamespace(
    integers=integers,
    floats=floats,
    booleans=booleans,
    sampled_from=sampled_from,
    tuples=tuples,
    lists=lists,
)


class HealthCheck:
    function_scoped_fixture = "function_scoped_fixture"
    too_slow = "too_slow"
    data_too_large = "data_too_large"
    filter_too_much = "filter_too_much"


def settings(max_examples: int | None = None, **_ignored):
    """Decorator recording ``max_examples``; other options are no-ops here.

    Works in either order relative to ``@given`` (hypothesis allows both):
    the attribute is read off the decorated object at call time.
    """

    def deco(fn):
        fn._fallback_max_examples = max_examples
        return fn

    return deco


def given(*pos_strategies: Strategy, **kw_strategies: Strategy):
    """Run the test over N fixed-seed examples.

    Positional strategies bind to the test's *last* parameters (hypothesis
    fills from the right, leaving leading parameters for pytest fixtures);
    keyword strategies bind by name. The wrapper exposes only the fixture
    parameters to pytest via ``__signature__``.
    """

    def deco(fn):
        sig = inspect.signature(fn)
        params = list(sig.parameters)
        strat_map: dict[str, Strategy] = {}
        if pos_strategies:
            for name, s in zip(params[len(params) - len(pos_strategies):], pos_strategies):
                strat_map[name] = s
        strat_map.update(kw_strategies)
        fixture_names = [p for p in params if p not in strat_map]

        def wrapper(*args, **kwargs):
            bound = dict(zip(fixture_names, args))
            bound.update(kwargs)
            n = (
                getattr(wrapper, "_fallback_max_examples", None)
                or getattr(fn, "_fallback_max_examples", None)
                or 20
            )
            seed0 = zlib.adler32(f"{fn.__module__}.{fn.__qualname__}".encode())
            for i in range(n):
                rnd = random.Random(seed0 * 100_003 + i)
                drawn = {name: s.draw(rnd) for name, s in strat_map.items()}
                fn(**bound, **drawn)

        wrapper.__name__ = fn.__name__
        wrapper.__qualname__ = fn.__qualname__
        wrapper.__module__ = fn.__module__
        wrapper.__doc__ = fn.__doc__
        wrapper.__signature__ = inspect.Signature(
            [sig.parameters[p] for p in fixture_names]
        )
        return wrapper

    return deco
