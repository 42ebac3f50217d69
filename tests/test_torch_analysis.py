"""The port's pscheck (``repro_torch.analysis``) against the reference's.

* The rules the port shares with the reference (PS101, PS201, PS202, PS301,
  PS401) give the same ``(rule, line, qualname)`` findings on the
  reference's rule fixtures.
* Every ``threading.Lock``/``RLock`` the port allocates is in the port's
  lock table, and a class the reference also declares keeps its spec.
* The port's restated rules (PS302, PS501, PS502) each flag their bug class
  and accept the port's own idiom (its kernel modules and dispatcher).
* The port's checker over its default paths is clean, with its baseline
  empty.
* The port's SanLock and the reference's find the same cycle, or none, on
  the same scripted acquisitions.
* The port's copy of the hypothesis fallback draws the reference's examples
  for the same qualified name.
"""

import ast
import textwrap
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import locks as ref_locks  # noqa: E402
from repro.analysis import rules as ref_rules  # noqa: E402
from repro.analysis import sanlock as ref_sanlock  # noqa: E402
from repro.testing import hypothesis_fallback as ref_hf  # noqa: E402
from repro_torch.analysis import check  # noqa: E402
from repro_torch.analysis import locks as port_locks  # noqa: E402
from repro_torch.analysis import rules as port_rules  # noqa: E402
from repro_torch.analysis import sanlock as port_sanlock  # noqa: E402
from repro_torch.testing import hypothesis_fallback as port_hf  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REG = frozenset({"lookups", "hot_hits"})
SHARED_RULES = {"PS101", "PS201", "PS202", "PS301", "PS401"}

# the reference's rule fixtures (tests/test_analysis.py), bad and good
FIXTURES = {
    "ps101_bad": """
    class Engine:
        def grab(self, keys):
            rows = self.cluster.pull(keys, pin=True)
            return rows
    """,
    "ps101_good": """
    class Engine:
        def grab(self, keys):
            rows = self.cluster.pull(keys, pin=True)
            try:
                return self.wrap(rows)
            except Exception:
                self.cluster.unpin(keys)
                raise

        def cursor(self):
            return self.redo.pin()  # redo-log cursor, not a row pin
    """,
    "ps201_order": """
    class ServingEngine:
        def bad(self):
            with self._cache_mu:
                with self._mu:
                    pass
    """,
    "ps201_undeclared": """
    class Widget:
        def f(self):
            with self._zzz_mu:
                pass
    """,
    "ps201_good": """
    class ServingEngine:
        def good(self):
            with self._mu:
                with self._cache_mu:
                    pass
    """,
    "ps201_reentry": """
    class RedoLog:
        def f(self):
            with self._lock:
                with self._lock:
                    pass

    class MemParameterServer:
        def g(self):
            with self._lock:
                with self._lock:
                    with self.ssd._lock:
                        pass
    """,
    "ps202_bad": """
    class ServingEngine:
        def bad(self, keys):
            with self._mu:
                return self.source.pull(keys)
    """,
    "ps202_transitive": """
    class ServingEngine:
        def helper(self, keys):
            return self.source.pull(keys)

        def bad(self, keys):
            with self._mu:
                return self.helper(keys)
    """,
    "ps202_good": """
    class ServingEngine:
        def good(self, keys):
            rows = self.source.pull(keys)
            with self._mu:
                self.cache[0] = rows
            return rows

    class MemParameterServer:
        def fill(self, keys):
            with self._lock:  # blocking_ok: SSD miss-fill is its design
                return self.ssd.read_batch(keys)
    """,
    "ps301_pass": "try:\n    f()\nexcept Exception:\n    pass",
    "ps301_bare": "try:\n    f()\nexcept:\n    x = 1",
    "ps301_critical": "def g():\n    try:\n        f()\n    except NodeDownError:\n        pass",
    "ps301_good": """
    def a():
        try:
            f()
        except Exception:
            raise

    def b(log):
        try:
            f()
        except Exception as err:
            log.append(err)

    def c(counters):
        try:
            f()
        except Exception:
            counters.inc("lookups")

    def d():
        try:
            f()
        except NodeDownError:
            recover()
    """,
    "ps401_bad": """
    self.counters.inc('nope')
    self.counters.inc(name)
    c = Counters('nope')
    COUNTER_NAMES = ('nope',)
    """,
    "ps401_good": """
    COUNTER_NAMES = ("lookups", "hot_hits")
    c = Counters("lookups")
    c.inc("hot_hits", 2)
    self.counters.inc("lookups")
    """,
}


def _shared(rules_mod, src, path):
    fs = rules_mod.run_rules(textwrap.dedent(src), path, registry=REG)
    return [(f.rule, f.line, f.qualname) for f in fs if f.rule in SHARED_RULES]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_shared_rules_find_what_the_reference_finds(name):
    src = FIXTURES[name]
    want = _shared(ref_rules, src, "src/repro/core/fake.py")
    got = _shared(port_rules, src, "src/repro_torch/core/fake.py")
    assert got == want
    assert bool(got) == (not name.endswith("_good")), got


def port_rules_of(src, path="src/repro_torch/core/fake.py"):
    return [f.rule for f in port_rules.run_rules(textwrap.dedent(src), path, registry=REG)]


# ------------------------------------------------------------ lock table
def _allocated_locks():
    """(owner key, attr, is RLock, file:line) for every threading.Lock() /
    RLock() call in the port outside analysis/: ``(class, attr)`` for
    ``self.attr = ...`` in a method, ``(module path, name)`` at module level."""
    out = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel.startswith("analysis/"):
            continue
        tree = ast.parse(path.read_text())

        def visit(node, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                    continue
                if isinstance(child, ast.Assign) and isinstance(child.value, ast.Call):
                    f = child.value.func
                    if (isinstance(f, ast.Attribute) and f.attr in ("Lock", "RLock")
                            and isinstance(f.value, ast.Name) and f.value.id == "threading"):
                        (t,) = child.targets
                        owner = cls if isinstance(t, ast.Attribute) else rel
                        attr = t.attr if isinstance(t, ast.Attribute) else t.id
                        out.append((owner, attr, f.attr == "RLock", f"{rel}:{child.lineno}"))
                visit(child, cls)

        visit(tree, None)
    return out


def test_every_port_lock_is_declared_and_shared_classes_keep_the_reference_spec():
    found = _allocated_locks()
    assert len(found) >= 15, found
    for owner, attr, rlock, site in found:
        spec = port_locks.LOCKS.get((owner, attr))
        assert spec is not None, f"{site}: {owner}.{attr} is not in the port's LOCK_ORDER"
        assert spec.reentrant == rlock, f"{site}: reentrant={spec.reentrant}, RLock={rlock}"
        ref = ref_locks.LOCKS.get((owner, attr))
        if ref is not None:
            assert (spec.level, spec.blocking_ok, spec.reentrant) == (
                ref.level, ref.blocking_ok, ref.reentrant), site
    declared = {(s.cls, s.attr) for s in port_locks.LOCK_ORDER}
    assert declared == {(o, a) for o, a, _r, _s in found}, "a declared lock no longer exists"
    assert ("kernels/build.py", "_lock") in declared


def test_module_lock_resolves_and_keeps_its_order():
    src = """
    _lock = threading.Lock()

    def library(name):
        with _lock:
            return build_all()

    class Counters:
        def bad(self):
            with self._lock:
                with _lock:
                    pass
    """
    fs = port_rules.run_rules(textwrap.dedent(src), "src/repro_torch/kernels/build.py",
                              registry=REG)
    assert [(f.rule, f.qualname) for f in fs] == [("PS201", "Counters.bad")], fs
    assert "kernels/build.py._lock" in fs[0].msg
    # the same name in a module that declares no lock is undeclared
    assert "PS201" in port_rules_of(src, "src/repro_torch/kernels/other.py")


# ------------------------------------------------------------------ PS302
@pytest.mark.parametrize("src", [
    # a shape condition around the plain version
    """
    def wrapper(x):
        if x.shape[0] % 8:
            return foo_plain(x)
        return foo_cuda(x)
    """,
    # the kernel under a shape condition, the plain version after it
    """
    def wrapper(x):
        if x.is_cuda and x.dtype == torch.float32:
            return foo_cuda(x)
        return foo_ref(x)
    """,
    # a failed launch swallowed into the plain version
    """
    def wrapper(x):
        try:
            return scatter_add_cuda_(x)
        except RuntimeError:
            return scatter_add_plain_(x)
    """,
    # even a loud one: the port has no fallback on the card
    """
    def wrapper(x):
        lib = build.library("foo")
        if x.numel() > 2**31:
            warnings.warn("too large, plain path")
            return foo_plain(x)
        return launch(lib, x)
    """,
], ids=["shape_branch", "shape_and_device_test", "except_around_launch", "loud_fallback"])
def test_ps302_flags_silent_fallbacks(src):
    assert "PS302" in port_rules_of(src)


def test_ps302_accepts_device_and_variant_dispatch():
    good = """
    def dispatch(x):
        if _on_meta(x):
            return foo_meta(x)
        if x.is_cuda:
            if x.dtype != torch.bool:
                x = x != 0
            return foo_cuda(x)
        return foo_plain(x)

    def by_variant(q, k, v):
        if flash_variant(q, k, v) == "hopper":
            return flash_cuda(q, k, v, variant="hopper")
        return flash_cuda(q, k, v, variant="simt")

    def on_device(t):
        if t.device.type == "cuda":
            return foo_cuda(t)
        return foo_ref(t)

    def no_kernel(x):
        if x.shape[0] % 8:
            return foo_plain(x)
        return x
    """
    assert "PS302" not in port_rules_of(good)


# ------------------------------------------------------------------ PS501
def test_ps501_flags_gathers_around_kernels_ops_only_under_models():
    src = """
    def fwd(p, ids, x, order):
        a = F.one_hot(ids, 100)
        b = torch.nn.functional.embedding(ids, p["tok_emb"])
        c = torch.take(p["tok_emb"], ids)
        d = p["tok_emb"].index_select(0, ids)
        e = torch.index_select(working_table, 0, ids)
        f = x.index_select(1, order)  # activations, not a table
        return a, b, c, d, e, f
    """
    assert port_rules_of(src, "src/repro_torch/models/fake.py").count("PS501") == 5
    assert "PS501" not in port_rules_of(src, "src/repro_torch/core/fake.py")


def test_ps501_pragmas_mark_the_moe_router_masks():
    src = (PORT / "models" / "moe.py").read_text()
    fs = port_rules.run_rules(src, "src/repro_torch/models/moe.py", registry=REG)
    lines = src.splitlines()
    ps501 = [f for f in fs if f.rule == "PS501"]
    assert len(ps501) == 2
    assert all("pscheck: ok PS501" in lines[f.line - 1] for f in ps501)


# ------------------------------------------------------------------ PS502
@pytest.mark.parametrize("src", [
    # return code dropped
    """
    def launch(lib, x, stream):
        lib.foo_launch(x.data_ptr(), torch.cuda.current_stream().cuda_stream)
    """,
    # bound but never raised on
    """
    def launch(lib, x):
        err = lib.foo_launch(x.data_ptr(), torch.cuda.current_stream().cuda_stream)
        return err
    """,
    # no stream: the kernel runs on the legacy default stream
    """
    def launch(lib, x):
        err = lib.foo_launch(x.data_ptr(), 0)
        if err:
            raise RuntimeError(lib.foo_error_string(err))
    """,
], ids=["unbound", "unchecked", "no_stream"])
def test_ps502_flags_broken_launch_contracts(src):
    assert "PS502" in port_rules_of(src)


def test_ps502_accepts_the_launch_idiom():
    good = """
    def launch(lib, x):
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if x.dtype == torch.bfloat16:
                err = lib.foo_hopper_launch(x.data_ptr(), stream)
            else:
                err = lib.foo_launch(x.data_ptr(),
                                     torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(lib.foo_error_string(err).decode())
    """
    assert "PS502" not in port_rules_of(good)


def test_port_kernels_and_dispatcher_keep_the_kernel_rules():
    """The real idiom: every wrapper in kernels/ launches or raises, and
    every launch checks its code on PyTorch's stream."""
    files = sorted((PORT / "kernels").glob("*.py"))
    launches = 0
    for path in files:
        src = path.read_text()
        rel = f"src/repro_torch/kernels/{path.name}"
        launches += src.count("_launch(")
        fs = port_rules.run_rules(src, rel, registry=check.load_registry())
        assert not [f.format() for f in fs if f.rule in ("PS302", "PS502")]
    assert launches >= 11


# --------------------------------------------------------- checker, CLI
def test_port_checker_is_clean_over_its_default_paths_with_an_empty_baseline():
    assert check.DEFAULT_BASELINE.name == "pscheck_torch_baseline.txt"
    assert check.load_baseline(check.DEFAULT_BASELINE) == set()
    paths = [ROOT / p for p in check.DEFAULT_PATHS]
    assert all(p.exists() for p in paths)
    findings, n_pragma, n_base = check.check_paths(paths)
    assert findings == [], "\n".join(f.format() for f in findings)
    assert n_pragma >= 2 and n_base == 0
    assert check.main([]) == 0


def test_port_checker_cli_reports_and_honours_pragmas(tmp_path):
    nobase = tmp_path / "empty_baseline.txt"
    bad = tmp_path / "bad.py"
    bad.write_text("def f(lib, x):\n    lib.foo_launch(x)\n")
    report = tmp_path / "report.txt"
    assert check.main([str(bad), "--baseline", str(nobase), "--report", str(report)]) == 1
    assert "PS502" in report.read_text()
    ok = tmp_path / "ok.py"
    ok.write_text("def f(lib, x):\n"
                  "    lib.foo_launch(x)  # pscheck: ok PS502 fixture demonstrating pragmas\n")
    assert check.main([str(ok), "--baseline", str(nobase)]) == 0


# ------------------------------------------------------------- SanLock
SCRIPTS = {
    "ordered": [("a", "b"), ("b", "c")],
    "reversed": [("a", "b"), ("b", "a")],
    "three_way": [("a", "b"), ("b", "c"), ("c", "a")],
    "reentrant": [("r", "r"), ("r", "a")],
}


def _run_script(mod, script):
    """Acquire each pair nested (outer, inner) on wrappers of ``mod``; return
    the cycle it finds, with the graph restored afterwards."""
    saved = dict(mod._edges)
    mod.reset_graph()
    try:
        made = {}

        def lock(name):
            if name not in made:
                made[name] = (mod._SanRLock(threading.RLock(), f"{name}.py:1") if name == "r"
                              else mod._SanLock(threading.Lock(), f"{name}.py:1"))
            return made[name]

        for outer, inner in script:
            with lock(outer):
                with lock(inner):
                    pass
        return mod.find_cycle(), sorted(mod.edges())
    finally:
        mod.reset_graph()
        mod._edges.update(saved)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_port_sanlock_finds_the_reference_sanlocks_cycle(name):
    got = _run_script(port_sanlock, SCRIPTS[name])
    want = _run_script(ref_sanlock, SCRIPTS[name])
    assert got == want
    assert (got[0] is not None) == (name in ("reversed", "three_way"))


def test_port_sanlock_wraps_only_port_frames():
    assert port_sanlock._from_port(type("F", (), {"f_code": type("C", (), {
        "co_filename": str(PORT / "serve" / "engine.py")})})())
    assert not port_sanlock._from_port(type("F", (), {"f_code": type("C", (), {
        "co_filename": str(PORT / "analysis" / "sanlock.py")})})())
    assert not port_sanlock._from_port(type("F", (), {"f_code": type("C", (), {
        "co_filename": str(ROOT / "src" / "repro" / "core" / "node.py")})})())


# -------------------------------------------------- hypothesis fallback
def _strategies(hf):
    st = hf.st
    return (
        st.lists(st.integers(-5, 5), min_size=1, max_size=6, unique=True),
        st.tuples(st.booleans(), st.floats(0.0, 1.0)),
        st.sampled_from("abc").map(str.upper).filter(lambda c: c != "B"),
    )


def _draws(hf):
    """The examples ``hf.given`` feeds a test with this module's qualified
    name of the property test below."""
    seen = []

    def record(xs, pair, c):
        seen.append((xs, pair, c))

    record.__module__ = __name__
    record.__qualname__ = "test_hypothesis_fallback_copy_draws_the_reference_examples"
    hf.settings(max_examples=9)(hf.given(*_strategies(hf))(record))()
    return seen


@port_hf.settings(max_examples=9)
@port_hf.given(*_strategies(port_hf))
def test_hypothesis_fallback_copy_draws_the_reference_examples(xs, pair, c):
    assert len(set(xs)) == len(xs) and c in "AC" and 0.0 <= pair[1] <= 1.0
    want = _draws(ref_hf)
    assert len(want) == 9 and _draws(port_hf) == want
    assert (xs, pair, c) in want
