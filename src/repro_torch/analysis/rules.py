"""The port's pscheck rules (stdlib ``ast`` only).

Each rule emits :class:`Finding` records in ``file:line rule-id message``
format; the rules are listed in ``repro_torch.analysis.__doc__``.
Suppression is via ``# pscheck: ok PSxxx <reason>`` on the finding line
(or its enclosing ``def`` line) or the port's checked-in baseline
(``pscheck_torch_baseline.txt``).

PS101, PS201, PS202, PS301 and PS401 are the reference's rules
(``repro.analysis.rules``) read against the port's lock table and counter
registry; PS201/PS202 also resolve a module-level lock (``with _lock:``).
PS302, PS501 and PS502 restate the reference's kernel rules for PyTorch
and CUDA: the Pallas calls they looked for do not exist in the port.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass

from repro_torch.analysis import locks as L

CRITICAL_EXCS = frozenset({"NodeDownError", "SSDCorruptionError"})
BROAD_EXCS = frozenset({"Exception", "BaseException"})
# calls that make a broad handler "loud": counted, logged, or warned
LOUD_CALL_ATTRS = frozenset({
    "inc", "warn", "warning", "error", "exception", "log", "debug", "info",
})
PIN_RELEASE_ATTRS = frozenset({
    "unpin", "_forget", "abort_batch", "abort", "drain", "release_pins",
})
# PS302: a kernel wrapper (``scatter_add_cuda_``, ``topk_mips_cuda``) and
# the plain versions a silent fallback would return
CUDA_WRAPPER_RE = re.compile(r"_cuda_?$")
FALLBACK_RE = re.compile(r"_(?:plain|ref)_?$")
# names whose presence in an If test marks explicit dispatch: by device, or
# by a kernel's variant chooser (which picks a kernel, never a plain path)
DISPATCH_TEST_NAMES = frozenset({
    "is_cuda", "is_meta", "_on_meta", "device", "flash_variant", "gmm_variant", "topk_plan",
})
# ...unless the same test also reads a tensor's shape or layout: then it is
# a shape condition that happens to mention the device
SHAPE_TEST_NAMES = frozenset({
    "shape", "dtype", "numel", "dim", "ndim", "size", "stride", "is_contiguous", "data_ptr",
})
# PS501: gathers that bypass kernels.ops under models/
TABLE_NAME_PARTS = ("emb", "table", "weight")


@dataclass
class Finding:
    path: str  # repo-relative, forward slashes
    line: int
    rule: str
    msg: str
    qualname: str = ""  # enclosing function ('' at module level)
    scope_line: int = 0  # the enclosing def's line (0 at module level)

    def format(self) -> str:
        return f"{self.path}:{self.line} {self.rule} {self.msg}"

    def baseline_key(self) -> str:
        # line-number-free so the baseline survives unrelated edits
        return f"{self.rule} {self.path}::{self.qualname or '<module>'}"


# --------------------------------------------------------------- helpers
def iter_functions(tree: ast.Module):
    """Yield (qualname, classname, fn_node) for every def in the module."""

    def rec(node, prefix: str, classname: str | None):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, classname, child
                yield from rec(child, f"{qual}.", classname)
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{child.name}.", child.name)

    yield from rec(tree, "", None)


def module_key(path: str) -> str:
    """``kernels/build.py`` for ``src/repro_torch/kernels/build.py``: the key
    of a module-level lock in the table."""
    return path.split("repro_torch/", 1)[-1]


def _receiver_chain(expr) -> list[str]:
    """['self', 'cluster'] for the receiver of ``self.cluster.pull(...)``."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return list(reversed(parts))


def _test_names(test) -> set[str]:
    out: set[str] = set()
    for nd in ast.walk(test):
        if isinstance(nd, ast.Name):
            out.add(nd.id)
        elif isinstance(nd, ast.Attribute):
            out.add(nd.attr)
    return out


def _call_name(call: ast.Call) -> str:
    f = call.func
    return f.id if isinstance(f, ast.Name) else f.attr if isinstance(f, ast.Attribute) else ""


# ------------------------------------------------------------ PS101: pins
def _is_pin_acquire(call: ast.Call) -> str | None:
    if not isinstance(call.func, ast.Attribute):
        return None
    chain = _receiver_chain(call.func.value)
    if call.func.attr == "pin":
        # redo-log cursors (``redo.pin()``) are index pins, not row pins
        if any(p.endswith("redo") for p in chain):
            return None
        return "pin"
    if call.func.attr == "pull":
        for kw in call.keywords:
            if (
                kw.arg == "pin"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
            ):
                return "pull(pin=True)"
    return None


def _has_release_handler(fn) -> bool:
    for nd in ast.walk(fn):
        if not isinstance(nd, ast.Try):
            continue
        cleanup = list(nd.finalbody)
        for h in nd.handlers:
            cleanup.extend(h.body)
        for st in cleanup:
            for sub in ast.walk(st):
                if (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr in PIN_RELEASE_ATTRS
                ):
                    return True
    return False


def rule_ps101(path, functions, findings):
    for qual, _cls, fn in functions:
        acquires = [
            (nd.lineno, kind)
            for nd in ast.walk(fn)
            if isinstance(nd, ast.Call) and (kind := _is_pin_acquire(nd))
        ]
        if not acquires or _has_release_handler(fn):
            continue
        line, kind = acquires[0]
        findings.append(Finding(
            path, line, "PS101",
            f"{qual} takes MEM-PS row pins ({kind}) but no except/finally "
            "path releases them (unpin/_forget/abort) — pins leak if an "
            "exception unwinds; pragma only if ownership transfers to the "
            "caller by contract",
            qual, fn.lineno,
        ))


# --------------------------------------------------- PS201/PS202: locking
class _UndeclaredLock:
    def __init__(self, cls, attr):
        self.cls, self.attr = cls, attr


def _lock_spec_of(expr, classname, module):
    """LockSpec for ``with self._lock:`` items and, in a module that owns a
    module-level lock, ``with _lock:``; _UndeclaredLock for lock-ish names
    missing from the table; None for non-lock context managers."""
    if isinstance(expr, ast.Name) and L.LOCK_ATTR_RE.match(expr.id):
        return L.LOCKS.get((module, expr.id)) or _UndeclaredLock(module, expr.id)
    if not isinstance(expr, ast.Attribute) or not L.LOCK_ATTR_RE.match(expr.attr):
        return None
    chain = _receiver_chain(expr.value)
    if chain == ["self"]:  # only `with self._lock:` resolves via the class
        spec = L.LOCKS.get((classname or "", expr.attr))
        if spec is not None:
            return spec
    cands = L.BY_ATTR.get(expr.attr, [])
    if len(cands) == 1:
        return cands[0]
    return _UndeclaredLock(classname or "<module>", expr.attr)


def _is_blocking_primitive(call: ast.Call) -> str | None:
    f = call.func
    if isinstance(f, ast.Attribute):
        if isinstance(f.value, ast.Constant):
            return None  # "sep".join(...)
        if f.attr in L.BLOCKING_ATTRS:
            return f"{'.'.join(_receiver_chain(f.value)[-1:]) or '?'}.{f.attr}"
        if f.attr in L.FS_BLOCKING_ATTRS:
            chain = _receiver_chain(f.value)
            if set(chain) & L.FS_RECEIVERS:
                return f"{'.'.join(chain)}.{f.attr}"
    elif isinstance(f, ast.Name) and f.id in L.BLOCKING_NAMES:
        return f.id
    return None


def module_blocking_summary(tree) -> dict[str, bool]:
    """name -> transitively-blocking?, fixpoint over same-module calls
    (``self.x()`` / bare ``x()``). Catches e.g. engine._rows_for ->
    _pull_source -> source.pull."""
    fns = {fn.name: fn for _q, _c, fn in iter_functions(tree)}
    blocked = {
        n: any(
            isinstance(nd, ast.Call) and _is_blocking_primitive(nd)
            for nd in ast.walk(f)
        )
        for n, f in fns.items()
    }
    changed = True
    while changed:
        changed = False
        for n, f in fns.items():
            if blocked[n]:
                continue
            for nd in ast.walk(f):
                if not isinstance(nd, ast.Call):
                    continue
                callee = None
                if isinstance(nd.func, ast.Name):
                    callee = nd.func.id
                elif (
                    isinstance(nd.func, ast.Attribute)
                    and isinstance(nd.func.value, ast.Name)
                    and nd.func.value.id == "self"
                ):
                    callee = nd.func.attr
                if callee is not None and blocked.get(callee):
                    blocked[n] = True
                    changed = True
                    break
    return blocked


def _describe_blocking(call, blocked: dict[str, bool]) -> str | None:
    prim = _is_blocking_primitive(call)
    if prim:
        return prim
    f = call.func
    if isinstance(f, ast.Name) and blocked.get(f.id):
        return f"{f.id}() [transitively blocking]"
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id == "self"
        and blocked.get(f.attr)
    ):
        return f"self.{f.attr}() [transitively blocking]"
    return None


def rule_locks(path, functions, blocked, findings):
    module = module_key(path)
    for qual, cls, fn in functions:
        _walk_locks(fn, path, module, qual, cls, fn.lineno, [], blocked, findings)


def _walk_locks(node, path, module, qual, cls, scope_line, stack, blocked, findings):
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue  # separate scope; body does not run at this point
        if isinstance(child, (ast.With, ast.AsyncWith)):
            entered = []
            for item in child.items:
                spec = _lock_spec_of(item.context_expr, cls, module)
                if isinstance(spec, _UndeclaredLock):
                    findings.append(Finding(
                        path, child.lineno, "PS201",
                        f"{qual} acquires undeclared lock "
                        f"{spec.cls}.{spec.attr}: add it to "
                        "repro_torch.analysis.locks.LOCK_ORDER with a level "
                        "and blocking_ok policy",
                        qual, scope_line,
                    ))
                elif spec is not None:
                    for held in stack:
                        if held is spec:
                            if not spec.reentrant:
                                findings.append(Finding(
                                    path, child.lineno, "PS201",
                                    f"{qual} re-acquires non-reentrant "
                                    f"{spec.cls}.{spec.attr} while holding it",
                                    qual, scope_line,
                                ))
                            continue
                        if held.level >= spec.level:
                            findings.append(Finding(
                                path, child.lineno, "PS201",
                                f"{qual} acquires {spec.cls}.{spec.attr} "
                                f"(level {spec.level}) while holding "
                                f"{held.cls}.{held.attr} (level {held.level})"
                                " — violates the declared lock order",
                                qual, scope_line,
                            ))
                    entered.append(spec)
            stack.extend(entered)
            _walk_locks(child, path, module, qual, cls, scope_line, stack, blocked, findings)
            for _ in entered:
                stack.pop()
            continue
        if isinstance(child, ast.Call):
            strict = [s for s in stack if not s.blocking_ok and s not in
                      getattr(child, "_pscheck_seen", ())]
            if strict:
                desc = _describe_blocking(child, blocked)
                if desc:
                    held = strict[-1]
                    findings.append(Finding(
                        path, child.lineno, "PS202",
                        f"{qual} calls blocking {desc} while holding "
                        f"{held.cls}.{held.attr} (blocking_ok=False) — move "
                        "the call outside the critical section",
                        qual, scope_line,
                    ))
                    # don't re-report the same call for outer With recursion
                    child._pscheck_seen = tuple(stack)
        _walk_locks(child, path, module, qual, cls, scope_line, stack, blocked, findings)


# -------------------------------------------------- PS301: silent excepts
def _exc_names(type_node) -> set[str]:
    if type_node is None:
        return set()
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) else [type_node]
    out = set()
    for nd in nodes:
        if isinstance(nd, ast.Name):
            out.add(nd.id)
        elif isinstance(nd, ast.Attribute):
            out.add(nd.attr)
    return out


def _handler_is_loud(h: ast.ExceptHandler) -> bool:
    for st in h.body:
        for nd in ast.walk(st):
            if isinstance(nd, ast.Raise):
                return True
            if h.name and isinstance(nd, ast.Name) and nd.id == h.name:
                return True  # bound exception is inspected/stored/re-raised
            if (
                isinstance(nd, ast.Call)
                and isinstance(nd.func, ast.Attribute)
                and nd.func.attr in LOUD_CALL_ATTRS
            ):
                return True
    return False


def rule_ps301(path, functions, tree, findings):
    seen: set[int] = set()
    scopes = [(q, fn, fn.lineno) for q, _c, fn in functions]
    scopes.append(("<module>", tree, 0))
    for qual, scope, scope_line in scopes:
        for nd in ast.walk(scope) if scope is not tree else list(ast.iter_child_nodes(tree)):
            for sub in ast.walk(nd):
                if not isinstance(sub, ast.Try) or id(sub) in seen:
                    continue
                seen.add(id(sub))
                for h in sub.handlers:
                    names = _exc_names(h.type)
                    broad = h.type is None or (names & BROAD_EXCS)
                    if broad:
                        if not _handler_is_loud(h):
                            what = "bare except" if h.type is None else \
                                f"except {'/'.join(sorted(names))}"
                            findings.append(Finding(
                                path, h.lineno, "PS301",
                                f"{qual}: {what} swallows errors (can hide "
                                "NodeDownError/SSDCorruptionError) — "
                                "re-raise, use the bound exception, or "
                                "increment a quarantine counter",
                                qual, scope_line,
                            ))
                    elif names & CRITICAL_EXCS and all(
                        isinstance(st, (ast.Pass, ast.Continue)) for st in h.body
                    ):
                        findings.append(Finding(
                            path, h.lineno, "PS301",
                            f"{qual}: except {'/'.join(sorted(names & CRITICAL_EXCS))}"
                            " is silently dropped — recover, count, or re-raise",
                            qual, scope_line,
                        ))


# ------------------------------------------- PS302: silent kernel fallback
def _walk_skip_ifs(st):
    yield st
    for child in ast.iter_child_nodes(st):
        if isinstance(child, (ast.If, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield from _walk_skip_ifs(child)


def _reaches_kernel(nd) -> bool:
    """A call of a kernel wrapper (``*_cuda``) or of ``build.library``."""
    if not isinstance(nd, ast.Call):
        return False
    if CUDA_WRAPPER_RE.search(_call_name(nd)):
        return True
    f = nd.func
    return isinstance(f, ast.Attribute) and f.attr == "library" \
        and _receiver_chain(f.value)[-1:] == ["build"]


def _fallback_returns(stmts):
    """Returns of a plain or reference call in ``stmts``, nested Ifs
    excluded (the rule visits each If on its own)."""
    for st in stmts:
        for nd in _walk_skip_ifs(st):
            if isinstance(nd, ast.Return) and nd.value is not None and any(
                isinstance(s, ast.Call) and FALLBACK_RE.search(_call_name(s))
                for s in ast.walk(nd.value)
            ):
                yield nd


def _is_dispatch(test) -> bool:
    names = _test_names(test)
    return bool(names & DISPATCH_TEST_NAMES) and not names & SHAPE_TEST_NAMES


def _branches(fn):
    """(If, branch statements) for every If in ``fn``. An If without an
    else whose body ends in return or raise has the statements after it in
    its block as its else branch."""
    for nd in ast.walk(fn):
        for field in ("body", "orelse", "finalbody"):
            block = getattr(nd, field, None)
            if not isinstance(block, list):
                continue
            for i, st in enumerate(block):
                if not isinstance(st, ast.If):
                    continue
                yield st, st.body
                if st.orelse:
                    yield st, st.orelse
                elif st.body and isinstance(st.body[-1], (ast.Return, ast.Raise)):
                    yield st, block[i + 1:]


def rule_ps302(path, functions, findings):
    for qual, _cls, fn in functions:
        if not any(_reaches_kernel(nd) for nd in ast.walk(fn)):
            continue
        flagged: set[int] = set()

        def flag(ret, how):
            if id(ret) in flagged:
                return
            flagged.add(id(ret))
            findings.append(Finding(
                path, ret.lineno, "PS302",
                f"{qual}: returns the plain version {how} of a function "
                "that launches a kernel — a CUDA tensor must reach its "
                "kernel or raise; dispatch on the device (is_cuda/is_meta) "
                "or a variant chooser, and pad or repack to the kernel's "
                "layout",
                qual, fn.lineno,
            ))

        for ifnode, branch in _branches(fn):
            if _is_dispatch(ifnode.test):
                continue
            for ret in _fallback_returns(branch):
                flag(ret, f"from a branch on `{ast.unparse(ifnode.test)}`")
        for tr in ast.walk(fn):
            if not isinstance(tr, ast.Try) or not any(
                _reaches_kernel(nd) for st in tr.body for nd in ast.walk(st)
            ):
                continue
            for h in tr.handlers:
                for ret in _fallback_returns(h.body):
                    flag(ret, "from an except around the launch")


# ------------------------------------------------- PS401: counter hygiene
def _counterish_receiver(expr) -> bool:
    chain = _receiver_chain(expr)
    return bool(chain) and "counter" in chain[-1].lower()


def rule_ps401(path, tree, registry, findings, functions):
    qual_of = _line_to_scope(functions)
    for nd in ast.walk(tree):
        if not isinstance(nd, ast.Call):
            continue
        f = nd.func
        if isinstance(f, ast.Attribute) and f.attr == "inc" and _counterish_receiver(f.value):
            if not nd.args:
                continue
            a0 = nd.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                if a0.value not in registry:
                    q, sl = qual_of(nd.lineno)
                    findings.append(Finding(
                        path, nd.lineno, "PS401",
                        f"counter {a0.value!r} is not in "
                        "repro_torch.metrics.KNOWN_COUNTERS — typos silently "
                        "mint new counters; declare it or fix the name",
                        q, sl,
                    ))
            else:
                q, sl = qual_of(nd.lineno)
                findings.append(Finding(
                    path, nd.lineno, "PS401",
                    "non-literal counter name passed to Counters.inc — "
                    "names must be statically checkable against "
                    "KNOWN_COUNTERS (pragma if derived from a declared set)",
                    q, sl,
                ))
        name = _call_name(nd)
        if name == "Counters":
            for a in nd.args:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value not in registry:
                    q, sl = qual_of(nd.lineno)
                    findings.append(Finding(
                        path, nd.lineno, "PS401",
                        f"Counters(...) declares {a.value!r} which is not in "
                        "repro_torch.metrics.KNOWN_COUNTERS",
                        q, sl,
                    ))
    # module-level COUNTER_NAMES-style literal tuples
    for nd in ast.iter_child_nodes(tree):
        if isinstance(nd, ast.Assign) and any(
            isinstance(t, ast.Name) and "COUNTER" in t.id for t in nd.targets
        ) and isinstance(nd.value, (ast.Tuple, ast.List, ast.Set)):
            for a in nd.value.elts:
                if isinstance(a, ast.Constant) and isinstance(a.value, str) \
                        and a.value not in registry:
                    findings.append(Finding(
                        path, nd.lineno, "PS401",
                        f"declared counter {a.value!r} is not in "
                        "repro_torch.metrics.KNOWN_COUNTERS",
                        "<module>", 0,
                    ))


def _line_to_scope(functions):
    spans = sorted(
        (fn.lineno, max((n.lineno for n in ast.walk(fn) if hasattr(n, "lineno")),
                        default=fn.lineno), q, fn.lineno)
        for q, _c, fn in functions
    )

    def lookup(line):
        best = ("<module>", 0)
        for lo, hi, q, sl in spans:
            if lo <= line <= hi:
                best = (q, sl)  # innermost def sorts later
        return best

    return lookup


# ------------------------------------------- PS501: models/ gather hygiene
def _is_param_table(expr) -> bool:
    """``p["tok_emb"]``, ``params["layers"]["wq"]`` or a name that says it
    holds a table (``tok_emb``, ``working_table``, ``self.weight``)."""
    if isinstance(expr, ast.Subscript):
        return isinstance(expr.slice, ast.Constant) and isinstance(expr.slice.value, str)
    chain = _receiver_chain(expr)
    return bool(chain) and any(part in chain[-1].lower() for part in TABLE_NAME_PARTS)


def rule_ps501(path, tree, findings, functions):
    if "/models/" not in f"/{path}":
        return
    qual_of = _line_to_scope(functions)
    for nd in ast.walk(tree):
        if not isinstance(nd, ast.Call) or not isinstance(nd.func, ast.Attribute):
            continue
        f = nd.func
        chain = _receiver_chain(f.value)
        bad = None
        if f.attr in ("one_hot", "embedding") and chain[-1:] in (["F"], ["functional"]):
            bad = f"F.{f.attr}"
        elif f.attr == "take" and chain == ["torch"]:
            bad = "torch.take"
        elif f.attr == "index_select":
            table = nd.args[0] if chain == ["torch"] and nd.args else f.value
            if _is_param_table(table):
                bad = "index_select on a parameter table"
        if bad:
            q, sl = qual_of(nd.lineno)
            findings.append(Finding(
                path, nd.lineno, "PS501",
                f"{bad} in a production forward: embedding-style gathers "
                "must go through kernels.ops (embedding_bag / "
                "embedding_lookup) — pragma only for genuinely non-embedding"
                " uses (e.g. router dispatch masks)",
                q, sl,
            ))


# ------------------------------------------------ PS502: launch contract
def _mentions_stream(expr, stream_names: set[str]) -> bool:
    for nd in ast.walk(expr):
        if isinstance(nd, ast.Name) and (nd.id in stream_names or nd.id == "current_stream"):
            return True
        if isinstance(nd, ast.Attribute) and nd.attr in ("current_stream", "cuda_stream"):
            return True
    return False


def rule_ps502(path, functions, findings):
    """Every ctypes ``lib.<kernel>_launch(...)``: its return code bound to a
    name that an ``if`` raises on, and PyTorch's current stream passed."""
    for qual, _cls, fn in functions:
        launches = [nd for nd in ast.walk(fn) if isinstance(nd, ast.Call)
                    and isinstance(nd.func, ast.Attribute) and nd.func.attr.endswith("_launch")]
        if not launches:
            continue
        bound: dict[int, str] = {}
        stream_names: set[str] = set()
        for nd in ast.walk(fn):
            if isinstance(nd, ast.Assign) and len(nd.targets) == 1 \
                    and isinstance(nd.targets[0], ast.Name):
                if isinstance(nd.value, ast.Call):
                    bound[id(nd.value)] = nd.targets[0].id
                if _mentions_stream(nd.value, set()):
                    stream_names.add(nd.targets[0].id)
        raised = {
            name for nd in ast.walk(fn) if isinstance(nd, ast.If)
            and any(isinstance(s, ast.Raise) for st in nd.body for s in ast.walk(st))
            for name in _test_names(nd.test)
        }
        for call in launches:
            missing = []
            name = bound.get(id(call))
            if name is None:
                missing.append("its return code is not bound to a name")
            elif name not in raised:
                missing.append(f"no `if {name}: raise` checks its return code")
            args = list(call.args) + [kw.value for kw in call.keywords]
            if not any(_mentions_stream(a, stream_names) for a in args):
                missing.append("it is not passed torch.cuda.current_stream(...).cuda_stream")
            if missing:
                findings.append(Finding(
                    path, call.lineno, "PS502",
                    f"{qual}: kernel launch {call.func.attr}(...) breaks the "
                    f"launch contract: {'; '.join(missing)} — a failed launch "
                    "must raise, and the kernel must run on PyTorch's stream",
                    qual, fn.lineno,
                ))


# ----------------------------------------------------------------- driver
def run_rules(src: str, path: str, registry: frozenset[str] | None = None):
    """All rules over one file; ``path`` should be repo-relative."""
    path = path.replace(os.sep, "/")
    tree = ast.parse(src, filename=path)
    functions = list(iter_functions(tree))
    blocked = module_blocking_summary(tree)
    findings: list[Finding] = []
    rule_ps101(path, functions, findings)
    rule_locks(path, functions, blocked, findings)
    rule_ps301(path, functions, tree, findings)
    rule_ps302(path, functions, findings)
    if registry is not None:
        rule_ps401(path, tree, registry, findings, functions)
    rule_ps501(path, tree, findings, functions)
    rule_ps502(path, functions, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
