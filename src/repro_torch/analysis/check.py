"""The port's pscheck CLI: ``python -m repro_torch.analysis.check [paths]``.

Walks the given paths (default: ``src/repro_torch``, ``chip_smoke.py`` and
``examples/torch_port``), runs every rule of ``repro_torch.analysis.rules``
on each ``.py`` file, and prints unsuppressed findings as ``file:line
rule-id message``. Exit status 1 iff any remain.

Suppression, in order of preference:

1. fix the code;
2. ``# pscheck: ok PSxxx <reason>`` on the finding's line or its
   enclosing ``def`` line (for invariants that hold by a contract the
   rule cannot see — say which contract);
3. a line ``PSxxx path::qualname`` in ``pscheck_torch_baseline.txt`` for
   grandfathered cases (line-number-free so it survives edits).

``--report FILE`` writes the full report (including suppressed counts).
"""

from __future__ import annotations

import argparse
import ast
import re
import sys
from pathlib import Path

from repro_torch.analysis.rules import Finding, run_rules

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = REPO_ROOT / "pscheck_torch_baseline.txt"
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "examples/torch_port")

_PRAGMA_RE = re.compile(r"#\s*pscheck:\s*ok\s+((?:PS\d+|all)(?:\s*,\s*(?:PS\d+|all))*)")


def load_registry(metrics_path: Path | None = None) -> frozenset[str]:
    """Parse KNOWN_COUNTERS out of repro_torch/metrics.py with ast (the
    checker never imports the checked tree)."""
    p = metrics_path or (REPO_ROOT / "src" / "repro_torch" / "metrics.py")
    try:
        tree = ast.parse(p.read_text(), filename=str(p))
    except (OSError, SyntaxError):
        return frozenset()
    for nd in ast.walk(tree):
        if isinstance(nd, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "KNOWN_COUNTERS" for t in nd.targets
        ):
            names = [
                c.value
                for c in ast.walk(nd.value)
                if isinstance(c, ast.Constant) and isinstance(c.value, str)
            ]
            return frozenset(names)
    return frozenset()


def _pragmas(src: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            out[i] = {t.strip() for t in m.group(1).split(",")}
    return out


def _suppressed_by_pragma(f: Finding, pragmas: dict[int, set[str]]) -> bool:
    for line in (f.line, f.scope_line):
        rules = pragmas.get(line)
        if rules and (f.rule in rules or "all" in rules):
            return True
    return False


def _iter_py_files(paths: list[Path]):
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    out = set()
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.add(line)
    return out


def check_paths(
    paths: list[Path],
    baseline: set[str] | None = None,
    registry: frozenset[str] | None = None,
) -> tuple[list[Finding], int, int]:
    """Returns (unsuppressed findings, n_pragma_suppressed, n_baselined)."""
    if registry is None:
        registry = load_registry()
    baseline = baseline or set()
    remaining: list[Finding] = []
    n_pragma = n_base = 0
    for f in _iter_py_files(paths):
        src = f.read_text()
        try:
            rel = f.resolve().relative_to(REPO_ROOT)
        except ValueError:
            rel = f
        findings = run_rules(src, str(rel), registry=registry)
        if not findings:
            continue
        pragmas = _pragmas(src)
        for fd in findings:
            if _suppressed_by_pragma(fd, pragmas):
                n_pragma += 1
            elif fd.baseline_key() in baseline:
                n_base += 1
            else:
                remaining.append(fd)
    return remaining, n_pragma, n_base


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.check", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                    help="files/directories to check (default: the port, chip_smoke.py "
                         "and its examples)")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE),
                    help="baseline file (default: <repo>/pscheck_torch_baseline.txt)")
    ap.add_argument("--report", default=None,
                    help="also write the findings report to this file")
    args = ap.parse_args(argv)

    paths = []
    for p in args.paths:
        pp = Path(p)
        if not pp.exists() and (REPO_ROOT / p).exists():
            pp = REPO_ROOT / p  # allow running from any cwd
        if not pp.exists():
            ap.error(f"no such file or directory: {p}")
        paths.append(pp)

    findings, n_pragma, n_base = check_paths(paths, baseline=load_baseline(Path(args.baseline)))

    lines = [f.format() for f in findings]
    summary = (
        f"pscheck: {len(findings)} finding(s)"
        f" ({n_pragma} pragma-suppressed, {n_base} baselined)"
    )
    report = "\n".join(lines + [summary]) + "\n"
    sys.stdout.write(report)
    if args.report:
        Path(args.report).write_text(report)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
