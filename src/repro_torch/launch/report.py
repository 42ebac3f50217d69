"""Render the dry run's table from its results file.

The reference's ``launch/report.py`` columns, with the port's H100 terms
(``launch/roofline.py``) and memory per rank (arguments + the peak beyond
them).

Usage: PYTHONPATH=src python -m repro_torch.launch.report [results.json]
"""

from __future__ import annotations

import json
import sys

from repro_torch.launch.dryrun import DEFAULT_OUT


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def row(r: dict) -> str:
    tc, tm, tl = r["t_compute"], r["t_memory"], r["t_collective"]
    gib = r["memory_per_rank"]["argument_bytes"] / 2**30
    tmp = r["memory_per_rank"]["temp_bytes"] / 2**30
    return (
        f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fmt_s(tc)} | {fmt_s(tm)} | "
        f"{fmt_s(tl)} | **{r['bottleneck']}** | {r['useful_flops_ratio']:.2f} | "
        f"{r['roofline_fraction']:.1%} | {gib:.2f}+{tmp:.2f} |"
    )


def render(results: dict) -> str:
    lines = [
        "| arch | shape | mesh | t_compute | t_memory | t_collective | bottleneck "
        "| 6ND/counted | roofline | GiB args+temp |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    done = sorted((v for v in results.values() if "t_compute" in v),
                  key=lambda v: (v["arch"], v["shape"], v["mesh"]))
    lines += [row(v) for v in done]
    skipped = [k for k, v in results.items() if "skipped" in v]
    if skipped:
        lines.append(f"\nskipped cells ({len(skipped)}): long_500k on pure full-attention archs "
                     "(sub-quadratic only; see DESIGN.md §Arch-applicability)")
    refused = sorted(k for k, v in results.items() if "refused" in v)
    if refused:
        lines.append(f"\nrefused cells ({len(refused)}): " + ", ".join(refused)
                     + " (the port does not place them at the mesh's model axis; ROADMAP §1 "
                     "item 3)")
    errors = sorted(k for k, v in results.items() if "error" in v)
    if errors:
        lines.append(f"\nerror cells ({len(errors)}): " + ", ".join(errors))
    return "\n".join(lines)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT
    with open(path) as f:
        print(render(json.load(f)))


if __name__ == "__main__":
    main()
