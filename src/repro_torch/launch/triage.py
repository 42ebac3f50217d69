"""Perf triage for one dry-run cell: the roofline terms, memory per rank,
and where the bytes, the FLOPs and the collectives come from.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.triage --arch olmoe-1b-7b --shape train_4k
"""

from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import DryMesh


def report(cfg, shape, mesh: DryMesh) -> list[str]:
    counter, mem = DR.trace_cell(cfg, shape, mesh)
    mf = rl.model_flops(cfg, shape, cfg.param_count(active_only=True))
    roof = rl.analyze(cfg.name, shape.name, mesh.name, counter, mf, mesh.data * mesh.model, mem)
    t_useful = mf / roof.n_ranks / rl.PEAK_FLOPS_BF16
    lines = [
        f"traced in {roof.trace_seconds:.1f}s ({counter.n_ops} ops)",
        f"t_compute={roof.t_compute:.4f}s t_memory={roof.t_memory:.4f}s "
        f"t_collective={roof.t_collective:.4f}s -> {roof.bottleneck}",
        f"useful(6ND) t={t_useful:.4f}s -> roofline fraction {roof.roofline_fraction:.2%}",
        f"memory a rank: args {mem['argument_bytes'] / 2**30:.2f} GiB, outputs "
        f"{mem['output_bytes'] / 2**30:.2f} GiB, peak {mem['peak_bytes'] / 2**30:.2f} GiB "
        f"(temp {mem['temp_bytes'] / 2**30:.2f} GiB)",
        "", "-- kernels (calls, FLOPs, bytes) --",
    ]
    for name, k in sorted(counter.kernels.items()):
        lines.append(f"  {name:18s} x{k['calls']:<5d} {k['flops'] / 1e12:8.3f} TF "
                     f"{k['bytes'] / 1e9:8.3f} GB")
    lines += ["", "-- top HBM byte sites --"]
    lines += [f"  {b / 1e9:10.3f} GB  {site[:100]}" for site, b in counter.top_bytes(14)]
    lines += ["", "-- top FLOP sites --"]
    lines += [f"  {f / 1e12:10.3f} TF  {site[:100]}" for site, f in counter.top_flops(8)]
    lines += ["", "-- collectives (kind, axis, calls, operand bytes, site) --"]
    for (kind, axis, site), (n, b) in sorted(counter.collectives_by_site().items(),
                                             key=lambda kv: -kv[1][1]):
        lines.append(f"  {kind:10s} {axis:5s} x{n:<5d} {b / 1e9:10.3f} GB  {site}")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", type=DR.parse_mesh, default=None,
                    help="DATAxMODEL, default 32x8 (--multi-pod: 64x8)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)
    cfg, shape = get_config(args.arch), SHAPES[args.shape]
    mesh = DryMesh(*(args.mesh or DR.MESHES[args.multi_pod]), args.rank)
    print("\n".join(report(cfg, shape, mesh)))


if __name__ == "__main__":
    main()
