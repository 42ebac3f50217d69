"""Run one cell of the port's benchmark once and print its result.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The cell is
found by name in ``BENCHMARK.json``; its configuration, traffic mix,
limits and metric readers in files of their own under ``portbench/``
(``harness/cell.py``). The run makes its inputs from the seed, sets up,
measures for ``--seconds``, checks what the timed path produced against
the plain reference (``reference/``), and prints one JSON object as the
last line of its standard output: with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics, read under the
profiler. It exits with another code than 0, and prints no result, where
the card is missing, the cell asks for more cards than there are, the
program is missing, or a JAX module was loaded.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()


def _since_start() -> float:
    """Seconds since this process started (its start time from /proc), or
    since this module's first line where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start - (time.perf_counter() - _T0)
    except (OSError, ValueError, IndexError):
        return 0.0


_BEFORE = _since_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def clock() -> float:
    return _BEFORE + time.perf_counter() - _T0


def fail(msg: str, code: int = 1):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package, by whole top-level name."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def written_bytes() -> int | None:
    """What this process has caused to be written to storage (/proc)."""
    try:
        with open("/proc/self/io") as f:
            return next(int(v) for k, v in (ln.split(":") for ln in f) if k == "write_bytes")
    except (OSError, StopIteration, ValueError):
        return None


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail(f"no program under {ROOT}/src/repro_torch")
    # every build and kernel cache inside the checkout, at fixed paths
    cache = os.path.join(ROOT, "build", "portbench")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "cuda"))
    sys.path[:0] = [HERE, os.path.join(ROOT, "src")]

    import torch

    from harness import cell as cells

    c = cells.load(args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA card")
    if torch.cuda.device_count() < c.chips:
        fail(f"{c.chips} cards wanted, {torch.cuda.device_count()} found")
    torch.cuda.set_device(0)
    import importlib

    runner = importlib.import_module(f"harness.{c.mode}")
    out = runner.run(c, args.seed, args.seconds, bool(args.trace), "cuda", clock=clock)
    bad = loaded_forbidden()
    if bad:
        fail(f"JAX or the JAX package was loaded: {bad}", 3)

    metrics = {}
    for entry in (c.per_layer if args.trace else c.end_to_end):
        value = cells.reader(entry["name"])(out)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": c.chips,
              "memory_peak_bytes": int(out["peak_bytes"])}
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device}
    if args.trace:
        prof = out["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        result["breakdown"] = {"device_ops": [[n[:120], s] for n, s in prof["device_ops"]],
                               "idle_gaps": prof["idle_gaps"]}
    card = card_line()
    result["card"] = card
    result["checked"] = out["where"]
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(f"card: {card}", file=sys.stderr)
    print(f"bytes written by this process: {written_bytes()}", file=sys.stderr)
    for name, v, lim in out["checks"]:
        print(f"check {name}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
