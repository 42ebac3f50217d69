"""Time flash attention's backward kernels on the card, and compare two source trees.

At each named shape, ``chip_smoke.flash_bwd_held`` runs every backward
variant that takes it (``hopper``, ``mma``, ``simt``) twice on the forward's
own o and lse, holds it against ``flash_attention_bwd_plain`` (the two calls
equal bit for bit, within ``FLASH_BWD_TOL``) and times it per kernel beside
the plain version, SDPA's backward and the bound; the script prints that and
a digest of the hopper variant's dq, dk, dv. ``edge`` runs
``chip_smoke.FLASH_BWD_EDGE``'s mask cases, held and not timed. ``--src DIR``
imports ``repro_torch`` from ``DIR`` (a copy of another tree's ``src``, which
builds its kernels into its own ``build/``), so that one call can set two
trees' times and digests side by side. Needs a card; runs from the
repository's root:

    python tools/flash_bwd_timing.py [--src DIR] [edge] [NAME ...]

Each NAME is one of ``chip_smoke.FLASH_BWD_SHAPES`` or of ``SHAPES`` below.
With no argument, everything.
"""

import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
if sys.argv[1:2] == ["--src"]:
    SRC = sys.argv[2]
    del sys.argv[1:3]
sys.path[:0] = [SRC, str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

# name, B, H, Hkv, Sq, Skv, Dh, causal, window: head dims 192 and 256 at dK/dV
# grids of 128 key tiles (B * Hkv * Skv / 64), under the card's 132 SMs, and
# of 288 and 512, past twice that; nemotron_dp8 is a data rank's 8 sequences
# of Nemotron-4-340B's train_4k cell at model = 8
SHAPES = [
    ("dh256_4k", 2, 12, 1, 4096, 4096, 256, True, 0),
    ("dh192_mha_1100", 2, 8, 8, 1100, 1100, 192, True, 0),
    ("nemotron_dp8", 8, 12, 1, 4096, 4096, 192, True, 0),
    ("nemotron_dp8_full", 8, 12, 1, 4096, 4096, 192, False, 0),
    ("dh256_dp8", 8, 12, 1, 4096, 4096, 256, True, 0),
]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.view(torch.int16).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    import repro_torch

    print(cs.card(), "repro_torch from", repro_torch.__file__, flush=True)
    build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    mk = lambda *shape: torch.randn(shape, generator=g).to(dev, torch.bfloat16)
    only = sys.argv[1:]
    if not only or "edge" in only:
        for name, B, H, Hkv, Sq, Skv, Dh, causal, window, qoff, grp, hoff in cs.FLASH_BWD_EDGE:
            q, k, v, do = mk(B, H, Sq, Dh), mk(B, Hkv, Skv, Dh), mk(B, Hkv, Skv, Dh), mk(B, H, Sq, Dh)
            kw = dict(causal=causal, window=window, q_offset=qoff, group=grp, head_offset=hoff)
            r = cs.flash_bwd_held(q, k, v, do, kw, name, timed=False)
            print(name, json.dumps({v: [f"{e:.2e}" for e in r["rel"][v]] for v in r["variants"]}),
                  "digest", digest(r["out"]), flush=True)
    for name, B, H, Hkv, Sq, Skv, Dh, causal, window in [*cs.FLASH_BWD_SHAPES, *SHAPES]:
        if only and name not in only:
            continue
        q, k, v, do = mk(B, H, Sq, Dh), mk(B, Hkv, Skv, Dh), mk(B, Hkv, Skv, Dh), mk(B, H, Sq, Dh)
        r = cs.flash_bwd_held(q, k, v, do, dict(causal=causal, window=window), name)
        print(name, json.dumps({
            v: {"ms": round(r["ms"][v], 4),
                "kernels_ms": {n: round(t, 4) for n, t in r["kernels_ms"][v].items()},
                "rel": [f"{e:.2e}" for e in r["rel"][v]]} for v in r["variants"]}),
            json.dumps({"digest": digest(r["out"]), "plain_ms": round(r["plain_ms"], 3),
                        "sdpa_backward_ms": round(r["library_ms"], 4),
                        "bound_ms": round(r["bound_ms"], 5), "bound_by": r["bound_by"]}),
            flush=True)
        del q, k, v, do, r
        torch.cuda.empty_cache()
    print("all within tolerance and bitwise", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
