"""Readings that the limits of ``limits/<workload>.json`` are set from,
besides the benchmark's own runs: the lower-precision control and the
planted faults, at a cell's own sizes. Not run by the benchmark.

  python3 portbench/control.py --workload <name> --seeds 11,12,13

For each seed it makes the cell's inputs as a run does and puts the plain
reference, computed with every matmul's operands rounded to float8 e4m3
(``reference/lm.py``'s ``mm``), in the program's place:

- a training cell: the first three steps, and again with the second half of
  each batch left out (a planted fault), each compared with the float32
  reference as a run compares the program (``harness/compare.py``); a step
  that returns its state unchanged reads 1 on ``change3`` by the measure
  itself and needs no run;
- a prefill cell: ``check_requests`` prompts; the token that the float8
  forward puts first at the last position (the one a run serves) and its
  gap below the float32 forward's best there, as a run reads ``gap``, and
  the last position's logits' gap; beside them the widest such gap at any
  position of the prompt.

Prints one JSON line a seed and reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]


def train(cell, seed: int, device) -> list[dict]:
    from harness import compare
    from harness.train import CHECK_STEPS, reference
    from harness.traffic import Tokens

    m = cell.model()
    tokens = Tokens(cell.mix, m.vocab, seed, targets=True)
    batches = [tokens.draw() for _ in range(CHECK_STEPS)]
    out = []
    for name, kw in (("control_fp8", dict(prec="fp8")), ("fault_half_batch", dict(half_batch=True))):
        got = reference(m, seed, batches, cell.mix, device, keep_grad1=True, **kw)
        got.pop("rows0")
        want = reference(m, seed, batches, cell.mix, device, grad1_of=got.pop("grad1_full"))
        want.pop("rows0")
        got["grad1_diff"] = want.pop("grad1_diff")
        numbers, where = compare.train_numbers(got, want)
        out.append(dict(seed=seed, reading=name, numbers=numbers, where=where))
    return out


def prefill(cell, seed: int, device) -> list[dict]:
    import numpy as np
    import torch

    from harness import weights
    from harness.traffic import Tokens
    from reference import lm as ref

    ref.strict_fp32()
    m, mix = cell.model(), cell.mix
    params = ref.unflatten(weights.make(m, seed, torch.bfloat16, device))
    table = weights.table_rows(m.vocab, m.d, seed, device)
    tokens = Tokens(mix, m.vocab, seed, targets=False)
    gaps, every, errs = [], [], []
    for _ in range(int(mix["check_requests"])):
        prompt = tokens.draw()
        for r in range(prompt.shape[0]):
            x = table[torch.from_numpy(prompt[r].astype(np.int64)).to(device)][None]
            want = ref.prompt_logits(m, params, x, last_only=False)
            got = ref.prompt_logits(m, params, x, "fp8", last_only=False)
            below = want.max(dim=-1).values - want.gather(1, got.argmax(dim=-1)[:, None])[:, 0]
            gaps.append(float(below[-1]))
            every.append(float(below.max()))
            errs.append(float((got[-1] - want[-1]).abs().max() / want[-1].abs().max()))
            del want, got
    return [dict(seed=seed, reading="control_fp8",
                 numbers={"gap": max(gaps), "logits": max(errs)},
                 gap_at_every_position=max(every))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    sys.path.insert(1, os.path.join(os.path.dirname(HERE), "src"))
    import torch

    from harness import cell as cells

    c = cells.load(args.workload)
    fn = train if c.mode == "train" else prefill
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for rec in fn(c, seed, torch.device("cuda")):
            rec["seconds"] = time.perf_counter() - t0
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
