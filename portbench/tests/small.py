"""Cells of the benchmark at small widths, for runs on the CPU: the same
harness, program path and reference as the card's runs, with each
configuration cut to a few dozen columns and each mix to a few dozen
tokens."""

import importlib

import torch

from harness import cell as cells

CONFIGS = {
    "yi-9b": dict(name="yi-9b-small", hidden_size=64, intermediate_size=128,
                  num_attention_heads=8, num_key_value_heads=2, head_dim=8, vocab_size=512,
                  rope_theta=10000.0, rms_norm_eps=1e-5, layers_run={"train": 2, "prefill": 2}),
}
SEQ = {"yi-9b": 32}


# Limits at these widths, between what the program's plain path read on the
# CPU (the first figure) and what the float8 control read (the second), on
# seeds 3-7 and the tests' seed: training grad1_diff 0.018-0.024 /
# 0.212-0.260; serving gap 0 / 0.133-0.230, logits 0.0061-0.0086 /
# 0.077-0.111. The other training numbers overlap at these widths and are
# held loosely; ``ps_rows`` and ``rows`` are exact.
LIMITS = {
    "yi-9b.train": {"grad1": 0.008, "grad1_diff": 0.08, "change3": 0.03, "table3": 0.15,
                    "ps_rows": 0},
    "yi-9b.prefill": {"rows": 0, "gap": 0.1, "logits": 0.03},
}


def load(workload: str) -> cells.Cell:
    c = cells.load(workload, config=CONFIGS[workload.split(".")[0]])
    c.mix = dict(c.mix, seq=SEQ[workload.split(".")[0]], check_requests=3)
    c.limits = LIMITS[".".join(workload.split(".")[:2])]
    return c


def run(workload: str, seed: int, seconds: float = 0.5, faults=None) -> dict:
    """One run of ``workload`` at small widths on the CPU, past the
    harness's look for a card."""
    torch.manual_seed(0)
    c = load(workload)
    runner = importlib.import_module(f"harness.{c.mode}")
    try:
        return runner.run(c, seed, seconds, False, "cpu", faults=faults)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
