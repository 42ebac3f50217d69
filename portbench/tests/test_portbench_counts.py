"""Each ``counts/<op>.py`` against operations and bytes worked by hand."""

import pytest

from harness import cell
from reference.lm import Model


def test_kept_pairs_by_hand():
    pairs = cell.count("flash_fwd").__globals__["kept_pairs"]
    assert pairs(4, 4, True, 0) == 10          # 1 + 2 + 3 + 4
    assert pairs(4, 4, False, 0) == 16
    assert pairs(4, 4, True, 2) == 7           # 1 + 2 + 2 + 2
    assert pairs(2, 4, True, 0) == 7           # queries at 2, 3: 3 + 4


def test_flash_fwd_by_hand():
    # B=1, H=2, Hkv=1, S=4, hd=8, causal: 10 pairs a head
    flops, nbytes = cell.count("flash_fwd")(q=(1, 2, 4, 8), kv=(1, 1, 4, 8), causal=True,
                                            window=0, elem=2, lse=True)
    assert flops == 4 * 8 * 10 * 2
    # q 64 + k 32 + v 32 + o 64 elements of 2 bytes, lse 8 floats
    assert nbytes == 2 * (64 + 32 + 32 + 64) + 4 * 8


def test_flash_bwd_by_hand():
    flops, nbytes = cell.count("flash_bwd")(q=(1, 2, 4, 8), kv=(1, 1, 4, 8), causal=True,
                                            window=0, elem=2)
    assert flops == 10 * 8 * 10 * 2
    # read q, o, do (64 each), k, v (32 each), lse; write dq (64), dk, dv (32 each)
    assert nbytes == 2 * (4 * 64 + 4 * 32) + 4 * 8


TINY = Model(d=8, heads=2, kv_heads=1, head_dim=4, ff=16, vocab=10, layers=3,
             rope_theta=1e4, eps=1e-5)


def test_lm_prefill_by_hand():
    flops, _ = cell.count("lm_prefill")(model=TINY, rows=2, seq=4)
    per_layer = 8 * 4 * (2 * 2 + 2 * 1) + 3 * 8 * 16      # projections + SwiGLU
    attn = 4 * 4 * 2 * 10 * 3                              # 10 causal pairs, 2 heads, 3 layers
    assert flops == 2 * (2 * 3 * per_layer * 4 + attn + 2 * 8 * 10)


def test_lm_train_by_hand():
    flops, _ = cell.count("lm_train")(model=TINY, tokens=8, seq=4)
    per_token = 3 * (8 * 4 * 6 + 3 * 8 * 16) + 8 * 10
    attn = 4 * 4 * 2 * 10 * 3
    assert flops == 3 * (2 * per_token * 8 + attn * 2)


@pytest.mark.parametrize("op", ["flash_fwd", "flash_bwd"])
def test_window_masks_count_fewer_pairs(op):
    full = cell.count(op)(q=(1, 1, 64, 8), kv=(1, 1, 64, 8), causal=True, window=0)[0]
    band = cell.count(op)(q=(1, 1, 64, 8), kv=(1, 1, 64, 8), causal=True, window=16)[0]
    assert 0 < band < full
