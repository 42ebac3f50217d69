"""Model operations of one training step of the decoder LM over ``tokens``
tokens in sequences of ``seq`` (what the model needs, not what a run
recomputes): three times the forward's, the forward being 2 operations
per weight a token passes through (attention projections, the MLP, the
output head) and 4 * hd per
causal (query, key) pair and head of attention. The embedding gather is
left out."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("portbench_count_lm_prefill",
                                               Path(__file__).with_name("lm_prefill.py"))
_fwd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fwd)


def count(*, model, tokens, seq, **_) -> tuple[float, float]:
    seqs = tokens // seq
    per_token = _fwd.weights_per_token(model) + model.d * model.vocab
    attn = 4.0 * model.head_dim * model.heads * seq * (seq + 1) / 2 * model.layers
    return 3.0 * (2.0 * per_token * tokens + attn * seqs), 0.0
