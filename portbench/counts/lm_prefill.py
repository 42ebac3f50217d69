"""Model operations of one prefill of ``rows`` prompts of ``seq`` tokens:
2 operations per weight of the layers a token passes through, 4 * hd per
causal (query, key) pair and head of attention, and the output head at
the last position of each prompt only."""


def weights_per_token(model) -> float:
    """The weights of the layer stack one token multiplies: attention
    projections and the SwiGLU MLP."""
    d, hd = model.d, model.head_dim
    attn = d * hd * (2 * model.heads + 2 * model.kv_heads)
    return float(model.layers * (attn + 3 * d * model.ff))


def count(*, model, rows, seq, **_) -> tuple[float, float]:
    attn = 4.0 * model.head_dim * model.heads * seq * (seq + 1) / 2 * model.layers
    flops = rows * (2.0 * weights_per_token(model) * seq + attn + 2.0 * model.d * model.vocab)
    return flops, 0.0
