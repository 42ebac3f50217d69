"""Models of the ported paths: the paper's CTR network (``ctr``) and the
LM model zoo — the decoder-only transformer (``transformer``, with
``attention``, ``moe`` and ``common``), the hybrid ``hymba`` (with
``mamba``), the recurrent ``xlstm`` and the encoder-decoder ``whisper``.

:func:`get_model` is the reference's model-zoo registry: one uniform API per
architecture family.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs import ArchConfig


def _namespace(name: str, m, **extra) -> SimpleNamespace:
    return SimpleNamespace(name=name, schema=m.schema, init=m.init, forward=m.forward,
                           prefill=m.prefill, decode_step=m.decode_step, stored=m.STORED,
                           **extra)


def get_model(cfg: ArchConfig) -> SimpleNamespace:
    """Returns a namespace with schema/init/forward/prefill/decode_step."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m

        return _namespace("transformer", m)
    if cfg.family == "hybrid":
        from repro_torch.models import hymba as m

        return _namespace("hymba", m, init_cache=m.init_cache)
    if cfg.family == "ssm":
        from repro_torch.models import xlstm as m

        # recurrent: prefill == forward stepping states
        return SimpleNamespace(name="xlstm", schema=m.schema, init=m.init, forward=m.forward,
                               prefill=None, decode_step=m.decode_step,
                               init_cache=m.init_cache, stored=m.STORED)
    if cfg.family == "audio":
        from repro_torch.models import whisper as m

        return _namespace("whisper", m)
    raise ValueError(f"unknown family {cfg.family!r}")
