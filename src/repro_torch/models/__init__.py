"""Models of the ported paths: the paper's CTR network (``ctr``) and the
dense decoder-only LM (``transformer``, with ``attention`` and ``common``).

:func:`get_model` is the reference's model-zoo registry for the families the
port has: ``dense``. The others raise ``NotImplementedError`` naming the
slice they belong to.
"""

from __future__ import annotations

from types import SimpleNamespace

from repro_torch.configs import ArchConfig

_LATER = {
    "moe": "the MoE/VLM slice",
    "vlm": "the MoE/VLM slice",
    "hybrid": "the hybrid/ssm/audio slice",
    "ssm": "the hybrid/ssm/audio slice",
    "audio": "the hybrid/ssm/audio slice",
}


def get_model(cfg: ArchConfig) -> SimpleNamespace:
    """Returns a namespace with schema/init/forward/prefill/decode_step."""
    if cfg.family == "dense":
        from repro_torch.models import transformer as m

        return SimpleNamespace(
            name="transformer",
            schema=m.schema,
            init=m.init,
            forward=m.forward,
            prefill=m.prefill,
            decode_step=m.decode_step,
        )
    if cfg.family in _LATER:
        raise NotImplementedError(f"{cfg.name}: the {cfg.family} family belongs to "
                                  f"{_LATER[cfg.family]} of the port")
    raise ValueError(f"unknown family {cfg.family!r}")
