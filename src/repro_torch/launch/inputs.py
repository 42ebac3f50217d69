"""Meta stand-ins for every input of a dry-run cell, rank-local.

The port's counterpart of the reference's ``launch/inputs.py``: where the
reference builds ``ShapeDtypeStruct``s and their shardings, each function
here returns this rank's tensors on the ``meta`` device (shapes and
dtypes, no storage) under the port's placement (``launch/sharding.py``):

  * the batch is split over ``data`` where ``data`` divides it (the
    reference's rule), every ``model`` rank holding its data rank's rows;
  * the working table (hier_ps) is the MEM-PS's static capacity,
    :func:`working_rows`, whole on every rank, or its d-slice over
    ``model`` where the rules put ``working_dim`` there (the launcher's
    ``tp_rows``);
  * decode caches hold this rank's kv heads (the ones its q heads read,
    ``models/attention.py``), its mamba channels and its mLSTM heads.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.launch.sharding import data_axes, pspec
from repro_torch.models.attention import KVCache
from repro_torch.models.common import block_range, kv_heads_read

F32 = torch.float32
BF16 = torch.bfloat16
I32 = torch.int32

WORKING_CAP = 65536


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def working_rows(cfg: ArchConfig, n_tokens: int) -> int:
    n = min(cfg.vocab_size, n_tokens, WORKING_CAP)
    return max(256, (n + 255) // 256 * 256)


def _sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def local_batch(mesh, B: int) -> int:
    """This rank's rows of a global batch of ``B``."""
    dp = math.prod(_sizes(mesh)[a] for a in data_axes(mesh))
    return B // dp if B % dp == 0 else B


def table_dim(cfg: ArchConfig, mesh, rules: dict) -> int:
    """This rank's columns of the working table: its d-slice where the rules
    put ``working_dim`` on ``model``, else all of ``d_model``."""
    d, M = cfg.d_model, _sizes(mesh).get("model", 1)
    placed = pspec((1, d), ("working_rows", "working_dim"), rules, mesh)
    return d // M if placed == (None, "model") else d


def _extras(cfg: ArchConfig, B: int) -> dict:
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = meta((B, cfg.n_frames, cfg.d_model), BF16)
    if cfg.family == "vlm":
        batch["image_embeds"] = meta((B, cfg.n_image_tokens, cfg.d_model), BF16)
    return batch


def train_batch(cfg: ArchConfig, shape: ShapeSpec, mesh) -> dict:
    B, S = local_batch(mesh, shape.global_batch), shape.seq_len
    return {"tokens": meta((B, S), I32), "targets": meta((B, S), I32), **_extras(cfg, B)}


def hier_tables(cfg: ArchConfig, n_tokens: int, mesh, rules: dict,
                rows: int | None = None) -> tuple:
    """(working table, row accumulator), fp32: ``rows`` (default
    :func:`working_rows` of the global batch's ``n_tokens``) by this
    rank's columns."""
    n = working_rows(cfg, n_tokens) if rows is None else rows
    d = table_dim(cfg, mesh, rules)
    return meta((n, d), F32), meta((n, d), F32)


def prefill_batch(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: dict) -> dict:
    B, S = local_batch(mesh, shape.global_batch), shape.seq_len
    batch = {"tokens": meta((B, S), I32), **_extras(cfg, B)}
    if cfg.embedding_mode == "hier_ps":
        batch["working_table"] = hier_tables(cfg, shape.global_batch * S, mesh, rules)[0]
    return batch


def decode_batch(cfg: ArchConfig, shape: ShapeSpec, mesh, rules: dict) -> dict:
    B = shape.global_batch
    batch = {"token": meta((local_batch(mesh, B), 1), I32)}
    if cfg.embedding_mode == "hier_ps":
        batch["working_table"] = hier_tables(cfg, max(B, 256), mesh, rules)[0]
    return batch


# --------------------------------------------------------------------------
# decode caches, this rank's part
# --------------------------------------------------------------------------


def local_kv_heads(cfg: ArchConfig, mesh, rank: int) -> int:
    """The kv heads this ``model`` rank's cache holds: its own where kv heads
    are placed on ``model``, all where the q heads' columns stay whole (the
    block runs whole), else the replicated ones its q heads read
    (``models/attention.py``: whole q heads, uneven where the rules cut
    inside a head; none for a rank that owns none)."""
    M = _sizes(mesh).get("model", 1)
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if M == 1 or Hkv % M == 0:
        return Hkv // M
    if (H * cfg.resolved_head_dim) % M:
        return Hkv
    lo, hi, _ = kv_heads_read(*block_range(H, rank, M), H // Hkv)
    return hi - lo


def _kv(L: int, B: int, Hkv: int, S: int, hd: int) -> KVCache:
    return KVCache(meta((L, B, Hkv, S, hd), BF16), meta((L, B, Hkv, S, hd), BF16))


def decode_cache(cfg: ArchConfig, shape: ShapeSpec, mesh, model_rank: int):
    """This rank's decode cache for ``shape`` (a context of ``seq_len``)."""
    B, S = local_batch(mesh, shape.global_batch), shape.seq_len
    M = _sizes(mesh).get("model", 1)
    hd = cfg.resolved_head_dim
    Hkv = local_kv_heads(cfg, mesh, model_rank)

    if cfg.family in ("dense", "moe", "vlm"):
        S_tot = S + (cfg.n_image_tokens if cfg.family == "vlm" else 0)
        return _kv(cfg.n_layers, B, Hkv, S_tot, hd)

    if cfg.family == "audio":
        from repro_torch.models.whisper import WhisperCache

        return WhisperCache(_kv(cfg.n_layers, B, Hkv, S, hd),
                            _kv(cfg.n_layers, B, Hkv, cfg.n_frames, hd))

    if cfg.family == "hybrid":
        from repro_torch.models import hymba as H
        from repro_torch.models.mamba import EXPAND, MambaState

        n_glb = len(cfg.global_attn_layers)
        n_swa = cfg.n_layers - n_glb
        max_len = cfg.n_meta_tokens + S
        W = min(cfg.window, max_len)
        din = EXPAND * cfg.d_model
        din //= M if din % M == 0 else 1  # mamba on this rank's channels, or whole
        state = lambda n: MambaState(meta((n, B, din, cfg.ssm_state), F32),
                                     meta((n, B, 3, din), F32))
        return H.HymbaCache(_kv(n_swa, B, Hkv, W, hd), _kv(n_glb, B, Hkv, max_len, hd),
                            state(n_swa), state(n_glb))

    if cfg.family == "ssm":
        from repro_torch.models import xlstm as X

        n_super, m_per = X.layout(cfg)
        dp = int(cfg.proj_factor * cfg.d_model)
        H = cfg.n_heads
        dh_m, dh_s = dp // H, cfg.d_model // H
        mm = M if H % M == 0 else 1  # the mLSTM on this rank's heads, or whole
        Hm = H // mm
        m = X.MLSTMState(meta((n_super, m_per, B, Hm, dh_m, dh_m), F32),
                         meta((n_super, m_per, B, Hm, dh_m), F32),
                         meta((n_super, m_per, B, Hm), F32),
                         meta((n_super, m_per, B, X.CONV_K - 1, dp // mm), F32))
        s = X.SLSTMState(*(meta((n_super, B, H, dh_s), F32) for _ in range(4)))  # whole
        return X.XLSTMCache(m, s)

    raise ValueError(cfg.family)
