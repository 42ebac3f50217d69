"""Atomic JSON and pointer writes shared by the snapshot publisher.

The port's copy of the two JAX-free helpers of the reference's
``train/checkpoint.py`` (``atomic_write_json`` and ``flip_pointer``, with
the ``_jsonify`` coercion they need). The rest of that module saves device
pytrees and comes with the training slice.
"""

from __future__ import annotations

import json
import os

import numpy as np


def atomic_write_json(path: str, obj) -> None:
    """JSON via temp file + ``os.replace`` (atomic on POSIX) with numpy
    scalars coerced. Shared by checkpoint manifests and the serving
    snapshot publisher (repro_torch.serve.snapshot)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_jsonify(obj), f)
    os.replace(tmp, path)


def flip_pointer(path: str, value: str) -> None:
    """Atomically repoint a one-line pointer file (``latest``/``LATEST``)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(value)
    os.replace(tmp, path)


def _jsonify(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj
