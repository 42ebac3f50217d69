"""Checkpoint/restart: atomic, async, covers device state AND PS state.

The port's copy of the reference's ``train/checkpoint.py``, on torch
tensors. Layout: <dir>/step_<N>/ containing
  manifest.json          — treedef paths, shapes/dtypes, step, extra metadata
  arrays.npz             — all tree leaves (keyed by flattened path)
  ps_manifest.json       — optional PS cluster manifest: the SSD file map
                           plus the hosted table specs (name/table_id/
                           RowSchema), so Cluster.restore rebuilds the same
                           named tables and their key namespacing

Writes go to a temp dir then ``os.replace`` (atomic on POSIX); a ``latest``
symlink is flipped last, so a crash mid-save never corrupts the restore
point. ``AsyncCheckpointer`` snapshots tensors on the caller thread (device
-> host copy) and persists on a background thread — the training loop is
only blocked for the copy, as in production checkpointing. ``restore``
returns numpy leaves; the caller moves them to its device (``tree_map``).
The snapshot publisher shares ``atomic_write_json`` and ``flip_pointer``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template, flat, prefix=""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):  # NamedTuple
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(*vals)
    if isinstance(template, (list, tuple)):
        vals = [_unflatten_into(v, flat, f"{prefix}{i}/") for i, v in enumerate(template)]
        return type(template)(vals) if isinstance(template, list) else tuple(vals)
    return flat[prefix.rstrip("/")]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists, tuples and
    NamedTuples, keeping its structure (the port's ``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_numpy(leaf):
    """A host numpy copy of a tensor leaf (any device); other leaves as
    ``np.asarray`` gives them."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.asarray(leaf)


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


def save(directory: str, step: int, tree, extra: dict | None = None, ps_manifest: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    flat = {k: np.asarray(v) for k, v in _flatten(tree).items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat), "extra": extra or {}}, f)
    if ps_manifest is not None:
        with open(os.path.join(tmp, "ps_manifest.json"), "w") as f:
            json.dump(_jsonify(ps_manifest), f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    # flip the 'latest' pointer last
    flip_pointer(os.path.join(directory, "latest"), os.path.basename(final))
    return final


def latest_step(directory: str) -> int | None:
    latest = os.path.join(directory, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    return int(name.split("_")[1])


def restore_extra_arrays(directory: str, prefix: str, step: int | None = None) -> dict:
    """Load the array leaves saved under ``prefix`` as a nested dict —
    for checkpoint subtrees whose shape varies between saves (e.g. the
    training wire's per-key error-feedback state, DESIGN.md §13) and so
    cannot ride the fixed ``restore`` template. Returns ``{}`` when the
    checkpoint predates the subtree, keeping old checkpoints restorable."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    out: dict = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for k in z.files:
            if not k.startswith(prefix):
                continue
            parts = k[len(prefix):].strip("/").split("/")
            d = out
            for p in parts[:-1]:
                d = d.setdefault(p, {})
            d[parts[-1]] = z[k]
    return out


def restore(directory: str, template, step: int | None = None):
    """Returns (tree, step, extra, ps_manifest|None)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree = _unflatten_into(template, flat)
    ps_manifest = None
    ps_path = os.path.join(path, "ps_manifest.json")
    if os.path.exists(ps_path):
        with open(ps_path) as f:
            ps_manifest = json.load(f)
    return tree, manifest["step"], manifest["extra"], ps_manifest


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


class AsyncCheckpointer:
    """Snapshot on the caller thread, persist on a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, extra=None, ps_manifest=None) -> None:
        self.wait()  # one in flight at a time
        snapshot = tree_map(to_numpy, tree)  # device->host

        def work():
            try:
                save(self.directory, step, snapshot, extra, ps_manifest)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
