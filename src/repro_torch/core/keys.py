"""Key hashing / partitioning for the hierarchical parameter server.

Parameters are identified by 64-bit keys. The paper partitions keys across
nodes and across GPUs with modulo hashing ("the features of the input
training data are usually distributed randomly"). We hash with splitmix64
first so that *any* key distribution partitions evenly, then take the modulo.
All functions are vectorized over numpy uint64 arrays and deterministic —
determinism matters: missing-key initialization is derived from the key so
that the hierarchical-PS path and the flat in-memory path train identically
(the paper's "lossless" property becomes an exact, testable invariant).
"""

from __future__ import annotations

import numpy as np

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_U64 = np.uint64

# --- table namespacing (multi-table PS client, DESIGN.md §6) ---------------
# The top TABLE_BITS of a cluster key tag which named table the row belongs
# to; the low KEY_BITS carry the caller's raw key. Table id 0 tags to the
# identity, so a single anonymous table (the pre-multi-table API) lives in
# exactly the same key space as before.
TABLE_BITS = 8
KEY_BITS = 64 - TABLE_BITS
MAX_TABLES = 1 << TABLE_BITS
MAX_RAW_KEY = np.uint64((1 << KEY_BITS) - 1)  # inclusive
_RAW_MASK = np.uint64((1 << KEY_BITS) - 1)


def namespace_keys(keys: np.ndarray, table_id: int) -> np.ndarray:
    """Tag raw per-table keys into the shared cluster key space.

    The tag occupies the high TABLE_BITS, so two tables' keys can never
    collide; the hash-partitioned owner map then spreads each table's rows
    across all nodes (splitmix64 mixes the high bits into every output bit).
    """
    if not 0 <= table_id < MAX_TABLES:
        raise ValueError(f"table_id {table_id} out of range [0, {MAX_TABLES})")
    keys = np.asarray(keys, dtype=np.uint64)
    if keys.size and bool((keys > _RAW_MASK).any()):
        raise ValueError(f"raw keys must fit in {KEY_BITS} bits (max {int(_RAW_MASK)})")
    if table_id == 0:
        return keys
    return keys | _U64(table_id << KEY_BITS)


def split_namespaced(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`namespace_keys`: (table_ids int64, raw uint64)."""
    keys = np.asarray(keys, dtype=np.uint64)
    return (keys >> _U64(KEY_BITS)).astype(np.int64), keys & _RAW_MASK


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Bijective 64-bit finalizer (vectorized). Input/output uint64."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> _U64(30))) * _MIX1
        z = (z ^ (z >> _U64(27))) * _MIX2
        z = z ^ (z >> _U64(31))
    return z


def hash_keys(keys: np.ndarray, seed: int = 0) -> np.ndarray:
    with np.errstate(over="ignore"):
        return splitmix64(np.asarray(keys, dtype=np.uint64) ^ _U64(seed))


def key_to_node(keys: np.ndarray, n_nodes: int, seed: int = 1) -> np.ndarray:
    """Owner node of each key (paper: modulo partitioning across MEM-PS)."""
    return (hash_keys(keys, seed) % _U64(n_nodes)).astype(np.int64)


def key_to_shard(keys: np.ndarray, n_shards: int, seed: int = 2) -> np.ndarray:
    """Owner device shard within the HBM-PS (paper: per-GPU partition)."""
    return (hash_keys(keys, seed) % _U64(n_shards)).astype(np.int64)


def deterministic_init(keys: np.ndarray, dim: int, scale: float = 0.01, seed: int = 3) -> np.ndarray:
    """Per-key deterministic pseudo-random init, vectorized.

    Row i is a function of keys[i] only — independent of read order, node
    count, or cache state. Values ~ scale * U(-1, 1) per component.
    """
    keys = np.asarray(keys, dtype=np.uint64)
    cols = np.arange(dim, dtype=np.uint64)
    with np.errstate(over="ignore"):
        grid = hash_keys(keys, seed)[:, None] * _GOLDEN + cols[None, :] * _MIX1
        bits = splitmix64(grid)
    u = (bits >> _U64(11)).astype(np.float64) * (1.0 / (1 << 53))  # [0,1)
    return ((u * 2.0 - 1.0) * scale).astype(np.float32)


def member_sorted(ref: np.ndarray, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Membership of sorted ``q`` in sorted-unique ``ref``.

    Returns (mask, pos): ``mask[i]`` iff ``q[i]`` is in ``ref``, and
    ``pos[i]`` is its index there (valid only where ``mask``). One
    searchsorted pass — the shared primitive behind the in-flight conflict
    scan (hier_ps) and the device working-set reuse plan (hbm_ps)."""
    if len(ref) == 0 or len(q) == 0:
        return np.zeros(len(q), dtype=bool), np.zeros(len(q), dtype=np.int64)
    pos = np.searchsorted(ref, q)
    pos_c = np.minimum(pos, len(ref) - 1)
    return ref[pos_c] == q, pos_c


def partition_by_owner(keys: np.ndarray, owners: np.ndarray, n_owners: int):
    """Group ``keys`` by owner id.

    Returns (order, splits) such that keys[order] is owner-sorted and
    np.split(keys[order], splits) yields one array per owner. ``order`` lets
    callers scatter per-owner results back into request order.
    """
    order = np.argsort(owners, kind="stable")
    counts = np.bincount(owners, minlength=n_owners)
    splits = np.cumsum(counts)[:-1]
    return order, splits
