"""The port's sharded HBM-PS against the JAX reference, on the CPU.

* Host helpers: ``shard_layout``, ``to_sharded_rows``, ``from_sharded_rows``
  and ``plan_a2a`` equal the reference's bitwise on seeded inputs, skewed
  owners included.
* ``ShardedWorkingTable`` on the reference test's ``(2, 4)`` mesh: 8 gloo
  ranks (one process each, started with the ``torchrun`` environment,
  meeting at a ``file://`` store) against the reference's
  ``ShardedWorkingTable`` on 8 forced host devices, run in a subprocess so
  the comparison never depends on how many devices this process's JAX has.
  The gets (pure data movement) bitwise; ``accumulate`` within 1e-6 of the
  largest magnitude (the two scatter-adds sum duplicates in their own
  orders).
* World size 1 (gloo): the three ops equal ``WorkingTable`` bitwise; the S =
  4 per-shard bodies run in one process and assembled equal it too.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.hbm_ps as jhbm  # noqa: E402
import repro_torch.core.hbm_ps as thbm  # noqa: E402
from repro_torch.core.hbm_ps import (  # noqa: E402
    ShardedWorkingTable,
    WorkingTable,
    a2a_restore_body,
    a2a_serve_body,
    accumulate_body,
    from_sharded_rows,
    plan_a2a,
    psum_body,
    to_sharded_rows,
)
from repro_torch.launch.mesh import init_distributed, make_host_mesh  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ACC_TOL = 1e-6  # accumulate: max |port - ref| <= ACC_TOL * max |ref|


def spawn_ranks(script: str, world: int, tmp_path: Path, timeout: float = 240,
                env_extra: dict | None = None) -> None:
    """Run ``script`` in ``world`` processes with the ``torchrun`` environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and ``INIT_METHOD``, a
    ``file://`` rendezvous under ``tmp_path``; every rank must exit 0."""
    init = tmp_path / "rendezvous"
    path = tmp_path / "rank_script.py"
    path.write_text(textwrap.dedent(script))
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r), INIT_METHOD=f"file://{init}",
                   OMP_NUM_THREADS="1", **(env_extra or {}))
        procs.append(subprocess.Popen([sys.executable, str(path)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode:
            errs.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
    assert not errs, "\n".join(errs)


def run_jax(script: str, tmp_path: Path, *args: str) -> subprocess.Popen:
    """Start ``script`` with ``args`` in a subprocess whose JAX sees 8 host
    devices."""
    path = tmp_path / "jax_script.py"
    path.write_text(textwrap.dedent(script))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, str(path), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def wait_ok(p: subprocess.Popen, timeout: float = 240) -> None:
    _, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, err[-3000:]


# --------------------------------------------------------------------------
# host helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,S", [(37, 8, 4), (53, 16, 4), (8, 3, 8), (1, 5, 2), (64, 4, 1)])
def test_shard_layout_helpers_match_reference(n, d, S):
    vals = np.random.default_rng(n * S).random((n, d)).astype(np.float32)
    assert thbm.shard_layout(n, S) == jhbm.shard_layout(n, S)
    got = to_sharded_rows(vals, S)
    want = jhbm.to_sharded_rows(vals, S)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(from_sharded_rows(got, n, S), jhbm.from_sharded_rows(want, n, S))
    assert np.array_equal(from_sharded_rows(got, n, S), vals)


@pytest.mark.parametrize("case", ["random", "skewed", "one_owner", "single_shard"])
def test_plan_a2a_matches_reference(case):
    rng = np.random.default_rng(7)
    S = 1 if case == "single_shard" else 4
    slots = {
        "random": rng.integers(0, 53, 24),
        "skewed": np.array([0, 4, 8, 12, 1, 2, 3, 7]),  # the reference test's skewed owners
        "one_owner": rng.integers(0, 30, 16) * 4 + 2,
        "single_shard": rng.integers(0, 9, 5),
    }[case].astype(np.int64)
    req, restore = plan_a2a(slots, S)
    jreq, jrestore = jhbm.plan_a2a(slots, S)
    assert req.dtype == jreq.dtype and np.array_equal(req, jreq)
    assert restore.dtype == jrestore.dtype and np.array_equal(restore, jrestore)
    # each requester's restored rows are its chunk's slots
    for r in range(S):
        assert np.array_equal(req[r].reshape(-1)[restore[r]], slots.reshape(S, -1)[r])


# --------------------------------------------------------------------------
# ShardedWorkingTable on a (2, 4) mesh of 8 gloo ranks vs JAX on 8 devices
# --------------------------------------------------------------------------

N_ROWS, D, S, B = 53, 16, 4, 24

JAX_SCRIPT = """
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.core.hbm_ps import ShardedWorkingTable, from_sharded_rows, to_sharded_rows
    assert len(jax.devices()) >= 8, jax.devices()
    z = np.load(sys.argv[1])
    vals, slots, grads, sorted_slots = z["vals"], z["slots"], z["grads"], z["sorted_slots"]
    n, S = vals.shape[0], int(z["S"])
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    swt = ShardedWorkingTable(mesh, "model")
    table = jax.device_put(jnp.asarray(to_sharded_rows(vals, S)), swt.sharding())
    out = {"psum": np.asarray(swt.get_psum(table, jnp.asarray(slots.astype(np.int32))))}
    for name, sl, srt in (("acc", slots, False), ("acc_sorted", sorted_slots, True)):
        t2 = swt.accumulate(table, jnp.asarray(sl.astype(np.int32)), jnp.asarray(grads),
                            assume_sorted=srt)
        out[name] = from_sharded_rows(np.asarray(t2), n, S)
    out["a2a"] = np.asarray(swt.get_a2a(table, jnp.asarray(z["req"]), jnp.asarray(z["restore"])))
    np.savez(sys.argv[2], **out)
"""

RANK_SCRIPT = """
    import os, sys
    import numpy as np
    import torch
    from repro_torch.core.hbm_ps import ShardedWorkingTable, to_sharded_rows
    from repro_torch.launch.mesh import init_distributed, make_host_mesh
    info = init_distributed("cpu", init_method=os.environ["INIT_METHOD"])
    z = np.load(os.environ["INPUTS"])
    vals, S = z["vals"], int(z["S"])
    mesh = make_host_mesh(model=S)
    swt = ShardedWorkingTable(mesh, "model")
    r = swt.rank
    rps = to_sharded_rows(vals, S).shape[0] // S
    local = torch.from_numpy(to_sharded_rows(vals, S)[r * rps:(r + 1) * rps].copy())
    t = lambda k: torch.from_numpy(z[k])
    out = {"model_rank": r, "data_rank": mesh.get_local_rank("data"), "n_shards": swt.n_shards,
           "psum": swt.get_psum(local, t("slots")).numpy(),
           "acc": swt.accumulate(local, t("slots"), t("grads")).numpy(),
           "acc_sorted": swt.accumulate(local, t("sorted_slots"), t("grads"),
                                        assume_sorted=True).numpy(),
           "a2a": swt.get_a2a(local, t("req")[r], t("restore")[r]).numpy()}
    assert torch.equal(local, torch.from_numpy(to_sharded_rows(vals, S)[r * rps:(r + 1) * rps]))
    np.savez(os.path.join(os.environ["OUT"], f"rank{info.rank}.npz"), **out)
    torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Both sides on the same inputs: (inputs, JAX outputs, per-rank port
    outputs)."""
    tmp = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(1)
    slots = rng.integers(0, N_ROWS, B).astype(np.int64)
    req, restore = plan_a2a(slots, S)
    inputs = dict(vals=rng.random((N_ROWS, D)).astype(np.float32), slots=slots,
                  grads=rng.random((B, D)).astype(np.float32),
                  sorted_slots=np.sort(rng.integers(0, N_ROWS, B)).astype(np.int64),
                  req=req, restore=restore, S=S)
    np.savez(tmp / "inputs.npz", **inputs)
    jax_proc = run_jax(JAX_SCRIPT, tmp, str(tmp / "inputs.npz"), str(tmp / "jax.npz"))
    spawn_ranks(RANK_SCRIPT, 8, tmp, env_extra={"INPUTS": str(tmp / "inputs.npz"),
                                                "OUT": str(tmp)})
    wait_ok(jax_proc)
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(8)]
    return inputs, dict(np.load(tmp / "jax.npz")), ranks


def _row0(ranks):
    """The ranks of data row 0, ordered by model rank."""
    row = sorted((r for r in ranks if int(r["data_rank"]) == 0), key=lambda r: int(r["model_rank"]))
    assert [int(r["model_rank"]) for r in row] == list(range(S))
    return row


def test_mesh_layout_is_the_reference_mesh(mesh_runs):
    _, _, ranks = mesh_runs
    assert sorted((int(r["data_rank"]), int(r["model_rank"])) for r in ranks) == [
        (a, b) for a in range(2) for b in range(S)]
    assert all(int(r["n_shards"]) == S for r in ranks)


def test_sharded_get_psum_matches_reference_bitwise(mesh_runs):
    inputs, ref, ranks = mesh_runs
    for r in ranks:
        assert np.array_equal(r["psum"], ref["psum"])
    assert np.array_equal(ref["psum"], inputs["vals"][inputs["slots"]])


@pytest.mark.parametrize("which", ["acc", "acc_sorted"])
def test_sharded_accumulate_matches_reference(mesh_runs, which):
    inputs, ref, ranks = mesh_runs
    for data_rank in (0, 1):
        row = sorted((r for r in ranks if int(r["data_rank"]) == data_rank),
                     key=lambda r: int(r["model_rank"]))
        got = from_sharded_rows(np.concatenate([r[which] for r in row]), N_ROWS, S)
        err, scale = float(np.abs(got - ref[which]).max()), float(np.abs(ref[which]).max())
        assert err <= ACC_TOL * scale, (which, data_rank, err, scale)


def test_sharded_get_a2a_matches_reference_bitwise(mesh_runs):
    inputs, ref, ranks = mesh_runs
    got = np.concatenate([r["a2a"] for r in _row0(ranks)])
    assert np.array_equal(got, ref["a2a"])
    assert np.array_equal(got, inputs["vals"][inputs["slots"]])
    # the second data row's requesters receive the same rows
    row1 = sorted((r for r in ranks if int(r["data_rank"]) == 1), key=lambda r: int(r["model_rank"]))
    assert np.array_equal(np.concatenate([r["a2a"] for r in row1]), got)


# --------------------------------------------------------------------------
# world size 1, and the S per-shard bodies in one process
# --------------------------------------------------------------------------


@pytest.fixture
def world1():
    """A gloo world of one in this process, removed afterwards."""
    init_distributed("cpu")
    yield make_host_mesh()
    torch.distributed.destroy_process_group()


def _data(n=53, d=16, b=24, seed=3):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.random((n, d)).astype(np.float32))
    slots = torch.from_numpy(rng.integers(0, n, b).astype(np.int32))
    grads = torch.from_numpy(rng.random((b, d)).astype(np.float32))
    return table, slots, grads


def test_world_of_one_equals_working_table_bitwise(world1):
    table, slots, grads = _data()
    swt = ShardedWorkingTable(world1, "model")
    assert (swt.n_shards, swt.rank) == (1, 0)
    assert torch.equal(swt.get_psum(table, slots), WorkingTable.get(table, slots))
    assert torch.equal(swt.accumulate(table, slots, grads),
                       WorkingTable.accumulate(table, slots, grads))
    sorted_slots = torch.sort(slots).values
    assert torch.equal(swt.accumulate(table, sorted_slots, grads, assume_sorted=True),
                       WorkingTable.accumulate(table, sorted_slots, grads, assume_sorted=True))
    req, restore = plan_a2a(slots.numpy(), 1)
    got = swt.get_a2a(table, torch.from_numpy(req[0]), torch.from_numpy(restore[0]))
    assert torch.equal(got, WorkingTable.get(table, slots))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_per_shard_bodies_assemble_to_the_working_table(n_shards):
    """The S bodies of each op, run in one process with the collectives
    done by hand: the psum parts sum to ``WorkingTable.get``, the accumulated
    shards reassemble to ``WorkingTable.accumulate`` (dyadic gradients, so
    every sum is exact: bitwise), and the two exchanges of ``get_a2a``
    deliver every requester its rows."""
    table, slots, _ = _data()
    grads = torch.from_numpy((np.random.default_rng(4).integers(-64, 64, (24, 16)) / 16)
                             .astype(np.float32))
    shards = torch.from_numpy(to_sharded_rows(table.numpy(), n_shards)).chunk(n_shards)
    parts = [psum_body(shards[r], slots, r, n_shards) for r in range(n_shards)]
    assert torch.equal(torch.stack(parts).sum(0), WorkingTable.get(table, slots))
    new = torch.cat([accumulate_body(shards[r], slots, grads, r, n_shards)
                     for r in range(n_shards)])
    assert torch.equal(torch.from_numpy(from_sharded_rows(new.numpy(), 53, n_shards)),
                       WorkingTable.accumulate(table, slots, grads))
    req, restore = (torch.from_numpy(a) for a in plan_a2a(slots.numpy(), n_shards))
    m = req.shape[-1]
    served = [a2a_serve_body(shards[o], req[:, o].reshape(-1), n_shards)
              for o in range(n_shards)]  # owner o answers every requester's list
    got = torch.cat([a2a_restore_body(torch.cat([served[o][r * m:(r + 1) * m]
                                                 for o in range(n_shards)]), restore[r])
                     for r in range(n_shards)])
    assert torch.equal(got, WorkingTable.get(table, slots))


def test_bodies_zero_what_a_shard_does_not_own():
    table, slots, grads = _data()
    shards = torch.from_numpy(to_sharded_rows(table.numpy(), 4)).chunk(4)
    part = psum_body(shards[1], slots, 1, 4)
    assert not part[(slots % 4) != 1].any()
    new = accumulate_body(shards[1], slots, grads, 1, 4)
    # a shard's rows change only where it owns a slot
    owned_rows = torch.unique(slots[(slots % 4) == 1] // 4)
    untouched = torch.ones(new.shape[0], dtype=torch.bool)
    untouched[owned_rows.long()] = False
    assert owned_rows.numel() > 0 and torch.equal(new[untouched], shards[1][untouched])
