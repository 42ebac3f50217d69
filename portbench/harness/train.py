"""The ``train`` mode: the launcher's step loop, ``repro_torch.launch.train.run``,
on a world of one (NCCL on the card), its token table ``tok_emb`` on a
``Cluster`` of ``nodes`` PS nodes, driven through its public arguments.

Set-up makes the weights from the seed (``harness/weights.py``) and hands
them to ``run`` (``params=``), which builds the cluster, the client and
AdamW's state. As the client is made, every row of the table is pulled
once (the PS makes a row at its first pull), so that the window finds the
table as a run that has trained for a while holds it: every id present,
and none made on the way. ``warm`` steps follow; the window is every step
after them, back to back, each with its PS pull, its step, the new rows'
copy to the host and their commit, until ``seconds`` have passed at a
step's end.
The batches are the benchmark's own (``harness/traffic.py``, from the
seed): the launcher draws them through ``TokenStream``, which is replaced
for the run by the benchmark's feed (the launcher has no argument for a
stream). The launcher cannot stop at a deadline, so the feed ends the run
by raising :class:`WindowClosed` where the next step would start: the last
session is committed and none is open.

The first three steps are the reference's: their losses, the gradient
AdamW received at step 1 (from its first moment, as step 2 is handed it),
the parameters step 4 is handed, and the rows and accumulators of every
token of the three steps, read back from the PS before step 4 commits,
are kept, and after the window the reference runs the same three steps.

Every step, the window's included, is also held to what the PS was handed:
for a sample of ids drawn from the seed (one in ``TRACK_EVERY``), the row
and accumulator that each commit hands the PS are kept on the host, and
each later pull of such an id, and a read-back of all of them after the
window, has to give them back bit for bit (:class:`Held`).
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from harness import compare, weights
from harness.trace import Calls, Profile, Spans
from harness.traffic import Tokens
from reference import lm as ref
from reference.ps_init import LAUNCHER_SCALE, first_pull_rows

CHECK_STEPS = 3
TRACK_EVERY = 32  # one token id in this many is held to what was committed for it


class WindowClosed(Exception):
    """Raised by the feed where the first step after the window would start."""


class Held:
    """The row and accumulator last committed for each of a sample of token
    ids (one in ``every``, drawn from the seed), and how many pulls of them
    gave back something else."""

    def __init__(self, vocab: int, d: int, seed: int, every: int):
        rng = np.random.default_rng([int(seed), 0x9E1D])
        self.ids = np.sort(rng.choice(vocab, size=max(1, vocab // every), replace=False))
        self.pos = np.full(vocab, -1, dtype=np.int64)
        self.pos[self.ids] = np.arange(len(self.ids))
        self.rows = np.zeros((len(self.ids), d), dtype=np.float32)
        self.accs = np.zeros_like(self.rows)
        self.have = np.zeros(len(self.ids), dtype=bool)
        self.compared = self.differ = 0

    def _at(self, keys: np.ndarray):
        j = self.pos[keys.astype(np.int64)]
        at = np.nonzero(j >= 0)[0]
        return at, j[at]

    def pulled(self, keys: np.ndarray, rows: np.ndarray, accs: np.ndarray) -> None:
        """Compare what a pull gave for the held ids with what was committed."""
        at, j = self._at(keys)
        known = self.have[j]
        at, j = at[known], j[known]
        self.compared += len(j)
        self.differ += int((np.any(rows[at] != self.rows[j], axis=1)
                            | np.any(accs[at] != self.accs[j], axis=1)).sum())

    def committed(self, keys: np.ndarray, rows: np.ndarray, accs: np.ndarray) -> None:
        at, j = self._at(keys)
        self.rows[j], self.accs[j] = rows[at], accs[at]
        self.have[j] = True


def _ps_counts(cluster) -> dict:
    return dict(mem_misses=sum(n.mem.stats.misses for n in cluster.nodes),
                ssd_files_read=sum(n.ssd.stats.files_read for n in cluster.nodes))


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in ref.leaves(tree).items()}


def run(cell, seed: int, seconds: float, trace: bool, device, *, clock=None,
        faults=None) -> dict:
    """One run of a training cell -> what the metric readers and the result
    line take. ``clock()`` gives the seconds since the process started.
    ``faults`` (tests): ``step``: fn(step) -> step, applied to the step the
    launcher builds; ``ps``: fn(cluster), applied to the PS once it holds
    every row."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import train as launch
    from repro_torch.models import get_model
    from repro_torch.train.optim import AdamW
    from repro_torch.train.train_step import TrainSettings

    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    clock = clock or time.perf_counter
    mix, m, arch = cell.mix, cell.model(), cell.arch()
    B, S, micro, warm = int(mix["rows"]), int(mix["seq"]), int(mix["microbatches"]), int(mix["warm"])
    if warm < CHECK_STEPS + 1:
        raise ValueError("the warm steps must hold the three checked steps and the fourth")
    adamw = AdamW(lr=float(mix["lr"]))
    settings = TrainSettings(optimizer=adamw, microbatches=micro, remat=bool(mix["remat"]),
                             row_lr=float(mix["row_lr"]))

    flat = weights.make(m, seed, torch.float32, device)
    schema = {k: tuple(v.shape) for k, v in ref.leaves(get_model(arch).schema(arch)).items()}
    made = {k: tuple(v.shape) for k, v in flat.items()}
    if schema != made:
        raise RuntimeError(f"the benchmark's weights {made} are not the program's layout {schema}")
    init = [ref.unflatten(flat)]
    del flat

    spans, prof = Spans(), Profile()
    calls = Calls(kops, {"flash_attention_cuda": "flash_fwd",
                         "flash_attention_bwd_cuda": "flash_bwd"})
    tokens = Tokens(mix, m.vocab, seed, targets=True)
    held = Held(m.vocab, m.d, seed, TRACK_EVERY)
    st = dict(window=None, end=None, steps=0, batches=[], losses=[], client=None, peak_setup=0,
              marks=[])
    kept: dict = {}

    class Feed:
        """The launcher's token stream: the benchmark's batches, and the
        window's clock."""

        def __init__(self, vocab, batch, seq, seed=0):
            if (vocab, batch, seq) != (m.vocab, B, S):
                raise ValueError(f"the launcher asked for {(vocab, batch, seq)}")
            self.i = 0

        def next_batch(self):
            now = time.perf_counter()
            if self.i == warm:
                sync()
                st["setup_s"] = clock()
                if cuda:
                    st["peak_setup"] = torch.cuda.max_memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                spans.reset()
                if trace:
                    if cuda:
                        prof.start()
                    spans.marking = cuda
                    calls.on = True
                    spans.begin("window")
                st["ps_at_window"] = _ps_counts(st["client"].cluster)
                st["window"] = now = time.perf_counter()
            elif self.i > warm:
                st["marks"].append(now)
            if self.i > warm and now - st["window"] >= seconds:
                st["end"] = now
                st["steps"] = self.i - warm
                if trace:
                    calls.on = False
                    spans.end("window")
                    spans.marking = False
                    if cuda:
                        prof.stop()
                raise WindowClosed
            self.i += 1
            spans.begin("stream")
            toks = tokens.draw()
            spans.end("stream")
            if len(st["batches"]) < CHECK_STEPS:
                st["batches"].append(toks)
            return toks

    class Client(launch.PSClient):
        """The launcher's PS client, its pull and commit timed and held to
        what it was handed. Made, it pulls every row of the table once."""

        def __init__(self, cluster, tables, **kw):
            super().__init__(cluster, tables, **kw)
            st["client"] = self
            ids = np.arange(m.vocab, dtype=np.uint64)
            for lo in range(0, m.vocab, 8192):
                super().session("tok_emb", ids[lo:lo + 8192], read_only=True).abort()
            st["resident"] = sum(n.mem.n_cached for n in cluster.nodes)
            if faults and "ps" in faults:
                faults["ps"](cluster)

        def session(self, table, keys, **kw):
            if kw.get("read_only"):  # the harness's own read-backs
                return super().session(table, keys, **kw)
            spans.begin("pull")
            s = super().session(table, keys, **kw)
            spans.end("pull")
            held.pulled(s.raw_keys, s.params, s.opt_state)
            commit = s.commit

            def timed_commit(rows, accs, **k):
                spans.end("d2h")
                spans.begin("commit")
                held.committed(s.raw_keys, rows, accs)
                out = commit(rows, accs, **k)
                spans.end("commit")
                return out

            s.commit = timed_commit
            return s

    def hook(i, step, args):
        params, opt, batch, wt, acc = args
        if i == 1:  # step 1's gradient as AdamW received it: m_1 / (1 - b1)
            kept["grad1"] = {k: v / (1 - adamw.b1) for k, v in _norms(opt.m).items()}
            # and the gradient itself, kept on the host for the reference
            kept["grad1_host"] = {k: (v / (1 - adamw.b1)).cpu()
                                  for k, v in ref.leaves(opt.m).items()}
        if i == CHECK_STEPS:
            kept["change3"] = _change(params)
            kept.update(_read_back(st["client"], st["batches"], m.d))
        spans.begin("step")
        out = step(*args)
        sync()
        spans.end("step")
        if i < CHECK_STEPS:
            st["losses"].append(out[2]["loss"].detach())
        spans.begin("d2h")
        return out

    def _change(params) -> dict:
        p0 = weights.make(m, seed, torch.float32, device)
        now = ref.leaves(params)
        out = {k: float(torch.linalg.vector_norm(now[k].float() - p0[k])) for k in p0}
        del p0
        return out

    real = dict(TokenStream=launch.TokenStream, PSClient=launch.PSClient,
                make_lm_train_step_hier=launch.make_lm_train_step_hier)
    launch.TokenStream, launch.PSClient = Feed, Client
    if faults and "step" in faults:
        maker = real["make_lm_train_step_hier"]
        launch.make_lm_train_step_hier = lambda c, s: faults["step"](maker(c, s))
    if trace and cuda:
        calls.install()
    base = tempfile.mkdtemp(prefix="portbench_train_")
    try:
        try:
            launch.run(arch, settings, steps=10**9, batch=B, seq=S, nodes=int(mix["nodes"]),
                       base=base, ckpt_every=0, device=device, params=init.pop(),
                       step_hook=hook)
        except WindowClosed:
            pass
        window_s = st["end"] - st["window"]
        peak_window = torch.cuda.max_memory_allocated() if cuda else 0
        ps = {k: v - st["ps_at_window"][k]
              for k, v in _ps_counts(st["client"].cluster).items()}
        ps.update(resident_rows=st["resident"], pulls_compared=held.compared,
                  read_back=int(held.have.sum()))
        ps_rows = held.differ + _held_read_back(st["client"], held)
        out = dict(mode="train", setup_s=st["setup_s"], window_s=window_s, attempted=st["steps"],
                   failed=0, tokens=st["steps"] * B * S,
                   spans=dict(spans.total), span_counts=dict(spans.count),
                   peak_bytes=max(peak_window, st["peak_setup"]), peak_window_bytes=peak_window,
                   model=m, mix=mix)
        if trace:
            out["profile"] = prof.summary() if cuda else None
            out["calls"] = calls.timed() if cuda else []
        prog = dict(losses=[float(x) for x in st["losses"]], grad1=kept["grad1"],
                    change3=kept["change3"], ps_rows=ps_rows)
    finally:
        calls.uninstall()
        for k, v in real.items():
            setattr(launch, k, v)
        st["client"] = None
        shutil.rmtree(base, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference, once the program's state is gone
    r = reference(m, seed, st["batches"], mix, device, grad1_of=kept.pop("grad1_host"))
    rows0 = r.pop("rows0")
    prog["grad1_diff"] = r.pop("grad1_diff")
    prog["rows_change"] = float(np.linalg.norm(kept["rows"] - rows0))
    prog["accs_norm"] = float(np.linalg.norm(kept["accs"]))
    numbers, where = compare.train_numbers(prog, r)
    out["correct"], out["checks"] = compare.judge(numbers, cell.limits)
    out["where"] = dict(readings=numbers, worst=where, ps=ps,
                        tokens_per_s_by_third=_by_third(st["window"], st["marks"], B * S),
                        span_ms_by_third=spans.by_third(("pull", "step", "d2h", "commit")))
    return out


def _held_read_back(client, held: Held) -> int:
    """After the window: the held ids whose row or accumulator, read back
    from the PS, differs from what was last committed."""
    ids = held.ids[held.have]
    if not len(ids):
        return 0
    with client.session("tok_emb", ids.astype(np.uint64), read_only=True) as r:
        at, j = held._at(r.raw_keys)
        if len(at) != len(ids):
            return len(ids)
        return int((np.any(np.asarray(r.params)[at] != held.rows[j], axis=1)
                    | np.any(np.asarray(r.opt_state)[at] != held.accs[j], axis=1)).sum())


def _by_third(start: float, marks: list, tokens: int) -> list:
    """Tokens per second over each third of the window's steps (a step ends
    where the next one's batch is drawn)."""
    if len(marks) < 3:
        return []
    t = [start] + marks
    k = len(marks) // 3
    cuts = [0, k, 2 * k, len(marks)]
    return [tokens * (b - a) / (t[b] - t[a]) for a, b in zip(cuts, cuts[1:])]


def _read_back(client, batches: list, d: int) -> dict:
    """The rows and accumulators of every token of ``batches``, as the PS
    holds them now (sorted by token id)."""
    ids = np.unique(np.concatenate([b[:, :-1].reshape(-1) for b in batches])).astype(np.uint64)
    with client.session("tok_emb", ids, read_only=True) as r:
        order = np.argsort(r.raw_keys)
        if not np.array_equal(r.raw_keys[order], ids):
            raise RuntimeError("the PS read back other keys than asked")
        return {"rows": np.asarray(r.params)[order][:, :d].copy(),
                "accs": np.asarray(r.opt_state)[order][:, :d].copy()}


def reference(m: ref.Model, seed: int, batches: list, mix: dict, device, prec: str = "fp32",
              half_batch: bool = False, grad1_of=None, keep_grad1: bool = False) -> dict:
    """The first three steps in the plain reference: losses, the first
    clipped gradient's leaf norms, the leaves' change norms, and the token
    rows' change and accumulators. ``half_batch`` (a planted fault) leaves
    out the second half of each batch. ``grad1_of`` ({leaf: another side's
    first gradient}) adds ``grad1_diff``: {leaf: the norm of its difference
    from the reference's, over the reference's norm}; ``keep_grad1`` adds
    ``grad1_full``, this run's first gradient on the host."""
    ref.strict_fp32()
    adamw = ref.AdamW(lr=float(mix["lr"]))
    params = weights.make(m, seed, torch.float32, device)
    mo = {k: torch.zeros_like(v) for k, v in params.items()}
    vo = {k: torch.zeros_like(v) for k, v in params.items()}
    ids = np.unique(np.concatenate([b[:, :-1].reshape(-1) for b in batches]))
    rows0 = first_pull_rows(ids.astype(np.uint64), m.d, LAUNCHER_SCALE)
    table = torch.from_numpy(rows0).to(device, copy=True)
    accs = torch.zeros_like(table)
    losses, grad1 = [], None
    for t, toks in enumerate(batches, start=1):
        if half_batch:
            toks = toks[: toks.shape[0] // 2]
        inputs, targets = toks[:, :-1], toks[:, 1:]
        uniq, inv = np.unique(inputs, return_inverse=True)
        at = torch.from_numpy(np.searchsorted(ids, uniq)).to(device)
        slots = torch.from_numpy(inv.reshape(inputs.shape).astype(np.int64)).to(device)
        tg = torch.from_numpy(targets.astype(np.int64)).to(device)
        ce, grads, tgrad = ref.loss_and_grads(m, ref.unflatten(params), table[at], slots, tg,
                                              int(mix["microbatches"]), prec)
        losses.append(float(ce))
        clipped = adamw.step(t, params, grads, mo, vo)
        if t == 1:
            grad1 = {k: float(torch.linalg.vector_norm(v)) for k, v in clipped.items()}
            if grad1_of is not None:
                diff = {k: float(torch.linalg.vector_norm(grad1_of[k].to(device) - v))
                        / max(grad1[k], 1e-30) for k, v in clipped.items()}
            if keep_grad1:
                full = {k: v.cpu() for k, v in clipped.items()}
        del grads, clipped
        new_rows, new_acc = ref.adagrad(table[at], accs[at], tgrad, float(mix["row_lr"]))
        table[at], accs[at] = new_rows, new_acc
    del mo, vo
    p0 = weights.make(m, seed, torch.float32, device)
    change3 = {k: float(torch.linalg.vector_norm(params[k] - p0[k])) for k in p0}
    out = dict(losses=losses, grad1=grad1, change3=change3, rows0=rows0,
                rows_change=float(torch.linalg.vector_norm(table - torch.from_numpy(rows0).to(device))),
                accs_norm=float(torch.linalg.vector_norm(accs)))
    if grad1_of is not None:
        out["grad1_diff"] = diff
    if keep_grad1:
        out["grad1_full"] = full
    return out
