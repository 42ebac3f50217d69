"""Op-level cost analysis of one rank's step traced on the ``meta`` device.

The port's counterpart of the reference's ``launch/hlo_analysis.py``. The
reference walks XLA's optimized HLO text; PyTorch runs eagerly and has no
HLO, so :class:`OpCounter` counts the step as it runs, op by op, under a
``TorchDispatchMode`` over meta tensors (no data, no device):

  * **matmul FLOPs** — ``torch.utils.flop_counter``'s formulas for every
    mm/bmm/addmm/baddbmm/convolution/attention op (einsum and matmul
    reach these), plus ``aten._grouped_mm``; kept by the dtype they run
    in;
  * **HBM bytes** — every op that is not a view or an allocation reads its
    tensor inputs and writes its outputs once: eager PyTorch fuses
    nothing, so op level is what the card does;
  * **peak live bytes** — every storage the step holds (its arguments
    included) is tracked by weak reference from the op that made it to its
    release, as ``torch.distributed._tools.mem_tracker`` does;
  * **kernel calls** — each of the port's kernels reports its own FLOPs
    and bytes from its meta stand-in (``kernels/meta.py``): counted once,
    as the kernel, not as the ops of its plain version;
  * **collectives** — each call on a ``collectives.DryGroup``: kind,
    operand bytes, group and call site.

Trip counts are not needed: Python loops run, every iteration is counted.
"""

from __future__ import annotations

import sys
import time
import weakref
from collections import Counter, defaultdict
from pathlib import Path

import torch
import torch.utils.flop_counter as fc
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import collectives as coll
from repro_torch.kernels import meta as kmeta

aten = torch.ops.aten

# ops that move no data: views and aliases, allocations, metadata
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
               aten._unsafe_view.default}


def _grouped_mm_flops(a, b, *args, **kwargs) -> int:
    """``torch._grouped_mm``: every row (or, for two 2-D operands, every
    contracted index) meets one group's weights."""
    if a.dim() == 2 and b.dim() == 2:
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if a.dim() == 2:  # [T, K] x [E, K, N], rows grouped
        return 2 * a.shape[0] * a.shape[1] * b.shape[2]
    if b.dim() == 2:  # [E, M, K] x [K, N]
        return 2 * a.numel() * b.shape[1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


_EXTRA_FLOPS = {aten._grouped_mm: _grouped_mm_flops}


def _tensors(tree) -> list:
    """The tensors of an op's arguments or outputs (nested in lists, tuples
    and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _key_of(x):
    """A hashable key of an op argument: a tensor by its metadata."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key_of(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key_of(v)) for k, v in x.items())
    return x


def _functional(func) -> bool:
    """Whether ``func`` returns new tensors only: not a view, no argument
    written, no output aliasing an argument."""
    sch = func._schema
    return not (func.is_view or sch.is_mutable
                or any(r.alias_info is not None for r in sch.returns))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_PORT = str(Path(__file__).resolve().parents[1])


def _site(func) -> str:
    """Where an op comes from: under the backward the autograd node that
    runs it, else the innermost frame of the port's own code."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"{func.__name__} in {node.name()}"
    f = sys._getframe(2)
    while f is not None and not f.f_code.co_filename.startswith(_PORT):
        f = f.f_back
    if f is None:
        return func.__name__
    path = f.f_code.co_filename[len(_PORT) + 1:]
    return f"{func.__name__} at {path}:{f.f_lineno}"


class OpCounter(TorchDispatchMode):
    """Counts what runs inside ``with OpCounter() as c:`` (see the module's
    docstring). :meth:`track` adds tensors that exist before the block
    (the step's arguments) to the live bytes."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict[torch.dtype, float] = defaultdict(float)
        self.hbm_bytes = 0.0
        self.kernels: dict[str, dict] = {}
        self.collectives: list[coll.Collective] = []
        self.site_bytes: Counter = Counter()
        self.site_flops: Counter = Counter()
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()
        self._t0 = 0.0
        self.seconds = 0.0
        self._functional: dict = {}
        self._outputs: dict = {}

    # ---- live storages
    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def track(self, tree) -> int:
        """Count every storage of ``tree``'s tensors not yet counted as
        live; returns the bytes added."""
        added = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            added += n
        self.live_bytes += added
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return added

    # ---- the recorders of kernels and collectives
    def _kernel(self, call: kmeta.KernelCall) -> None:
        k = self.kernels.setdefault(call.name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += call.flops
        k["bytes"] += call.nbytes
        self.flops_by_dtype[call.dtype] += call.flops
        self.hbm_bytes += call.nbytes
        site = f"kernel {call.name}"
        self.site_bytes[site] += call.nbytes
        self.site_flops[site] += call.flops

    def __enter__(self):
        kmeta.set_sink(self._kernel)
        coll.set_recorder(self.collectives.append)
        self._t0 = time.perf_counter()
        return super().__enter__()

    def __exit__(self, *exc):
        self.seconds += time.perf_counter() - self._t0
        kmeta.set_sink(None)
        coll.set_recorder(None)
        return super().__exit__(*exc)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``. A functional op on meta tensors runs once
        per distinct metadata of its arguments: its outputs' metadata is a
        function of theirs, so later calls make empty outputs of the same
        shapes, strides and dtypes without running PyTorch's (often Python)
        meta function again."""
        functional = self._functional.get(func)
        if functional is None:
            functional = self._functional[func] = _functional(func)
        if not functional:
            return func(*args, **kwargs)
        try:
            key = (func, _key_of(args), _key_of(kwargs))
            hash(key)
        except TypeError:
            return func(*args, **kwargs)
        spec = self._outputs.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            ts = [out] if isinstance(out, torch.Tensor) else list(out) if isinstance(
                out, (list, tuple)) else None
            if ts and all(isinstance(t, torch.Tensor) and t.is_meta for t in ts):
                self._outputs[key] = (type(out), [(t.shape, t.stride(), t.dtype) for t in ts])
            return out
        kind, metas = spec
        ts = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
              for shape, stride, dtype in metas]
        return ts[0] if kind is torch.Tensor else kind(ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        self.n_ops += 1
        outs = _tensors(out)
        self.track(outs)
        if func in _NO_TRAFFIC or func.is_view:
            return out
        packet = func._overloadpacket
        flops = 0
        if packet in fc.flop_registry:
            flops = fc.flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in _EXTRA_FLOPS:
            flops = _EXTRA_FLOPS[packet](*args, **kwargs)
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
        self.hbm_bytes += nbytes
        site = _site(func)
        self.site_bytes[site] += nbytes
        if flops:
            ins = _tensors(args)
            self.flops_by_dtype[ins[0].dtype if ins else torch.float32] += flops
            self.site_flops[site] += flops
        return out

    # ---- results
    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def collective_stats(self) -> tuple[dict, dict, dict]:
        """(calls by kind, operand bytes by kind, link bytes by mesh axis):
        the link bytes are what a ring moves out of each rank — an
        all_reduce 2 (n - 1) / n of its operand, a reduce_scatter (n - 1) / n
        of it, an all_gather or gather (n - 1) times this rank's part — and
        a group of one moves none."""
        factors = {"all_reduce": lambda n: 2 * (n - 1) / n, "reduce_scatter": lambda n: (n - 1) / n}
        counts, nbytes, link = Counter(), Counter(), Counter()
        for c in self.collectives:
            counts[c.kind] += 1
            nbytes[c.kind] += c.nbytes
            n = c.group.size
            factor = factors.get(c.kind, lambda n: n - 1)(n)
            link[c.group.axis] += c.nbytes * factor
        return dict(counts), dict(nbytes), dict(link)

    def collectives_by_site(self) -> dict:
        """{(kind, axis, site): [calls, operand bytes]}."""
        out: dict = {}
        for c in self.collectives:
            e = out.setdefault((c.kind, c.group.axis, c.site), [0, 0])
            e[0] += 1
            e[1] += c.nbytes
        return out

    def top_bytes(self, n: int = 14) -> list:
        return self.site_bytes.most_common(n)

    def top_flops(self, n: int = 8) -> list:
        return self.site_flops.most_common(n)

    def kernel_calls(self) -> dict[str, int]:
        return {k: v["calls"] for k, v in sorted(self.kernels.items())}
