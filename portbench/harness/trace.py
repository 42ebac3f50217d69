"""What a run records besides its end-to-end clock: host spans around the
calls into each layer, CUDA-event timings of the kernels' entry points, and
in a traced run the profiler's device timeline.

Spans (``Spans``): named host intervals (``stream``, ``pull``, ``step``,
``d2h``, ``commit``, ``lookup``, ``prefill``, ``sample``), summed per name
on the host clock, and, while the profiler runs, also marked in its trace
(``record_function("pb.<name>")``) so that idle device time can be put
down to what the host was doing.

Calls (``Calls``): the entry points of the port's kernels, wrapped from
here (``kernels.ops``' ``flash_attention_cuda`` and
``flash_attention_bwd_cuda``): each call's shapes, and a
CUDA event before and after it in the stream. The time between the two is
the device time of every kernel that call launched (and of any gap between
them), whatever kernels a later version launches.

Profile: ``torch.profiler`` over the window, read from its raw events:
busy seconds (the union of device activity), the device operations that
took longest, and the idle gaps summed by the host span they fall in.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch


class Spans:
    def __init__(self):
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.each = defaultdict(list)  # every span's seconds, in order
        self.marking = False
        self._open = {}

    def begin(self, name: str) -> None:
        rf = None
        if self.marking:
            rf = torch.autograd.profiler.record_function(f"pb.{name}")
            rf.__enter__()
        self._open[name] = (time.perf_counter(), rf)

    def end(self, name: str) -> float:
        t0, rf = self._open.pop(name)
        dt = time.perf_counter() - t0
        if rf is not None:
            rf.__exit__(None, None, None)
        self.total[name] += dt
        self.count[name] += 1
        self.each[name].append(dt)
        return dt

    def reset(self) -> None:
        self.total.clear()
        self.count.clear()
        self.each.clear()

    def by_third(self, names) -> dict:
        """{name: mean ms of its spans in each third of them, in order}."""
        out = {}
        for name in names:
            v, k = self.each.get(name, []), len(self.each.get(name, [])) // 3
            if k:
                out[name] = [1e3 * sum(v[i * k:(i + 1) * k]) / k for i in range(3)]
        return out


class Calls:
    """Wraps ``module``'s ``names`` while ``on``; ``records`` holds
    ``(op, shapes, start event, end event)``."""

    def __init__(self, module, names: dict):
        self.module, self.names = module, names  # {attribute: op label}
        self.records = []
        self.on = False
        self._real = {}

    def install(self) -> None:
        for attr, op in self.names.items():
            real = self._real[attr] = getattr(self.module, attr)
            setattr(self.module, attr, self._wrap(real, op))

    def uninstall(self) -> None:
        for attr, real in self._real.items():
            setattr(self.module, attr, real)
        self._real.clear()

    def _wrap(self, real, op):
        def call(*args, **kw):
            if not self.on:
                return real(*args, **kw)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = real(*args, **kw)
            b.record()
            self.records.append((op, _shapes(op, args, kw), a, b))
            return out

        return call

    def timed(self) -> list[dict]:
        """Every recorded call with its device milliseconds (synchronises)."""
        torch.cuda.synchronize()
        return [dict(op=op, ms=a.elapsed_time(b), **shapes)
                for op, shapes, a, b in self.records]


def _shapes(op: str, args, kw) -> dict:
    """What ``counts/<op>.py`` takes, from a call's arguments."""
    if op in ("flash_fwd", "flash_bwd"):
        q, k = args[0], args[1]
        return dict(q=tuple(q.shape), kv=tuple(k.shape), causal=bool(kw.get("causal", True)),
                    window=int(kw.get("window", 0)), elem=q.element_size(),
                    lse=bool(kw.get("return_lse", False)))
    raise ValueError(op)


class Profile:
    """torch.profiler from :meth:`start` to :meth:`stop`."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summary(self, top: int = 10) -> dict:
        """:func:`summarize` of this profile's raw events."""
        from torch.autograd import DeviceType

        window, spans, dev = None, [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if name.startswith("pb."):
                    iv = (e.start_ns(), e.start_ns() + e.duration_ns(), name[3:])
                    if name == "pb.window":
                        window = iv
                    else:
                        spans.append(iv)
            elif not (e.is_user_annotation() or e.name().startswith("pb.")):
                # the spans' own marks on the device timeline are not work
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        if window is None:
            raise RuntimeError("the profile holds no window span")
        return summarize(window[:2], spans, dev, top)


def summarize(window: tuple, spans: list, dev: list, top: int = 10) -> dict:
    """Over the window (start, end) in ns: busy seconds (the union of the
    device intervals ``dev`` [(start, end, name)]), the ``top`` device
    operations by seconds, and the idle gaps' seconds summed by the host
    span [(start, end, name)] that holds each gap's middle."""
    lo, hi = window
    by_op = defaultdict(float)
    ivs = []
    for a, b, name in dev:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ivs.append((a, b))
            by_op[name] += (b - a) / 1e9
    ivs.sort()
    busy, gaps, edge = 0, [], lo
    for a, b in ivs:
        if a > edge:
            gaps.append((edge, a))
        busy += max(0, b - max(a, edge))
        edge = max(edge, b)
    if hi > edge:
        gaps.append((edge, hi))
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][2] if i >= 0 and spans[i][1] >= mid else "between spans"
        idle[name] += (b - a) / 1e9
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy / 1e9, window_s=(hi - lo) / 1e9, device_ops=[list(o) for o in ops],
                idle_gaps=[list(g) for g in gaps_by])
