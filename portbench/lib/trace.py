"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
first ``trace_seconds`` of the window, the benchmark's own spans as
``record_function`` annotations named ``portbench.<span>``, and what the
per-layer readers see of it (``TraceView``). Nothing is written to disk:
the device operations are read from the profiler's results in memory.

The traced part starts and ends with ``torch.cuda.synchronize()``, so
every operation of the calls issued inside it ends inside it."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from portbench.lib.device import sync

PREFIX = "portbench."


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(e, f"{what}_us")()
                                              * 1000)


@dataclasses.dataclass
class TraceView:
    """What a per-layer reader reads: the device's operations and the
    benchmark's spans inside the traced window (trace clock, ns), the
    calls issued inside it, the program's launch counters over
    it, and the shapes of the kernels' launches that the entry states."""

    window: tuple
    ops: list          # (name, start, end) device operations
    spans: list        # (name, start, end) benchmark spans, host side
    units: int
    counters: dict
    shapes: dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self, ops=None) -> float:
        """Seconds in which at least one of ``ops`` (default: every device
        operation) ran."""
        ivs = sorted((s, e) for _, s, e in (self.ops if ops is None
                                            else ops))
        total, end = 0, None
        for s, e in ivs:
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def matching(self, names) -> list:
        return [o for o in self.ops if any(n in o[0] for n in names)]

    def idle_gaps(self) -> list:
        """``(start, end)`` of every stretch of the window with no device
        operation running."""
        gaps, t = [], self.window[0]
        for s, e in sorted((s, e) for _, s, e in self.ops):
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window[1]:
            gaps.append((t, self.window[1]))
        return gaps

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the idle time
        by the span the host was in at each gap's middle."""
        by_op = {}
        for n, s, e in self.ops:
            by_op[n[:96]] = by_op.get(n[:96], 0.0) + (e - s) / 1e9
        by_span = {}
        for s, e in self.idle_gaps():
            mid = (s + e) / 2
            inner = [sp for sp in self.spans if sp[1] <= mid < sp[2]]
            name = (min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner
                    else "outside-spans")
            by_span[name] = by_span.get(name, 0.0) + (e - s) / 1e9
        top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                               key=lambda kv: -kv[1])[:10]
        return {"device_ops": top(by_op), "idle_gaps": top(by_span)}


class Tracer:
    """``span(name)`` marks host work; ``begin()`` / ``end(units)``
    bracket the traced part. With ``enabled=False`` every call is free."""

    def __init__(self, enabled: bool, seconds: float, counters, shapes,
                 device: torch.device):
        self.enabled = enabled
        self.device = device
        self.seconds = seconds
        self._counters = counters
        self._shapes = shapes
        self._prof = None
        self._window = None
        self.view = None
        self.active = False

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(PREFIX + name)
        return contextlib.nullcontext()

    def begin(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        self._c0 = dict(self._counters())
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.device.type == "cuda"
                                         else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(PREFIX + "window")
        self._window.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def due(self) -> bool:
        return self.active and time.perf_counter() - self.t0 >= self.seconds

    def end(self, units: int) -> None:
        if not self.active:
            return
        sync(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        c1 = self._counters()
        counters = {k: c1[k] - self._c0.get(k, 0) for k in c1}
        self.view = self._read(units, counters)

    def _read(self, units: int, counters: dict) -> TraceView:
        from torch.autograd import DeviceType

        events = self._prof.profiler.kineto_results.events()
        window, ops, spans = None, [], []
        for e in events:
            name = e.name()
            s = _ns(e, "start")
            end = s + _ns(e, "duration")
            if e.device_type() == DeviceType.CPU:
                if name == PREFIX + "window":
                    window = (s, end)
                elif name.startswith(PREFIX):
                    spans.append((name[len(PREFIX):], s, end))
            elif not name.startswith(PREFIX) and end > s:
                ops.append((name, s, end))
        if window is None:
            raise RuntimeError("the traced window's span is not in the trace")
        ops = [(n, max(s, window[0]), min(e, window[1])) for n, s, e in ops
               if e > window[0] and s < window[1]]
        return TraceView(window, ops, spans, units, counters, self._shapes)
