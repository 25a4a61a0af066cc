"""Timing and profiling harness (port of ``melspec_tpu.utils.profiling``).

- ``Timer``: wall-clock context manager; ``t.block_on(result)`` waits for
  the CUDA devices that hold the result's tensors (PyTorch returns before
  the device finishes, so the bare exit time measures submission) and
  re-stamps ``seconds``; CPU tensors need no wait;
- ``benchmark(fn, *args)``: warm-up + timed iterations -> mean seconds per
  call, device-synchronized;
- ``rtfx(audio_seconds, wall_seconds)``: the realtime factor;
- ``trace(log_dir)``: a ``torch.profiler`` capture (CPU, and CUDA where
  available) that writes a Chrome trace into ``log_dir`` (view it in
  Perfetto or TensorBoard);
- ``span(name, device=None, **attrs)``: a span of the port's own, kept in
  memory (``records()``, ``summary()``, ``clear()``), on while
  ``enable()`` is in force or a ``torch.profiler`` capture is recording;
  ``stages(device)`` times consecutive stages that share their boundary
  events; ``counters()`` snapshots the kernels' launch counters.

The spans stamp ``time.time_ns()``, the clock of ``torch.profiler``'s
events, so a span can be placed against a capture's operations with no
conversion. With a CUDA ``device`` a span also records two timing events
on the current stream, read only when the records are (after the caller
has synchronised). They never open ``torch.profiler.record_function``: a
profiler would write such a range onto the device timeline, where it
would read as device work. Spans named ``setup.*`` (the host-built heads,
the kernels' libraries, the routes chosen at set-up) are recorded
whether or not tracing is on, apart from the bounded ring of the rest.

``melspec_tpu.utils.compile_cache`` (JAX's persistent compilation cache)
has no counterpart: PyTorch's eager kernels are not compiled per shape,
and the port's CUDA kernels are cached by source digest under ``_build/``
(``kernels/build.py``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import sys
import threading
import time
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def _block_until_ready(value: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``value``
    (nested tuples, lists and dicts); CPU tensors need no wait."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _block_until_ready(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _block_until_ready(v)


class Timer:
    """``with Timer() as t: y = f(x); t.block_on(y)`` -> ``t.seconds``.

    The context exit alone records the wall time of the Python block;
    pass device results through ``block_on``, which waits for them and
    re-stamps ``seconds``."""

    def __enter__(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.seconds = time.perf_counter() - self._start

    def block_on(self, value: Any) -> Any:
        _block_until_ready(value)
        self.seconds = time.perf_counter() - self._start
        return value


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 2
              ) -> float:
    """Mean wall seconds per call after warm-up (device-synchronized)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _block_until_ready(out)
    start = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _block_until_ready(out)
    return (time.perf_counter() - start) / iters


def rtfx(audio_seconds: float, wall_seconds: float) -> float:
    """Realtime factor: seconds of audio processed per wall second."""
    return audio_seconds / wall_seconds if wall_seconds else 0.0


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block: ``with trace('out/trace') as prof: run()``.
    Writes ``<host>_<pid>.<ms>.pt.trace.json`` into ``log_dir`` when the
    block ends; ``prof.key_averages()`` gives the times by kernel name."""
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities, acc_events=True,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


# -- the port's spans ------------------------------------------------------

RING = 65_536        # hot-path records kept; the oldest go first
SETUP_KEEP = 4_096   # set-up records kept, apart from the ring
POOL_MAX = 4_096     # timing events kept for reuse, per device
SETUP = "setup."

# the kernels' launch counters, as (module of kernels/, attribute): read
# where they live, never moved
COUNTERS = (("sig_mel", "launches"), ("sig_mel", "factored_launches"),
            ("sig_mel", "fft_launches"), ("sig_mel", "pipelined_launches"),
            ("sig_mel", "magnitude_launches"),
            ("sig_mel", "epilogue_launches"),
            ("sig_multi", "launches"), ("sig_multi", "pipelined_launches"),
            ("resample", "launches"),
            ("framed_mel", "launches"), ("load_probe", "launches"))
_KERNELS = "melspec_tpu_torch.kernels."


class Record:
    """One span: ``name``; ``id``; ``parent``, the id of the span it
    opened under (None at the top); ``call``, the id of the top-level span
    it lies under (its own at the top), shared by every span of one call;
    ``thread``; ``start_ns`` / ``end_ns`` on ``time.time_ns()``;
    ``attrs``; and ``device_ms``, the device time between its two events
    (None without a CUDA device, or while its end event has not completed
    when the records are read)."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns",
                 "end_ns", "attrs", "device_ms", "_events")

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _State:
    """The process's records: the bounded ring of hot-path spans, the
    set-up spans apart, the open spans and the timing events to reuse."""

    def __init__(self):
        self.on = False
        self.ring = collections.deque(maxlen=RING)
        self.setup = collections.deque(maxlen=SETUP_KEEP)
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.open = set()          # ids of the spans entered, not left
        self.spent = []            # events read, not yet back in a pool
        self.pools = collections.defaultdict(list)


_state = _State()


def enable() -> None:
    """Record spans until ``disable()`` (a running ``torch.profiler``
    capture turns them on too)."""
    _state.on = True


def disable() -> None:
    _state.on = False


def _k1_k2() -> tuple:
    """K1's and K2's launch counts so far (0 for a kernel module not
    loaded yet)."""
    mods = sys.modules
    k1 = mods.get(_KERNELS + "sig_mel")
    k2 = mods.get(_KERNELS + "sig_multi")
    return (k1.launches if k1 else 0), (k2.launches if k2 else 0)


def _timed_event(device: torch.device) -> torch.cuda.Event:
    """A timing event recorded now on ``device``'s current stream, from
    the device's pool where it holds one."""
    pool = _state.pools[device.index]
    e = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    e.record(torch.cuda.current_stream(device))
    return e


class _NullSpan:
    """What ``span`` returns while tracing is off: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, name: str, **attrs) -> "_NullSpan":
        return self

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("rec", "device", "chain", "k0", "e0")

    def set(self, **attrs) -> None:
        """Add ``attrs`` to the record (a result known only inside the
        block)."""
        self.rec.attrs.update(attrs)

    def __init__(self, name: str, device, attrs: dict, chain=None):
        r = Record()
        r.name, r.attrs, r.device_ms, r._events = name, attrs, None, None
        self.rec = r
        dev = None if device is None else torch.device(device)
        if dev is not None and dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self.chain = chain

    def __enter__(self) -> "_Span":
        r = self.rec
        stack = getattr(_state.local, "stack", None)
        if stack is None:
            stack = _state.local.stack = []
        r.id = next(_state.ids)
        parent = stack[-1] if stack else None
        r.parent = parent.id if parent else None
        r.call = parent.call if parent else r.id
        r.thread = threading.get_ident()
        self.k0 = None if parent else _k1_k2()
        stack.append(r)
        _state.open.add(r.id)
        r.start_ns = time.time_ns()
        if self.device is not None:
            # a stage starts where the one before it ended, unless that
            # record was read (its events gone back to the pool)
            last = self.chain.last if self.chain is not None else None
            self.e0 = (last._events[1] if last is not None
                       and last._events is not None
                       else _timed_event(self.device))
        return self

    def __exit__(self, *exc) -> bool:
        r = self.rec
        if self.device is not None:
            r._events = (self.e0, _timed_event(self.device))
            if self.chain is not None:
                self.chain.last = r
        r.end_ns = time.time_ns()
        if self.k0 is not None:
            k1, k2 = _k1_k2()
            r.attrs["k1_launches"] = k1 - self.k0[0]
            r.attrs["k2_launches"] = k2 - self.k0[1]
        _state.local.stack.pop()
        _state.open.discard(r.id)
        (_state.setup if r.name.startswith(SETUP) else _state.ring).append(r)
        return False


def span(name: str, device=None, **attrs):
    """``with span("frontend_step", device): ...`` records the block as a
    ``Record`` while ``enable()`` is in force or a ``torch.profiler``
    capture is recording, with two timing events where ``device`` is a
    CUDA device; otherwise it returns one shared no-op object and records
    nothing. Spans named ``setup.*`` are recorded whatever the state,
    apart from the ring. A top-level span also records the K1 and K2
    launches made inside it (``k1_launches``, ``k2_launches`` in its
    attrs)."""
    if _state.on or _autograd_profiler._is_profiler_enabled:
        return _Span(name, device, attrs)
    if name.startswith(SETUP):
        return _Span(name, None, attrs)
    return _NULL


class _Stages:
    __slots__ = ("device", "last")

    def __init__(self, device):
        self.device = device
        self.last = None

    def __call__(self, name: str, **attrs) -> _Span:
        return _Span(name, self.device, attrs, self)


def stages(device=None):
    """Consecutive stages of one step: ``stage = stages(device)``, then
    ``with stage("step.a"): ...`` and ``with stage("step.b"): ...``; each
    stage's end event is the next one's start event, so the stages' device
    times tile the stretch from the first stage's start to the last
    one's end. Off, the shared no-op."""
    if _state.on or _autograd_profiler._is_profiler_enabled:
        return _Stages(device)
    return _NULL


def spanned(name: str, **attrs) -> Callable:
    """Decorator: each call of the function runs inside ``span(name,
    **attrs)``; under ``functools.lru_cache`` only a cache miss does."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, **dict(attrs)):
                return fn(*args, **kwargs)

        return call

    return wrap


def records() -> list:
    """Every kept ``Record``, set-up and ring together, by start. Reads
    the device time of each record whose end event has completed, so read
    after synchronising the device; a record whose event has not
    completed keeps ``device_ms`` None until a later read."""
    recs = sorted([*_state.setup, *_state.ring], key=lambda r: r.start_ns)
    for r in recs:
        if r._events is not None and r._events[1].query():
            r.device_ms = r._events[0].elapsed_time(r._events[1])
            _state.spent.extend(r._events)
            r._events = None
    if not _state.open:
        # an event goes back to its pool once no record or open span can
        # still read it
        held = {id(e) for r in recs if r._events for e in r._events}
        seen = set()
        for e in _state.spent:
            if id(e) not in held and id(e) not in seen:
                seen.add(id(e))
                pool = _state.pools[e.device.index]
                if len(pool) < POOL_MAX:
                    pool.append(e)
        _state.spent = []
    return recs


def clear() -> None:
    """Drop every record (set-up ones too)."""
    _state.ring.clear()
    _state.setup.clear()
    _state.spent = []


def summary(recs: Optional[list] = None) -> dict:
    """For each span name (of ``recs``, default ``records()``):
    ``count``, ``host_ms`` (total), ``self_ms`` (total host time less what
    the span's children cover) and ``device_ms`` (total over the records
    that have one; None where none has)."""
    recs = records() if recs is None else recs
    covered = collections.Counter()
    for r in recs:
        if r.parent is not None:
            covered[r.parent] += r.end_ns - r.start_ns
    out = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0,
                                    "self_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["host_ms"] += r.host_ms
        s["self_ms"] += (r.end_ns - r.start_ns - covered[r.id]) / 1e6
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
    return out


def counters() -> dict:
    """The kernels' launch counters as they stand, read where they live
    (``kernels/sig_mel.py::launches``, ...), as ``{"sig_mel.launches":
    n, "sig_mel.epilogue_launches.vad": n, "resample.launches.K4": n,
    ...}``."""
    import importlib

    out = {}
    for mod, attr in COUNTERS:
        value = getattr(importlib.import_module(_KERNELS + mod), attr)
        if isinstance(value, dict):
            out.update({f"{mod}.{attr}.{k}": v for k, v in value.items()})
        else:
            out[f"{mod}.{attr}"] = value
    return out
