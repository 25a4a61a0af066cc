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
  Perfetto or TensorBoard).

``melspec_tpu.utils.compile_cache`` (JAX's persistent compilation cache)
has no counterpart: PyTorch's eager kernels are not compiled per shape,
and the port's CUDA kernels are cached by source digest under ``_build/``
(``kernels/build.py``).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable

import torch


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
