"""Frame/millisecond conversions and formatting (a copy of
``melspec_tpu.utils.timing``; reference ``src/vad.rs:580-602``), and the
device timers of the port's probes (``device_time_ms`` for one call,
``per_launch_ms`` for a kernel's time per launch)."""

from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch


def n_frames_for_duration(
    hop_size: int, sampling_rate: float, duration_ms: int
) -> int:
    """FFT frames needed to cover ``duration_ms`` (reference computes the
    frame duration in f32 then takes ``ceil`` — ``src/vad.rs:580-584``)."""
    frame_duration = (np.float32(hop_size) / np.float32(sampling_rate)
                      * np.float32(1000.0))
    return int(math.ceil(np.float32(duration_ms) / frame_duration))


def duration_ms_for_n_frames(
    hop_size: int, sampling_rate: float, total_frames: int
) -> int:
    """Milliseconds represented by ``total_frames`` (truncating, like the
    reference's ``as usize`` cast — ``src/vad.rs:587-590``)."""
    frame_duration = hop_size / sampling_rate * 1000.0
    return int(total_frames * frame_duration)


def format_milliseconds(milliseconds: int) -> str:
    """``HH:MM:SS.mmm`` (reference ``src/vad.rs:593-602``)."""
    total_seconds = milliseconds // 1000
    ms = milliseconds % 1000
    seconds = total_seconds % 60
    total_minutes = total_seconds // 60
    minutes = total_minutes % 60
    hours = total_minutes // 60
    return f"{hours:02d}:{minutes:02d}:{seconds:02d}.{ms:03d}"


def device_time_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over ``reps`` runs of one call's device time in ms (CUDA
    events on the current stream), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def per_launch_ms(fn, launches: int = 200, reps: int = 5,
                  warmup: int = 20) -> float:
    """A kernel's device time per launch: the median over ``reps`` of
    CUDA events around ``launches`` calls of ``fn`` back to back, divided
    by ``launches``, after ``warmup`` calls. A spin on the device
    (``torch.cuda._sleep``, twice as long as the host takes to issue the
    calls) runs ahead of each run, so the calls queue up behind it and
    run back to back: the interval holds the kernels and the gaps between
    them, not the host's time per call, which one call's events enclose
    when the device work is shorter than the host path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    spin = 1 << 20
    e0.record()
    torch.cuda._sleep(spin)
    e1.record()
    torch.cuda.synchronize()
    cycles = int(2 * host_ms / e0.elapsed_time(e1) * spin) + spin
    times = []
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)
