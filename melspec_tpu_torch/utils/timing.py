"""Frame/millisecond conversions and formatting (a copy of
``melspec_tpu.utils.timing``; reference ``src/vad.rs:580-602``), and the
device timer of the port's probes (``device_time_ms``)."""

from __future__ import annotations

import math
import statistics

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
