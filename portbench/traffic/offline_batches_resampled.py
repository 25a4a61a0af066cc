"""Offline batches at a rate that is no whole multiple of the speech
tape's: the closed loop of ``offline_batches.py`` (its ``drive``: one
caller issues call after call back to back, the window opens and closes
with ``torch.cuda.synchronize()``), over a ring whose ``recorded`` speech
is the tape resampled to the cell's ``sample_rate`` (22.05 kHz, say) by
``resampled``; ``speechlike`` noise as ``lib/signals.py`` makes it.

Parameters and end-to-end metric: those of ``offline_batches.py``.
``TINY``: 4 clips of 2 s, where ``offline_batches.py`` takes 2 of 1 s: the
checked speech then holds a near-silent stretch, where the mel sits near
the clamp guard and a precision below float32 fails first (the TF32
control reads 2.2 there on the CPU, and 2.05 or more in every full run on
the card, against 0.02 at 2 x 1 s)."""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.lib.device import sync
from portbench.lib.registry import load_module
from portbench.lib.signals import generator, speechlike, tape

_BASE = load_module("traffic", "offline_batches")
TINY = {"batch": 4, "clip_seconds": 2.0, "trace_seconds": 0.2}
drive = _BASE.drive


@functools.lru_cache(maxsize=4)
def resampled(file: str, rate: float, device: torch.device) -> torch.Tensor:
    """The tape ``file`` at ``rate`` (at least the tape's own), float32 on
    the CPU, worked out once a process on ``device``: band-limited
    periodic interpolation in float64, as ``signals.upsampled`` does for
    whole multiples: the tape's rFFT zero-padded to ``m = round(n rate /
    tape_rate)`` points and inverted, times ``m / n`` (the tape is read
    round its end, so it is periodic). Every bin above the tape's Nyquist
    frequency is empty. Kept on the host, so that the window's memory peak
    holds no tape."""
    samples, tape_rate = tape(file)
    if rate < tape_rate:
        raise ValueError(f"{file} holds {tape_rate} Hz audio; resampled "
                         f"plays it at that rate or above, not {rate} Hz")
    src = torch.as_tensor(samples, device=device).to(torch.float64) / 32768.0
    n = src.numel()
    m = int(round(n * rate / tape_rate))
    spec = torch.fft.rfft(src)
    if n % 2 == 0 and m > n:
        # the tape's Nyquist bin stands for +n/2 and -n/2 alike; at m
        # points they are two bins, each holding half
        spec[-1] *= 0.5
    return (torch.fft.irfft(spec, n=m) * (m / n)).to(torch.float32).cpu()


def recorded(g: torch.Generator, streams: int, n: int, rate: float,
             device: torch.device, file: str, gain_db: list,
             block: int = 16) -> torch.Tensor:
    """``[streams, n]`` float32 on ``device``: clips of the tape ``file``
    at ``rate`` (``resampled``) from seeded starts, scaled by a seeded
    gain, uniform in decibels over ``gain_db`` (``signals.recorded``'s
    draws, on the resampled tape)."""
    src = resampled(file, float(rate), device).to(device)
    start = torch.randint(0, src.numel(), (streams, 1), generator=g,
                          device=device)
    lo, hi = gain_db
    gain = 10.0 ** ((lo + (hi - lo) * torch.rand(
        (streams, 1), generator=g, device=device, dtype=torch.float64)) / 20)
    t = torch.arange(n, device=device)
    x = torch.empty((streams, n), device=device, dtype=torch.float32)
    for s in range(0, streams, block):
        idx = torch.remainder(start[s : s + block] + t[None, :], src.numel())
        x[s : s + block] = src[idx] * gain[s : s + block].to(torch.float32)
    return x


SIGNALS = {"speechlike": speechlike, "recorded": recorded}


def make(g: torch.Generator, spec: dict, streams: int, n: int, rate: float,
         device: torch.device) -> torch.Tensor:
    """The signal that ring entry ``spec`` names, ``[streams, n]``."""
    kw = {k: v for k, v in spec.items() if k != "signal"}
    return SIGNALS[spec["signal"]](g, streams, n, rate, device, **kw)


def prepare(sut, run) -> dict:
    """``offline_batches.prepare`` with this module's signals: the ring
    made on the device from the seed, every batch called once (warm), and
    the early calls to keep drawn from the seed."""
    p = run.params
    n = int(round(p["clip_seconds"] * p["sample_rate"]))
    g = generator(run.seed, run.device)
    ring = [make(g, spec, p["batch"], n, p["sample_rate"], run.device)
            for spec in p["ring"]]
    for x in ring:                       # every shape of the window, warm
        sut.call(x)
    sync(run.device)
    rng = np.random.default_rng(run.seed)
    keep = set(rng.choice(p["keep_from"], size=p["keep_early"],
                          replace=False).tolist())
    return {"ring": ring, "keep": keep}
