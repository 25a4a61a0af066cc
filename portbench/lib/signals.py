"""The seeded test signals, made on the device in a few large calls.

- ``speechlike``: white noise whose level switches between 0.3 and 0.003
  every 0.25 s, with a random phase per stream, so that the VAD sees edges
  and quiet stretches (the signal of ``chip_smoke.py::speechlike``). Its
  spectrum is flat.
- ``recorded``: clips of real speech, each cut from a seeded place of one
  tape of recordings (``data/<file>``, int16 at its ``rate``) taken round
  the tape's end, at a seeded gain in ``gain_db``. Speech falls off
  towards high frequencies and holds pauses and digital silence, so the
  log heads see near-empty bins and their floors. At a whole multiple k
  of the tape's rate the tape is first up-sampled by k (``tape_at``):
  band-limited, so every bin above the tape's Nyquist frequency is empty.

A traffic file names a ring entry as ``{"signal": <name>, ...}``; the
other keys are the signal's own parameters."""

from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.lib.registry import ROOT, NAME


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def speechlike(g: torch.Generator, streams: int, n: int, rate: float,
               device: torch.device, block: int = 256) -> torch.Tensor:
    """``[streams, n]`` float32 on ``device`` (the level mask is made
    ``block`` streams at a time)."""
    phase = torch.rand((streams, 1), generator=g, device=device,
                       dtype=torch.float64) * 0.5
    x = torch.randn((streams, n), generator=g, device=device,
                    dtype=torch.float32)
    t = torch.arange(n, device=device, dtype=torch.float64) / rate
    for s in range(0, streams, block):
        on = torch.remainder(t[None, :] + phase[s : s + block], 0.5) < 0.25
        x[s : s + block] *= torch.where(on, 0.3, 0.003).to(torch.float32)
    return x


def tape(file: str) -> tuple:
    """``(samples, rate)`` of the tape ``data/<file>``: int16 samples as a
    NumPy array and their rate in Hz."""
    if not NAME.fullmatch(file):
        raise ValueError(f"not a name: {file!r}")
    with np.load(ROOT / "data" / file) as d:
        return d["tape"], int(d["rate"])


def tape_at(file: str, rate: float, device: torch.device) -> torch.Tensor:
    """The tape ``file`` at ``rate``, float32 on ``device`` in [-1, 1): at
    the tape's own rate its int16 samples over 32768; at ``k`` times it,
    for a whole ``k``, the tape up-sampled by ``upsampled``. Any other
    rate raises ``ValueError``."""
    samples, tape_rate = tape(file)
    k = rate / tape_rate
    if k != int(k) or k < 1:
        raise ValueError(f"{file} holds {tape_rate} Hz audio, and {rate} Hz "
                         f"is no whole multiple of it")
    if k == 1:
        return torch.as_tensor(samples, device=device).to(
            torch.float32) / 32768.0
    return upsampled(file, int(k), device).to(device)


@functools.lru_cache(maxsize=4)
def upsampled(file: str, k: int, device: torch.device) -> torch.Tensor:
    """The tape ``file`` up-sampled by ``k``, float32 on the CPU, worked
    out once a process on ``device``: band-limited periodic interpolation
    in float64 (the tape's rFFT zero-padded to ``k`` times its length and
    inverted; the tape is read round its end, so it is periodic). Every
    ``k``-th sample is the tape's, and every bin above the tape's Nyquist
    frequency is empty. Kept on the host, so that the window's memory
    peak holds no tape."""
    samples, _ = tape(file)
    src = torch.as_tensor(samples, device=device).to(torch.float64) / 32768.0
    n = src.numel()
    spec = torch.fft.rfft(src)
    if n % 2 == 0:
        # the tape's Nyquist bin stands for +n/2 and -n/2 alike; at k n
        # points they are two bins, each holding half
        spec[-1] *= 0.5
    return (torch.fft.irfft(spec, n=k * n) * k).to(torch.float32).cpu()


def recorded(g: torch.Generator, streams: int, n: int, rate: float,
             device: torch.device, file: str, gain_db: list,
             block: int = 16) -> torch.Tensor:
    """``[streams, n]`` float32 on ``device``: clips of the tape ``file``
    at ``rate`` (``tape_at``) from seeded starts, scaled by a seeded gain,
    uniform in decibels over ``gain_db``."""
    src = tape_at(file, rate, device)
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
