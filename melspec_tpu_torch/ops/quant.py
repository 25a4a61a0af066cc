"""8-bit min-max quantization for mel interchange (port of
``melspec_tpu.ops.quant``).

Numerically identical to the reference (``src/quant.rs:140-165``): per-array
min/max range, ``scale = 255/(max-min)``, round half away from zero, clamp to
[0, 255]; a degenerate range (max == min) quantizes to 0 exactly like Rust's
``NaN.max(0.0).min(255.0)`` chain. Host functions on numpy arrays
(``quantize``, ``dequantize``) and tensor functions on any device
(``quantize_tensor``, ``dequantize_tensor``, ``quantize_frames``, the
counterparts of JAX's ``*_jnp``), all with one float32 expression tree.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QuantizationRange:
    min: float
    max: float


def quantize(frame: np.ndarray) -> Tuple[np.ndarray, QuantizationRange]:
    """Quantize float32 values to u8 with their min/max range (host path)."""
    frame = np.asarray(frame, dtype=np.float32)
    lo = float(frame.min()) if frame.size else float("inf")
    hi = float(frame.max()) if frame.size else float("-inf")
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.float32(255.0) / (np.float32(hi) - np.float32(lo))
        scaled = (frame - np.float32(lo)) * scale
        # the reference's f32 .round(): floor(x) + (x - floor(x) >= 0.5),
        # where x - floor(x) is exact in f32 (floor(x + 0.5) differs one
        # ulp below a half); NaN (degenerate range) -> 0
        fl = np.floor(scaled)
        rounded = fl + (scaled - fl >= np.float32(0.5)).astype(np.float32)
    rounded = np.where(np.isnan(rounded), np.float32(0.0), rounded)
    out = np.clip(rounded, 0.0, 255.0).astype(np.uint8)
    return out, QuantizationRange(min=lo, max=hi)


def dequantize(data: np.ndarray, rng: QuantizationRange) -> np.ndarray:
    """u8 -> float32 using the stored range (host path)."""
    scale = (np.float32(rng.max) - np.float32(rng.min)) / np.float32(255.0)
    return np.asarray(data, dtype=np.float32) * scale + np.float32(rng.min)


def quantize_frames(
    frames: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frame quantization on the tensor's device: each trailing-axis
    vector gets its own min/max range (the wire record ships ``min | max |
    u8[n_mels]`` per frame). ``frames [..., n]`` -> ``(u8 [..., n],
    lo [...], hi [...])``, bit-exact with ``quantize`` on every frame."""
    frames = frames.to(torch.float32)
    lo = frames.amin(dim=-1)
    hi = frames.amax(dim=-1)
    # a true division, as JAX's and the reference's: torch computes
    # ``scalar / tensor`` as ``reciprocal(tensor) * scalar``, which rounds
    # twice and can move a value across a .5 tie
    span = hi - lo
    scale = torch.full_like(span, 255.0) / span
    scaled = (frames - lo[..., None]) * scale[..., None]
    fl = torch.floor(scaled)
    rounded = fl + (scaled - fl >= 0.5).to(torch.float32)
    rounded = torch.where(torch.isnan(rounded), 0.0, rounded)
    return torch.clamp(rounded, 0.0, 255.0).to(torch.uint8), lo, hi


def quantize_tensor(
    frame: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantization over the whole tensor: ``(u8 values, min, max)``, the
    flattened case of ``quantize_frames``."""
    q, lo, hi = quantize_frames(frame.reshape(-1))
    return q.reshape(frame.shape), lo, hi


def dequantize_tensor(data: torch.Tensor, lo, hi) -> torch.Tensor:
    scale = (hi - lo) / 255.0
    return data.to(torch.float32) * scale + lo
