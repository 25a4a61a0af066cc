"""Model-free Sobel-edge voice activity detection, device part (port of
``melspec_tpu.ops.vad``).

Same decision function as the reference (``src/vad.rs``), vectorized: the
squared Sobel gradient of a whole mel image is eight shifted slices, a
column's classification is one masked row count, and the majority-vote
smoothing (``src/vad.rs:343-360``) is a prefix sum. The batched streaming
decision fields evaluate every per-frame decision of
``VoiceActivityDetector::add_activity`` (``src/vad.rs:156-205``) at once.
The host functions of the JAX module (``vad_boundaries``,
``streaming_decisions``, the images) are not ported yet.

Geometry (bit-parity critical):
- gradients are evaluated with the 3x3 patch's TOP-LEFT corner at
  ``(y, x)``, ``y`` from ``start_y = min(min_mel, H-2)`` to ``H-3``;
- a window of ``W`` columns yields ``W-2`` classified columns;
- the smoothing window is ±4 columns, majority = ``2*count >= window_len``.
"""

from __future__ import annotations

import torch

from melspec_tpu_torch.config import DetectionSettings


def sobel_gradient_sq(img: torch.Tensor) -> torch.Tensor:
    """Squared Sobel gradient magnitude ``gx^2 + gy^2`` of every 3x3 patch:
    ``img [..., H, W]`` -> ``[..., H-2, W-2]``, entry ``(y, x)`` for the
    patch whose top-left corner is ``(y, x)`` (``src/vad.rs:472-486``)."""
    tl = img[..., :-2, :-2]
    tc = img[..., :-2, 1:-1]
    tr = img[..., :-2, 2:]
    ml = img[..., 1:-1, :-2]
    mr = img[..., 1:-1, 2:]
    bl = img[..., 2:, :-2]
    bc = img[..., 2:, 1:-1]
    br = img[..., 2:, 2:]
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return gx * gx + gy * gy


def classify_columns(img: torch.Tensor,
                     settings: DetectionSettings) -> torch.Tensor:
    """Raw per-column activity over a ``[..., H, W]`` mel image -> bool
    ``[..., W-2]``: a column is active when >= ``min_y`` of its gradients
    (rows ``start_y .. H-3``) have squared magnitude >= ``min_energy**2``
    (``src/vad.rs:373-415``); ``min_y == 0`` marks everything active."""
    height = img.shape[-2]
    width = img.shape[-1]
    if settings.min_y == 0:
        return torch.ones(img.shape[:-2] + (width - 2,), dtype=torch.bool,
                          device=img.device)
    g2 = sobel_gradient_sq(img)
    start_y = min(settings.min_mel, height - 2)
    g2 = g2[..., start_y:, :]
    thr = settings.min_energy * settings.min_energy
    counts = torch.sum(g2 >= thr, dim=-2)
    return counts >= settings.min_y


def smooth_mask(mask: torch.Tensor, window: int = 4) -> torch.Tensor:
    """Moving-window majority vote over a boolean mask: index ``i`` is true
    when at least half of ``mask[max(0,i-window) : min(i+window+1, n)]`` is
    true (``src/vad.rs:343-360``)."""
    n = mask.shape[-1]
    prefix = torch.cat(
        [torch.zeros(mask.shape[:-1] + (1,), dtype=torch.int32,
                     device=mask.device),
         torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)],
        dim=-1)
    i = torch.arange(n, device=mask.device)
    start = torch.clamp_min(i - window, 0)
    end = torch.clamp_max(i + window + 1, n)
    count = prefix[..., end] - prefix[..., start]
    return count * 2 >= (end - start)


def streaming_decision_fields_batched(mels, settings: DetectionSettings,
                                      raw=None) -> dict:
    """Batched decision fields of the streaming detector: ``mels [B,
    n_mels, T]`` -> dict of ``[B, n_dec]`` tensors, ``n_dec = T - min_x +
    1`` (decision ``i`` is for frame ``min_x - 1 + i``). ``raw`` (``[B,
    T-2]`` bool column classes) skips ``classify_columns``; ``mels`` may
    then be None. Requires ``T >= min_x >= 3`` and ``n_mels >= 3``."""
    if raw is not None:
        height, total = 3, raw.shape[-1] + 2  # height only gates the guard
    else:
        height, total = mels.shape[-2], mels.shape[-1]
    min_x = settings.min_x
    win_cols = min_x - 2
    if total < min_x or height < 3 or win_cols < 1:
        raise ValueError("need T >= min_x >= 3 and n_mels >= 3")
    if raw is None:
        raw = classify_columns(mels, settings)  # [B, T-2]
    n_dec = total - min_x + 1
    windows = torch.stack(
        [raw[..., j : j + n_dec] for j in range(win_cols)], dim=-1
    )  # [B, n_dec, win_cols]
    smoothed = smooth_mask(windows, 4)
    active_columns = torch.sum(smoothed, dim=-1)
    leading = torch.sum(torch.cumprod(smoothed.to(torch.int32), dim=-1),
                        dim=-1)
    return {
        "active": smoothed[..., 0],
        "leading": leading,
        "active_columns": active_columns,
        "window_columns": torch.full_like(active_columns, win_cols),
        "confidence": active_columns / win_cols,
    }
