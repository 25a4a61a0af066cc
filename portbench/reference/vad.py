"""The Sobel-edge VAD: column classes over a mel image and the majority
smoothing."""

from __future__ import annotations

import torch


def column_classes(img: torch.Tensor, min_energy: float, min_y: int,
                   min_mel: int) -> torch.Tensor:
    """``img [..., H, W]`` (mels by frames) -> bool ``[..., W - 2]``: the
    column of 3x3 patches whose left edge is frame ``x`` is active when at
    least ``min_y`` of its patches, top rows ``min(min_mel, H - 2) .. H -
    3``, have ``gx^2 + gy^2 >= min_energy^2`` (Sobel: ``gx`` right column
    minus left, ``gy`` bottom row minus top, weights 1 2 1)."""
    h = img.shape[-2]
    if min_y == 0:
        return torch.ones(img.shape[:-2] + (img.shape[-1] - 2,),
                          dtype=torch.bool, device=img.device)
    a = img[..., min(min_mel, h - 2):, :]
    col = lambda j: a[..., j:a.shape[-1] - 2 + j]  # noqa: E731
    left, mid, right = col(0), col(1), col(2)
    gx = (right[..., :-2, :] + 2.0 * right[..., 1:-1, :] + right[..., 2:, :]
          - left[..., :-2, :] - 2.0 * left[..., 1:-1, :] - left[..., 2:, :])
    gy = (left[..., 2:, :] + 2.0 * mid[..., 2:, :] + right[..., 2:, :]
          - left[..., :-2, :] - 2.0 * mid[..., :-2, :] - right[..., :-2, :])
    hits = (gx * gx + gy * gy) >= min_energy * min_energy
    return hits.sum(dim=-2) >= min_y


def majority(mask: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Entry ``i`` is true when at least half of ``mask[max(0, i - radius)
    : i + radius + 1]`` is true."""
    n = mask.shape[-1]
    c = torch.nn.functional.pad(torch.cumsum(mask.to(torch.int64), dim=-1),
                                (1, 0))
    i = torch.arange(n, device=mask.device)
    lo = torch.clamp_min(i - radius, 0)
    hi = torch.clamp_max(i + radius + 1, n)
    return 2 * (c[..., hi] - c[..., lo]) >= (hi - lo)
