"""The gaps that decide ``correct``: a gap that cannot be measured (other
shapes, a value that is not finite) is infinite, so it fails any limit."""

from __future__ import annotations

import math

import torch

INF = float("inf")


def max_gap(got: torch.Tensor, truth: torch.Tensor) -> float:
    """Largest absolute difference of ``got`` from ``truth``."""
    got = torch.as_tensor(got, device=truth.device)
    if tuple(got.shape) != tuple(truth.shape):
        return INF
    d = (got.to(truth.dtype) - truth).abs()
    if d.numel() == 0:
        return 0.0
    worst = float(d.max())
    return worst if math.isfinite(worst) and bool(torch.isfinite(d).all()) \
        else INF


def worst(*gaps: float) -> float:
    """The largest of ``gaps``; NaN counts as infinite."""
    return max((INF if math.isnan(g) else g) for g in gaps) if gaps else 0.0
