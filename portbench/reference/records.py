"""The u8 records: min-max quantisation, ``q = round((v - lo) * 255 / (hi
- lo))`` with halves rounded up, and the distance of a program's ``q``
from the reference's unrounded position."""

from __future__ import annotations

import torch


def positions(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
              ) -> torch.Tensor:
    """Unrounded quantisation positions of ``v`` in ``[lo, hi]`` (``lo`` and
    ``hi`` broadcast against ``v``)."""
    return (v - lo) * (255.0 / (hi - lo))


def quantize(v: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
             ) -> torch.Tensor:
    return torch.clamp(torch.floor(positions(v, lo, hi) + 0.5), 0, 255).to(
        torch.uint8)


def excess_steps(q: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """How far ``q`` lies beyond the half step that rounding allows around
    the reference's position: 0 where ``q`` is a rounding of ``pos``."""
    return torch.clamp_min((q.to(pos.dtype) - pos).abs() - 0.5, 0.0)
