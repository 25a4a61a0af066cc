"""Rounded-bf16 slicing of host matrices (port of
``melspec_tpu.ops.hp_dft.bf16_round_slices``; the rest of that module is
not ported yet)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bf16_round_slices(mat, n_slices: int) -> Tuple[torch.Tensor, ...]:
    """``mat ~= sum_j M_j`` with ``M_j`` bf16 and ``|M_j| <= 2^-8j |mat|``:
    each level is the bf16 rounding of the running float64 residual.

    The JAX package rounds float64 to bf16 through ``ml_dtypes``, which
    goes via float32 (two roundings). The explicit float64 -> float32 ->
    bf16 chain here reproduces that bit for bit. Returns CPU bf16
    tensors."""
    residual = torch.as_tensor(np.asarray(mat, np.float64))
    out = []
    for _ in range(n_slices):
        t = residual.to(torch.float32).to(torch.bfloat16)
        residual = residual - t.to(torch.float64)
        out.append(t)
    return tuple(out)
