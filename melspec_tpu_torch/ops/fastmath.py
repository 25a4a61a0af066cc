"""Accurate float32 logarithms by bit decomposition (port of
``melspec_tpu.ops.fastmath``).

``x = m * 2^e`` with integer bit ops (exact), ``m`` reduced to
``[1/sqrt(2), sqrt(2))``, ``ln m = 2 atanh(t)`` with
``t = (m-1)/(m+1)`` and a 4-term odd series in Horner order: absolute
error ~3e-8. The same constants, the same operation order and the same
float32 rounding as the JAX functions, so the plain path tracks JAX's
output to the ulp; K1 (``csrc/sig_mel.cu``) carries the identical
sequence in its epilogue.
"""

from __future__ import annotations

import numpy as np
import torch

_LOG10_2 = np.float32(np.log10(2.0))
_INV_LN10 = np.float32(1.0 / np.log(10.0))
_LN2 = np.float32(np.log(2.0))
# adding (2^23 - mantissa field of float32(sqrt(2)) = 0x3504F3) before the
# shift carries into the exponent field exactly when m >= f32(sqrt(2))
_E_ROUND = int((1 << 23) - 0x3504F3)


def series_coefficients(scale: float) -> tuple:
    """``scale * (2/7, 2/5, 2/3, 2)`` rounded to float32 — the Horner
    coefficients of ``scale * 2 atanh(t)``."""
    return tuple(np.float32(scale * c) for c in (2.0 / 7.0, 2.0 / 5.0,
                                                 2.0 / 3.0, 2.0))


def _decompose(x: torch.Tensor):
    """x = m * 2^e with m in [1/sqrt2, sqrt2); x must be positive normal."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits + _E_ROUND) >> 23) - 127
    m = (bits - (e << 23)).view(torch.float32)
    return m, e.to(torch.float32)


def _ln_mantissa(m: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``scale * ln(m)`` for m in [1/sqrt2, sqrt2)."""
    c7, c5, c3, c1 = series_coefficients(scale)
    t = (m - 1.0) / (m + 1.0)
    t2 = t * t
    p = t2 * float(c7) + float(c5)
    p = p * t2 + float(c3)
    p = p * t2 + float(c1)
    return p * t


def log10_accurate(x: torch.Tensor) -> torch.Tensor:
    """log10 with absolute error ~<= 1 output ulp for positive normal
    float32 ``x``."""
    m, e = _decompose(x)
    return e * float(_LOG10_2) + _ln_mantissa(m, scale=float(_INV_LN10))


def ln_accurate(x: torch.Tensor) -> torch.Tensor:
    """Natural log with the same construction."""
    m, e = _decompose(x)
    return e * float(_LN2) + _ln_mantissa(m)


def log10_best(x: torch.Tensor, dtype) -> torch.Tensor:
    """The accurate float32 log10 for float32, ``torch.log10`` for wider
    dtypes (the bit decomposition is float32-specific)."""
    if dtype == torch.float32:
        return log10_accurate(x)
    return torch.log10(x)


def ln_best(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return ln_accurate(x)
    return torch.log(x)
