"""The two arithmetics of the reference: float64, and the control's TF32.

TF32 keeps 10 of float32's 23 mantissa bits. ``to_tf32`` rounds the
operands to them (to nearest, ties away from zero), as the tensor cores
do before they multiply; a product of two TF32 values is exact in
float32, so a float32 product of rounded operands is a TF32 product on
any device, the CPU included."""

from __future__ import annotations

import torch

PRECISIONS = ("float64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "float64" else torch.float32


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as an operand of a product in ``precision``."""
    x = x.to(dtype_of(precision))
    return to_tf32(x) if precision == "tf32" else x


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return operand(a, precision) @ operand(b, precision)
