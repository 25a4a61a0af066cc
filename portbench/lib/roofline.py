"""The yardstick of the roofline shares: the published peaks of one
NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates), the
nominal work of a frame, and the bound of a kernel's work."""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
F64_FLOPS = 34e12          # float64 outside the tensor cores
BF16_FLOPS = 989e12        # dense bf16 on the tensor cores


def bound_s(work: dict) -> dict:
    """The least time the chip could take for ``work`` (``bytes`` moved,
    ``flops`` counted as float32 work): the larger of bytes over HBM
    bandwidth and operations over the float32 peak, and which binds."""
    t_bytes = work["bytes"] / HBM_BYTES_PER_S
    t_flops = work["flops"] / F32_FLOPS
    return {"s": max(t_bytes, t_flops), "bytes_s": t_bytes,
            "flops_s": t_flops,
            "binds": "bytes" if t_bytes >= t_flops else "flops"}


def frame_flops(n_fft: int, nnz: int) -> float:
    """Nominal work of one frame of a mel-type frontend: a real FFT of the
    ``n_fft``-point frame (``2.5 n log2 n``), its power (3 a bin over
    ``n_fft // 2 + 1`` bins) and 2 a nonzero filter weight."""
    return 2.5 * n_fft * math.log2(n_fft) + 3 * (n_fft // 2 + 1) + 2 * nnz


def share_pct(view, kernel: str):
    """``kernel``'s share of its roofline in a traced window, in percent:
    the bound of one launch (``roofline/<kernel>.py::work`` at the shape
    the entry states) over the mean device time of its launches in the
    trace. None where the trace holds no launch of it or the entry states
    no shape."""
    from portbench.lib.registry import load_module

    rf = load_module("roofline", kernel)
    ops = view.matching(rf.KERNELS)
    shape = view.shapes.get(kernel)
    if not ops or shape is None:
        return None
    per_launch = sum(e - s for _, s, e in ops) / 1e9 / len(ops)
    return 100.0 * bound_s(rf.work(shape))["s"] / per_launch
