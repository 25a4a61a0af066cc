"""Work of one launch of K1 (``csrc/sig_mel.cu``, ``kernels/sig_mel.py``):
the mel (or log-fbank) of ``batch`` rows of ``samples`` float32 samples,
``frames`` frames each, counted for the function whatever implements it.

- bytes: the signal read once and the ``[batch, frames, n_mels]`` float32
  output written once;
- flops: ``lib/roofline.py::frame_flops`` a frame (a nominal real FFT of
  the ``n_fft``-point frame, its power, 2 a nonzero filter weight).

``KERNELS``: substrings of K1's kernel names in a device trace (the dense
walk ``sig_mel_kernel``, the factored path ``sig_mel_factored_kernel``,
the float64 FFT path ``sig_mel_fft_kernel``)."""

from __future__ import annotations

from portbench.lib.roofline import frame_flops

KERNELS = ("sig_mel",)


def work(shape: dict) -> dict:
    rows = shape["batch"] * shape["frames"]
    return {"bytes": 4 * shape["batch"] * shape["samples"]
            + 4 * rows * shape["n_mels"],
            "flops": rows * frame_flops(shape["n_fft"], shape["nnz"])}
