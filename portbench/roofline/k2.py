"""Work of one launch of K2 (``csrc/sig_multi.cu``,
``kernels/sig_multi.py``): several frontends (heads) over one pass of
``batch`` rows of ``samples`` float32 samples, ``frames`` frames each,
counted for the function whatever implements it.

- bytes: the signal read once, each head's ``[batch, frames, n_mels]``
  float32 output and the VAD epilogue's ``vad_bytes`` a frame written
  once;
- flops: ``lib/roofline.py::frame_flops`` a frame and head: each head's
  own real FFT, power and filter weights.

``KERNELS``: substrings of K2's kernel name in a device trace."""

from __future__ import annotations

from portbench.lib.roofline import frame_flops

KERNELS = ("sig_multi",)


def work(shape: dict) -> dict:
    rows = shape["batch"] * shape["frames"]
    heads = shape["heads"]
    return {"bytes": 4 * shape["batch"] * shape["samples"]
            + rows * (4 * sum(h["n_mels"] for h in heads)
                      + shape["vad_bytes"]),
            "flops": rows * sum(frame_flops(h["n_fft"], h["nnz"])
                                for h in heads)}
