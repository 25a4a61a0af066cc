"""P1: a probe of the port's signal-load path — the CUDA kernel
(``csrc/load_probe.cu``), its plain PyTorch versions and the probe itself.

Replaces ``tools/hbm_reshape_probe.py::run``, the TPU probe that asks
whether a kernel can DMA macro-rows straight out of a flat ``[B, T]``
operand. Here the question is K1's and K2's own load: each block stages
the overlapping span of one 64-frame tile straight from flat ``[B, T]``
into shared memory. Three modes, each a copy through shared memory held
for exact equality against its plain version:

- ``baseline``: rows of a host-reshaped ``[B, R, W]`` tensor;
- ``flat_rows``: the same rows read from flat ``[B, T]`` at computed
  offsets (cp.async 16-byte copies where aligned, 4-byte where not);
- ``flat_span``: K1's spans (``span_len`` samples every 64 hops, zero past
  the clip) at 64 x 30 s, 400/160: 47 spans of a 2,998-frame clip.

``run`` is the probe (also ``python3 -m
melspec_tpu_torch.kernels.load_probe``): it prints each mode's result and
its GB/s against the card's 3.35 TB/s. The wrappers launch the kernel for
a CUDA tensor (or raise) and run the plain version only for a CPU one;
``launches`` counts kernel launches per mode, nothing else adds to them.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.kernels.sig_mel import TILE_FRAMES, raise_for
from melspec_tpu_torch.utils.timing import device_time_ms

MODES = ("baseline", "flat_rows", "flat_span")
# the card's memory rate (H100 SXM, NVIDIA's data sheet)
PEAK_HBM_BYTES = 3.35e12
# the probe's shapes: 64 clips of 30 s at 16 kHz; rows of W samples (R
# whole rows of a clip, read from sample ROW_OFFSET on, misaligned by 12
# bytes so a row takes both copy widths); K1's spans at 400/160
BATCH, SECONDS, RATE = 64, 30, 16000
ROW_W, ROW_OFFSET = 640, 3
HOP, TAPS = 160, 400

launches = dict.fromkeys(MODES, 0)


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("load_probe").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_load_probe_rows.argtypes = [p, ll, ll, ll, i, i, i, p, p]
    lib.melspec_load_probe_rows.restype = i
    lib.melspec_load_probe_spans.argtypes = [p, ll, ll, i, i, i, i, p, p]
    lib.melspec_load_probe_spans.restype = i
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def span_len(hop: int, taps: int) -> int:
    """Samples K1 stages per 64-frame tile: ``63 * hop`` plus ``taps``
    rounded up to whole 32-row chunks (``sig_common.cuh::span_len`` with
    ``pack_off`` 0; the tests hold the two in step)."""
    return (TILE_FRAMES - 1) * hop + -(-taps // 32) * 32


def n_spans(n_frames: int) -> int:
    return -(-n_frames // TILE_FRAMES)


def rows_reference(x: torch.Tensor, offset: int, rows: int,
                   width: int) -> torch.Tensor:
    """``x [B, T]`` -> its ``rows`` rows of ``width`` samples from sample
    ``offset`` on, ``[B, rows, width]`` (the host reshape)."""
    return x[:, offset : offset + rows * width].reshape(
        x.shape[0], rows, width)


def spans_reference(x: torch.Tensor, offset: int, hop: int, span: int,
                    count: int) -> torch.Tensor:
    """K1's spans of ``x [B, T]``: span ``t`` is samples ``offset + t * 64
    * hop + u``, ``u < span``, zero past the clip, ``[B, count, span]``
    (a gather of the zero-padded signal)."""
    step = TILE_FRAMES * hop
    need = offset + (count - 1) * step + span
    xp = torch.nn.functional.pad(x, (0, max(0, need - x.shape[-1])))
    return xp[:, offset:need].unfold(-1, span, step)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def load_rows(src: torch.Tensor, *, offset: int, rows: int, width: int,
              flat: bool) -> torch.Tensor:
    """``baseline`` (``flat=False``: ``src`` is the reshaped ``[B, rows,
    width]`` tensor, read with plain loads) or ``flat_rows`` (``flat=True``:
    ``src`` is flat ``[B, T]``, rows from sample ``offset`` on, cp.async)
    -> ``[B, rows, width]``."""
    if src.device.type == "cpu":
        flat_src = src if flat else src.reshape(src.shape[0], -1)
        return rows_reference(flat_src, offset if flat else 0, rows, width)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    if src.dtype != torch.float32 or not src.is_contiguous():
        raise ValueError("P1 takes a contiguous float32 signal")
    if not flat and (tuple(src.shape[1:]) != (rows, width) or offset):
        raise ValueError("baseline takes the reshaped [B, rows, width] "
                         "tensor at offset 0")
    b = src.shape[0]
    stride = src.shape[-1] if flat else rows * width
    out = torch.empty((b, rows, width), dtype=torch.float32,
                      device=src.device)
    lib = _bound()
    with torch.cuda.device(src.device):
        rc = lib.melspec_load_probe_rows(
            src.data_ptr(), b, stride, offset, width, rows, int(flat),
            out.data_ptr(), _stream(src.device))
    raise_for(lib, rc, "P1 (load_probe rows)")
    launches["flat_rows" if flat else "baseline"] += 1
    return out


def load_spans(x: torch.Tensor, *, offset: int, hop: int, span: int,
               count: int) -> torch.Tensor:
    """``flat_span``: K1's ``count`` spans of ``span`` samples of flat
    ``x [B, T]`` -> ``[B, count, span]``."""
    if x.device.type == "cpu":
        return spans_reference(x, offset, hop, span, count)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("P1 takes a contiguous [B, T] float32 signal")
    b, t = x.shape
    if span != span_len(hop, TAPS):
        raise ValueError(f"span {span} is not K1's span at hop {hop}")
    out = torch.empty((b, count, span), dtype=torch.float32, device=x.device)
    lib = _bound()
    with torch.cuda.device(x.device):
        rc = lib.melspec_load_probe_spans(
            x.data_ptr(), b, t, offset, hop, span, count, out.data_ptr(),
            _stream(x.device))
    raise_for(lib, rc, "P1 (load_probe spans)")
    launches["flat_span"] += 1
    return out


def run(dev, batch: int = BATCH, seconds: int = SECONDS, seed: int = 0,
        fail_fast: bool = False, timer=device_time_ms) -> list:
    """The probe on ``dev`` (CUDA): every mode once, held for exact
    equality against its plain version, then timed by ``timer(fn)`` (ms
    of one call; CUDA events by default). Returns one dict per
    mode: ``ok``, ``max_abs_err``, ``ms``, ``plain_ms`` (the plain
    version, copied into a new tensor), ``bytes`` (input read once,
    output written once), ``gb_per_s`` and ``share_of_peak`` against
    3.35 TB/s; a mode that raises gives ``ok`` False and its ``error``,
    unless ``fail_fast``."""
    t = seconds * RATE
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((batch, t), generator=gen) * 0.2).to(dev)
    rows = (t - ROW_OFFSET) // ROW_W
    nf = (t - TAPS) // HOP + 1
    count = n_spans(nf)
    span = span_len(HOP, TAPS)
    reshaped = rows_reference(x, 0, t // ROW_W, ROW_W).contiguous()
    cases = {
        "baseline": (
            lambda: load_rows(reshaped, offset=0, rows=t // ROW_W,
                              width=ROW_W, flat=False),
            lambda: rows_reference(x, 0, t // ROW_W, ROW_W), reshaped),
        "flat_rows": (
            lambda: load_rows(x, offset=ROW_OFFSET, rows=rows, width=ROW_W,
                              flat=True),
            lambda: rows_reference(x, ROW_OFFSET, rows, ROW_W), x),
        "flat_span": (
            lambda: load_spans(x, offset=0, hop=HOP, span=span, count=count),
            lambda: spans_reference(x, 0, HOP, span, count), x),
    }
    results = []
    for mode, (kernel, plain, src) in cases.items():
        try:
            got = kernel()
            want = plain()
            torch.cuda.synchronize()
            same = tuple(got.shape) == tuple(want.shape)
            err = float((got - want).abs().max()) if same else float("inf")
            ok = same and torch.equal(got, want)
            nbytes = src.numel() * 4 + got.numel() * 4
            ms = timer(kernel)
            gbps = nbytes / (ms / 1e3) / 1e9
            results.append(dict(
                mode=mode, ok=bool(ok), max_abs_err=err,
                shape=list(got.shape), ms=ms,
                plain_ms=timer(lambda: plain().clone(
                    memory_format=torch.contiguous_format)),
                bytes=nbytes, gb_per_s=gbps,
                bound_ms=nbytes / PEAK_HBM_BYTES * 1e3,
                share_of_peak=gbps * 1e9 / PEAK_HBM_BYTES))
        except (RuntimeError, ValueError) as exc:
            if fail_fast:
                raise
            results.append(dict(mode=mode, ok=False,
                                error=f"{type(exc).__name__}: {exc}"))
        if fail_fast and not results[-1]["ok"]:
            raise AssertionError(f"P1 {mode} is not exact: {results[-1]}")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("load_probe: CUDA is not available", file=sys.stderr)
        return 1
    results = run(torch.device("cuda"))
    for r in results:
        status = "OK" if r["ok"] else "FAILED"
        print(f"{r['mode']}: {status} {json.dumps(r)}", flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
