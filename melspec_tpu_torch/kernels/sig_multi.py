"""K2: several frontends' features from one staging of the raw signal —
the CUDA kernel (``csrc/sig_multi.cu``), its plain PyTorch version, and
the wrapper that picks between them by the device the signal lies on.

Replaces ``melspec_tpu/ops/sig_multihead.py::_pallas_sig_multi`` (body
``_sig_multi_tile_kernel``). Each head is a ``SigHead`` (its matrices,
taps, layout, projection and output mode); head 0 may carry the Sobel VAD
epilogue. ``sig_multi`` launches the kernel for a CUDA tensor (or raises)
and runs ``sig_multi_reference`` only for a CPU tensor. ``launches``
counts kernel launches; nothing else adds to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.kernels.sig_mel import (MAX_SMEM_BYTES, OUT_MODES,
                                               TILE_FRAMES, SigHead,
                                               block_table, check_head,
                                               clamped_guard, raise_for,
                                               sig_mel_reference,
                                               tile_vad_counts)

__all__ = ["TILE_FRAMES", "sig_multi", "sig_multi_reference"]

MAX_HEADS = 4

launches = 0


def sig_multi_reference(samples: torch.Tensor, heads: Sequence[SigHead], *,
                        ks: int, n_frames: int, hop: int, offset: int = 0,
                        vad: tuple | None = None,
                        dot_dtype: torch.dtype = torch.float32) -> tuple:
    """The JAX kernel's math in plain PyTorch: each head is K1's plain
    version on the same signal and frame grid (``sig_mel_reference``),
    and ``vad = (thr, start_y)`` adds ``tile_vad_counts`` of head 0.
    Returns ``(outs, counts)``, ``outs`` one ``[B, n_frames, n_mels_h]``
    float32 tensor per head, ``counts`` int32 ``[B, n_frames]`` or
    None."""
    outs = tuple(sig_mel_reference(samples, h.m_big, h.pair_i, h.mt, ks=ks,
                                   n_frames=n_frames, hop=hop, offset=offset,
                                   dot_dtype=dot_dtype, **h.kw())
                 for h in heads)
    counts = None if vad is None else tile_vad_counts(outs[0], *vad)
    return outs, counts


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("sig_multi").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_sig_multi.argtypes = [
        p, ll, ll, i, i, i, i,  # x, batch, T, n_frames, hop, offset, tile
        i, i,                   # ks, n_heads
        p, p, p, p,             # m_bigs, blocks, mts, outs (arrays)
        p, p, p, p, p, p, p, p, p,  # per-head int / float arrays
        p, ctypes.c_float, i,   # vad, vad_thr, vad_start_y
        p,                      # stream
    ]
    lib.melspec_sig_multi.restype = ctypes.c_int
    lib.melspec_sig_multi_smem_bytes.argtypes = [i, i, i, p, p, p, p, p]
    lib.melspec_sig_multi_smem_bytes.restype = ll
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(samples, heads, *, ks, n_frames, hop, offset, vad) -> tuple:
    global launches
    dev = samples.device
    if not 0 < len(heads) <= MAX_HEADS:
        raise ValueError(f"K2 takes 1..{MAX_HEADS} heads; got {len(heads)}")
    checked = [check_head(samples, h.m_big, h.pair_i, h.mt, ks=ks,
                          pack=h.pack, pack_off=h.pack_off,
                          n_bins_pad=h.n_bins_pad, n_mels=h.n_mels,
                          mel_precision=h.mel_precision,
                          out_mode=h.out_mode, what="K2")
               for h in heads]
    if vad is not None and heads[0].out_mode != "whisper":
        raise ValueError("K2's VAD epilogue runs on a whisper head 0")
    n = len(heads)

    def arr(ctype, values):
        return (ctype * n)(*values)

    packs = arr(ctypes.c_int, [h.pack for h in heads])
    pack_offs = arr(ctypes.c_int, [h.pack_off for h in heads])
    npows = arr(ctypes.c_int, [npow for _, npow, _, _ in checked])
    nmps = arr(ctypes.c_int, [nmp for _, _, nmp, _ in checked])
    lib = _bound()
    # one block's staged span and shared memory, as the built kernel
    # lays them out
    span = ctypes.c_int()
    smem = lib.melspec_sig_multi_smem_bytes(ks, hop, n, packs, pack_offs,
                                            npows, nmps, ctypes.byref(span))
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"K2 needs {smem} bytes of shared memory (a span of {span.value} "
            f"samples in {ks} bf16 slices kept for {len(heads)} heads, "
            f"plus the widest head's power and log tiles); a block has "
            f"{MAX_SMEM_BYTES}")
    b, t = samples.shape
    outs = tuple(torch.empty((b, n_frames, h.n_mels), dtype=torch.float32,
                             device=dev) for h in heads)
    counts = (None if vad is None else
              torch.empty((b, n_frames), dtype=torch.int32, device=dev))
    if b == 0 or n_frames <= 0:
        return outs, counts
    samples = samples.contiguous()
    keep = [(h.m_big.contiguous(), h.mt.contiguous(),
             block_table(pair_i, dev))
            for h, (pair_i, _, _, _) in zip(heads, checked)]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    thr, start_y = vad if vad is not None else (0.0, 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.melspec_sig_multi(
            samples.data_ptr(), b, t, n_frames, hop, offset, TILE_FRAMES,
            ks, n,
            arr(vp, [m.data_ptr() for m, _, _ in keep]),
            arr(vp, [bt.data_ptr() for _, _, bt in keep]),
            arr(vp, [mt.data_ptr() for _, mt, _ in keep]),
            arr(vp, [o.data_ptr() for o in outs]),
            arr(ci, [len(pi) for pi, _, _, _ in checked]),
            packs, pack_offs, npows,
            arr(ci, [h.n_mels for h in heads]), nmps,
            arr(ci, [int(bf2) for _, _, _, bf2 in checked]),
            arr(ci, [OUT_MODES.index(h.out_mode) for h in heads]),
            arr(ctypes.c_float, [clamped_guard(h.guard) for h in heads]),
            None if counts is None else counts.data_ptr(), thr, start_y,
            stream)
    raise_for(lib, rc, "K2 (sig_multi)")
    launches += 1
    return outs, counts


def sig_multi(samples: torch.Tensor, heads: Sequence[SigHead], *, ks: int,
              n_frames: int, hop: int, offset: int = 0,
              vad: tuple | None = None) -> tuple:
    """K2 on a CUDA signal, its plain version on a CPU one (same
    arguments as ``sig_multi_reference``; on the CPU the DFT dot is
    summed in float64, as for K1)."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, vad=vad)
    if samples.device.type == "cuda":
        return _launch(samples, tuple(heads), **kw)
    if samples.device.type == "cpu":
        return sig_multi_reference(samples, heads, dot_dtype=torch.float64,
                                   **kw)
    raise ValueError(f"unsupported device {samples.device}")
