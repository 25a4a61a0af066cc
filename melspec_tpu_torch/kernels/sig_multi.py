"""K2: several frontends' features from one staging of the raw signal —
the CUDA kernel (``csrc/sig_multi.cu``), its plain PyTorch version, and
the wrapper that picks between them by the device the signal lies on.

Replaces ``melspec_tpu/ops/sig_multihead.py::_pallas_sig_multi`` (body
``_sig_multi_tile_kernel``). Each head is a ``SigHead`` (its matrices,
taps, layout, projection and output mode); head 0 may carry the Sobel VAD
epilogue. ``sig_multi`` launches the kernel for a CUDA tensor (or raises)
and runs ``sig_multi_reference`` only for a CPU tensor. ``launches``
counts kernel launches and ``pipelined_launches`` those of the pipelined
128-frame walk; nothing else adds to them.

K2 walks its 128-frame blocks as K1 does (``csrc/sig_pipe.cuh``, block
layout 4): a producer warp brings each head's stage stream
(``sig_mel.pipe_stages``, laid out by the head's first pipelined launch
and kept in its ``StageSlot``) in head order through one ring beside the
span that every head reads. Where the span, that ring's four slots and
its tile region do not fit, the heads take 64-frame blocks on the
synchronous walk. The outputs are equal bit for bit either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.kernels.sig_mel import (MAX_SMEM_BYTES, OUT_MODES,
                                               PIPE_FRAMES, TILE_FRAMES,
                                               SigHead, aligned,
                                               block_table, check_head,
                                               clamped_guard, raise_for,
                                               shape_refusal,
                                               sig_mel_reference,
                                               tile_vad_counts)

__all__ = ["TILE_FRAMES", "k2_accepts", "sig_multi", "sig_multi_reference"]

MAX_HEADS = 4
# K2's DFT widths: K1's but 2048, so K2 keeps to its 128- and 64-frame
# blocks (csrc/sig_multi.cu)
WIDTHS = (256, 512, 1024)

launches = 0
pipelined_launches = 0


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
    outs = tuple(sig_mel_reference(samples, h, ks=ks, n_frames=n_frames,
                                   hop=hop, offset=offset,
                                   dot_dtype=dot_dtype)
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
        p, p, p, p, p, p,       # n_blocks, packs, pack_offs, widths,
                                # npows, lives
        p, p, p, p, p,          # n_mels, n_mels_pad, bf2, out_modes, guards
        p, ctypes.c_float, i,   # vad, vad_thr, vad_start_y
        p, p,                   # stages (array), stream
    ]
    lib.melspec_sig_multi.restype = ctypes.c_int
    lib.melspec_sig_multi_layout.argtypes = [i, i, i, p, p, p, p, p, p, p,
                                             p, p, p]
    lib.melspec_sig_multi_layout.restype = ll
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


class Layout(NamedTuple):
    """K2's block layout: a block's shared memory, its frames, the staged
    span's samples, its chunks' DFT columns, the layout's code (4: the
    pipelined walk; 1: 64-frame blocks on the synchronous walk) and the
    pipelined walk's ring slots (0 in layout 1)."""

    smem: int
    frames: int
    span: int
    cols: int
    code: int
    slots: int

    @property
    def pipelined(self) -> bool:
        """Whether K2 walks it on the pipelined walk: every 128-frame
        block of K2 does."""
        return self.frames == PIPE_FRAMES


def block_layout(ks: int, hop: int, packs, pack_offs, widths, npows,
                 nmps) -> Layout:
    """The block layout K2 takes for the heads' integer fields (asks the
    built kernel, which decides it from the heads' shapes, as K1's
    ``block_layout``): 128-frame blocks on the pipelined walk where the
    span, a ring of four slots, the region of any head's power or log
    tile and the ring's barriers fit, with as many slots as fit (up to
    8); else 64-frame blocks."""
    code, frames, span, cols, slots = (ctypes.c_int() for _ in range(5))
    smem = _bound().melspec_sig_multi_layout(
        ks, hop, len(packs), _ints(packs), _ints(pack_offs), _ints(widths),
        _ints(npows), _ints(nmps), ctypes.byref(code), ctypes.byref(frames),
        ctypes.byref(span), ctypes.byref(cols), ctypes.byref(slots))
    return Layout(int(smem), frames.value, span.value, cols.value,
                  code.value, slots.value)


def _smem_bytes(ks: int, hop: int, packs, pack_offs, widths, npows,
                nmps) -> tuple:
    """One K2 block's shared memory and staged span (samples) (asks the
    built kernel)."""
    layout = block_layout(ks, hop, packs, pack_offs, widths, npows, nmps)
    return layout.smem, layout.span


def _layout(heads: Sequence[SigHead]) -> tuple:
    """``(packs, pack_offs, widths, npows, nmps)`` of the heads."""
    return ([h.pack for h in heads], [h.pack_off for h in heads],
            [h.width for h in heads], [h.npow for h in heads],
            [h.n_mels_pad for h in heads])


def _refusal(heads: Sequence[SigHead], ks: int, hop: int) -> str | None:
    """Why K2 refuses these heads at ``hop`` with ``ks`` slices, or None:
    the head count, each head's shape check and the shared-memory figure
    of the built kernel, the checks the launch applies."""
    if not 0 < len(heads) <= MAX_HEADS:
        return f"K2 takes 1..{MAX_HEADS} heads; got {len(heads)}"
    for h in heads:
        refusal = shape_refusal(h.width, h.n_bins_pad, h.n_mels_pad, "K2",
                                WIDTHS)
        if refusal is not None:
            return refusal
    smem, span = _smem_bytes(ks, hop, *_layout(heads))
    if smem > MAX_SMEM_BYTES:
        return (f"K2 needs {smem} bytes of shared memory (a span of {span} "
                f"samples in {ks} bf16 slices kept for {len(heads)} heads, "
                f"plus the ring and the widest head's power tile); a block "
                f"has {MAX_SMEM_BYTES}")
    return None


def k2_accepts(heads: Sequence[SigHead], *, hop: int, ks: int = 3) -> bool:
    """Whether K2 takes ``heads`` at ``hop`` with ``ks`` signal slices: the
    refusals of the launch (head count, each head's DFT width and split,
    shared memory). The fused frontends run on K2 only where this
    holds."""
    return _refusal(tuple(heads), ks, hop) is None


def stage_streams(heads: Sequence[SigHead]) -> list:
    """Each head's stage stream for K2's pipelined walk, from the head's
    own ``StageSlot`` (laid out by its first pipelined launch, K1's or
    K2's, and reused after)."""
    return [h.stages.stream(h) for h in heads]


def _launch(samples, heads, *, ks, n_frames, hop, offset, vad) -> tuple:
    global launches, pipelined_launches
    dev = samples.device
    if not 0 < len(heads) <= MAX_HEADS:
        raise ValueError(f"K2 takes 1..{MAX_HEADS} heads; got {len(heads)}")
    for h in heads:
        check_head(samples, h, ks=ks, what="K2", widths=WIDTHS)
    if vad is not None and heads[0].out_mode != "whisper":
        raise ValueError("K2's VAD epilogue runs on a whisper head 0")
    n = len(heads)

    def arr(ctype, values):
        return (ctype * n)(*values)

    refusal = _refusal(heads, ks, hop)
    if refusal is not None:
        raise NotImplementedError(refusal)
    packs, pack_offs, widths, npows, nmps = _layout(heads)
    pipe = block_layout(ks, hop, packs, pack_offs, widths, npows,
                        nmps).pipelined
    b, t = samples.shape
    outs = tuple(torch.empty((b, n_frames, h.n_mels), dtype=torch.float32,
                             device=dev) for h in heads)
    counts = (None if vad is None else
              torch.empty((b, n_frames), dtype=torch.int32, device=dev))
    if b == 0 or n_frames <= 0:
        return outs, counts
    samples = samples.contiguous()
    keep = [(aligned(h.m_big), aligned(h.mt), block_table(h.pair_i, dev))
            for h in heads]
    staged = stage_streams(heads) if pipe else None
    lib = _bound()
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
            arr(ci, [len(h.pair_i) for h in heads]),
            _ints(packs), _ints(pack_offs), _ints(widths), _ints(npows),
            _ints([h.live for h in heads]),
            arr(ci, [h.n_mels for h in heads]),
            _ints(nmps),
            arr(ci, [int(h.mel_precision == "bf2") for h in heads]),
            arr(ci, [OUT_MODES.index(h.out_mode) for h in heads]),
            arr(ctypes.c_float, [clamped_guard(h.guard) for h in heads]),
            None if counts is None else counts.data_ptr(), thr, start_y,
            None if staged is None else arr(vp, [s.data_ptr()
                                                 for s in staged]),
            stream)
    raise_for(lib, rc, "K2 (sig_multi)")
    launches += 1
    pipelined_launches += int(pipe)
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
