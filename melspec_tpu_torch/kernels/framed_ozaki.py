"""K6 and K7 on the tensor cores: the launcher of ``csrc/framed_ozaki.cu``
and its host-side tables.

``kernels/framed_mel.py`` checks the arguments of every framed kernel and
routes ``"hp8"`` (K6) and ``"hp_bf16"`` (K7) here; their plain versions
stay there. The tables are plain PyTorch, so the CPU tests rebuild the
kernels' sums from them:

- ``pair_table(ks, cutoff)``: the kept slice pairs ``(i, j, s = i + j)``
  in the kernels' order, ``s`` ascending, then ``i`` ascending (K7 adds a
  group's pairs in that order; K6 runs a group's pairs one after another
  along K in one int32 accumulation);
- ``ring_tiles``: the planes cut into the kernels' ring stages, each
  stage one contiguous tile in the byte order of the kernel's shared
  memory (``wgmma``'s no-swizzle core matrices of 8 x 16 bytes), so a
  block copies a stage with whole, aligned 16-byte loads. K6: a block of
  tiles per pair, the pair's plane K-major (8-bit ``wgmma`` reads B only
  K-major), 128 taps a stage; K7: a block per plane, N contiguous, 64
  taps a stage, as float16 (the planes are integers of at most 128, so
  float16 holds them exactly, and the kernel widens its int8 slices to
  float16 with integer operations), each 16 rows in ``K7_TAP_ORDER``.
  Taps past ``taps`` are zero. ``FramedMatrices.ring_tiles`` builds
  them once per matrix set and keeps them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.kernels.sig_mel import MAX_SMEM_BYTES, raise_for

# the scheme numbers of csrc/framed_ozaki.cu
SCHEME = {"hp8": 0, "hp_bf16": 1}
# bins per chunk of the kernels' walk (framed_mel checks that n_bins_pad
# is a multiple of its 128)
CHUNK_BINS = 64
# taps of a ring stage (four wgmma k steps) and its bytes
STAGE_TAPS = {"hp8": 128, "hp_bf16": 64}
TILE_BYTES = 16384
# K7's k16 steps: fragment position p of the wgmma's K takes tap
# K7_TAP_ORDER[p] of its 16 (the kernel reads 4 consecutive int8 taps a
# register with ldmatrix; an exact sum does not depend on the order)
K7_TAP_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def pair_table(ks: int, cutoff: int) -> tuple:
    """The kept pairs ``(i, j, s)``, ``i, j < ks``, ``s = i + j <=
    cutoff``, ``s`` ascending then ``i`` ascending."""
    return tuple((i, s - i, s) for s in range(cutoff + 1) for i in range(ks)
                 if 0 <= s - i < ks)


def k_pad32(taps: int) -> int:
    """Taps rounded up to the int8 k step (32): K6's slices and sums."""
    return -(-taps // 32) * 32


def stages_per_pair(impl: str, taps: int) -> int:
    """Ring stages of one pair: K6 over ``k_pad32(taps)``, K7 over
    ``taps``."""
    k_end = k_pad32(taps) if impl == "hp8" else taps
    return -(-k_end // STAGE_TAPS[impl])


def _stage_tiles(x: torch.Tensor, stage: int, k_major: bool) -> torch.Tensor:
    """``x [2 (cos, sin), rows, nbp]``, rows a multiple of ``stage`` ->
    ``[n_chunks, stages, tile]``. A chunk's 64 bins are 16 column groups
    of 8 (group ``G``: warpgroup ``G // 8``'s bins ``32 (G // 8) + 8 (G %
    4)``, cos where ``G % 8 < 4``, else sin); a group holds the stage's
    taps as core matrices: K-major ``[16-tap group][8 columns][16 taps]``,
    or N contiguous ``[tap][8 columns]``."""
    _, rows, nbp = x.shape
    st, nc = rows // stage, nbp // CHUNK_BINS
    if k_major:
        y = x.reshape(2, st, stage // 16, 16, nc, 2, 4, 8).permute(
            4, 1, 5, 0, 6, 2, 7, 3)
    else:
        y = x.reshape(2, st, stage, nc, 2, 4, 8).permute(3, 1, 4, 0, 5, 2, 6)
    return y.reshape(nc, st, -1)


def ring_tiles(impl: str, planes, ks: int, cutoff: int, n_bins_pad: int,
               taps: int) -> torch.Tensor:
    """The kernel's B operand, cut into ring stages: K6 ``[n_pairs,
    n_chunks, stages, 16384]`` int8, pair ``p = (i, j)`` of
    ``pair_table``'s plane ``j`` as slice ``i``'s matrix holds it (``[cos_0
    .. cos_J | sin_0 .. sin_J]``); K7 ``[ks, n_chunks, stages, 8192]``
    float16, plane ``j`` of ``(cs, ss)``, rows in ``K7_TAP_ORDER``. Raises ``ValueError`` for K7
    planes that float16 does not hold exactly."""
    nbp = n_bins_pad
    rows = stages_per_pair(impl, taps) * STAGE_TAPS[impl]

    def padded(cos, sin):
        x = torch.stack([cos[:taps], sin[:taps]])
        return torch.nn.functional.pad(x, (0, 0, 0, rows - taps))

    if impl == "hp8":
        blocks = []
        for i, j, _ in pair_table(ks, cutoff):
            m = planes[i]
            n_p = m.shape[1] // (2 * nbp)
            x = padded(m[:, j * nbp:(j + 1) * nbp],
                       m[:, (n_p + j) * nbp:(n_p + j + 1) * nbp])
            blocks.append(_stage_tiles(x, STAGE_TAPS[impl], True))
        return torch.stack(blocks).contiguous()
    cs, ss = planes
    blocks = []
    for j in range(ks):
        x = padded(cs[:, j * nbp:(j + 1) * nbp],
                   ss[:, j * nbp:(j + 1) * nbp]).to(torch.float32)
        h = x.to(torch.float16)
        if not torch.equal(h.to(torch.float32), x):
            raise ValueError("K7 takes planes that float16 holds exactly "
                             "(its integer slices have |M| <= 128)")
        h = h.reshape(2, rows // 16, 16, nbp)[:, :, list(K7_TAP_ORDER)]
        h = h.reshape(2, rows, nbp)
        blocks.append(_stage_tiles(h, STAGE_TAPS[impl], False))
    return torch.stack(blocks).contiguous()


def l2_tile_bytes(impl: str, ks: int, cutoff: int, taps: int,
                  n_bins_pad: int, n_rows: int, block_frames: int) -> int:
    """The ring-tile bytes one launch copies from L2, counted from the
    loads (not measured): every block reads each pair's tiles once per
    chunk (K7: a pair reads its plane's tiles)."""
    blocks = -(-n_rows // block_frames)
    per_block = (len(pair_table(ks, cutoff)) * stages_per_pair(impl, taps)
                 * (n_bins_pad // CHUNK_BINS) * TILE_BYTES)
    return blocks * per_block


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("framed_ozaki").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_framed_ozaki.argtypes = [
        i, p, ll, i, i,   # scheme, frames, n_rows, ld, taps
        p, i, i, i,       # tiles, nbp, ks, cutoff
        p, i, i,          # mt, n_mels, nmp
        p, p, p,          # out, power, stream
    ]
    lib.melspec_framed_ozaki.restype = ctypes.c_int
    lib.melspec_framed_ozaki_plan.argtypes = [i, i, i, ctypes.POINTER(ll)]
    lib.melspec_framed_ozaki_plan.restype = ctypes.c_int
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def plan(ks: int, taps: int, n_mels_pad: int) -> tuple:
    """``(frames per block, shared memory bytes)`` the built kernel takes
    for these arguments (64, 32 or 16 frames; 0 where none fits)."""
    smem = ctypes.c_longlong(0)
    tile = _bound().melspec_framed_ozaki_plan(ks, taps, n_mels_pad,
                                              ctypes.byref(smem))
    return int(tile), int(smem.value)


def run(frames: torch.Tensor, impl: str, tiles: torch.Tensor,
        mt: torch.Tensor, *, ks: int, cutoff: int, n_mels: int, taps: int,
        power: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of K6 / K7 on arguments ``framed_mel`` has checked
    (contiguous float32 frames and mt on the frames' device) and the
    scheme's ``ring_tiles`` for ``taps``; ``power`` (``[N, n_bins_pad]``
    float32) also receives the DFT power. Returns the log-mel ``[N,
    n_mels]``."""
    name = {"hp8": "K6", "hp_bf16": "K7"}[impl]
    nbp, nmp = mt.shape
    tile, smem = plan(ks, taps, nmp)
    if tile == 0:
        raise NotImplementedError(
            f"{name} needs {smem} bytes of shared memory for {taps} taps, "
            f"{ks} signal slices, {nmp} mel columns at 16 frames a block; "
            f"a block has {MAX_SMEM_BYTES}")
    dev = frames.device
    n = frames.shape[0]
    out = torch.empty((n, n_mels), dtype=torch.float32, device=dev)
    if power is not None and (power.shape != (n, nbp) or not
                              power.is_contiguous()
                              or power.dtype != torch.float32):
        raise ValueError(f"power must be a contiguous float32 [{n}, {nbp}]")
    if n == 0:
        return out
    lib = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.melspec_framed_ozaki(
            SCHEME[impl], frames.data_ptr(), n, frames.shape[1], taps,
            tiles.data_ptr(), nbp, ks, cutoff, mt.data_ptr(),
            n_mels, nmp, out.data_ptr(),
            None if power is None else power.data_ptr(), stream)
    raise_for(lib, rc, f"{name} (framed_ozaki, {impl})")
    return out
