"""K5-K8 on the tensor cores: the launcher of ``csrc/framed_ozaki.cu``
and its host-side tables.

``kernels/framed_mel.py`` checks the arguments of every framed kernel and
routes all four schemes here: ``"bf3"`` (K5), ``"hp8"`` (K6),
``"hp_bf16"`` (K7) and ``"f32"`` (K8); their plain versions stay there.
The tables are plain PyTorch, so the CPU tests rebuild the kernels' sums
from them:

- ``pair_table(ks, cutoff)``: the kept slice pairs ``(i, j, s = i + j)``
  in the kernels' order, ``s`` ascending, then ``i`` ascending (K7 adds a
  group's pairs in that order; K6, K5 and K8 run a group's pairs one
  after another along K in one accumulation); K8 runs K5's scheme at
  ``K8_SCHEDULE`` (``kernel_schedule``);
- ``ring_tiles``: the planes cut into the kernels' ring stages, each
  stage one contiguous tile in the byte order of the kernel's shared
  memory (``wgmma``'s no-swizzle core matrices of 8 x 16 bytes), so a
  block copies a stage with whole, aligned 16-byte loads. K6: a block of
  tiles per pair, the pair's plane K-major (8-bit ``wgmma`` reads B only
  K-major), 128 taps a stage; K7: a block per plane, N contiguous, 64
  taps a stage, as float16 (the planes are integers of at most 128, so
  float16 holds them exactly, and the kernel widens its int8 slices to
  float16 with integer operations), each 16 rows in ``K7_TAP_ORDER``; K5:
  a block per pair, the pair's bf16 plane N contiguous in tap order, 64
  taps a stage; K8: as K5, from ``bf16_slices`` of the float32 cos / sin
  matrices. Taps past ``taps`` are zero.
  ``FramedMatrices.ring_tiles`` builds them once per matrix set and
  keeps them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.kernels.sig_mel import MAX_SMEM_BYTES, raise_for

# the scheme numbers of csrc/framed_ozaki.cu: K8 runs K5's scheme
SCHEME = {"hp8": 0, "hp_bf16": 1, "bf3": 2, "f32": 2}
KERNEL = {"bf3": "K5", "hp8": "K6", "hp_bf16": "K7", "f32": "K8"}
# each scheme's tensor-core instruction (csrc/framed_ozaki.cu::wgmma_step)
MMA = {"bf3": "wgmma m64n64k16 bf16", "hp8": "wgmma m64n64k32 s8",
       "hp_bf16": "wgmma m64n64k16 f16", "f32": "wgmma m64n64k16 bf16"}
# K8's float32 DFT as the TPU computes Precision.HIGHEST: three rounded
# bf16 slices of frame and matrix, the pairs i + j <= 2 (3xTF32 misses the
# JFK gate: tests/test_torch_framed_tc.py)
K8_SCHEDULE = (3, 2)
# bins per chunk of the kernels' walk (framed_mel checks that n_bins_pad
# is a multiple of its 128)
CHUNK_BINS = 64
# taps of a ring stage (four wgmma k steps) and its bytes
STAGE_TAPS = {"hp8": 128, "hp_bf16": 64, "bf3": 64, "f32": 64}
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


def kernel_schedule(impl: str, ks: int, cutoff: int) -> tuple:
    """The ``(ks, cutoff)`` the kernel of ``impl`` runs: the matrices'
    own, or ``K8_SCHEDULE`` for K8 (whose ``FramedMatrices`` hold one
    float32 slice)."""
    return K8_SCHEDULE if impl == "f32" else (ks, cutoff)


def schedule(impl: str, ks: int, cutoff: int) -> tuple:
    """The pairs ``(i, j, s)`` the kernel of ``impl`` runs, in its
    order."""
    return pair_table(*kernel_schedule(impl, ks, cutoff))


def bf16_slices(m: torch.Tensor, n: int) -> tuple:
    """K8's matrix split: ``n`` rounded-bf16 slices of float32 ``m``, each
    the bf16 rounding (nearest even) of the residual so far (each
    subtraction exact in float32), as ``ops/hp_dft.py::bf16_round_slices``
    cuts float64 matrices."""
    r = m.to(torch.float32)
    out = []
    for _ in range(n):
        s = r.to(torch.bfloat16)
        out.append(s)
        r = r - s.to(torch.float32)
    return tuple(out)


def k_pad32(taps: int) -> int:
    """Taps rounded up to the int8 k step (32): K6's slices and sums."""
    return -(-taps // 32) * 32


def stages_per_pair(impl: str, taps: int) -> int:
    """Ring stages of one pair: K6 over ``k_pad32(taps)``, the others
    over ``taps``."""
    k_end = k_pad32(taps) if impl == "hp8" else taps
    return -(-k_end // STAGE_TAPS[impl])


def _stage_tiles(x: torch.Tensor, stage: int, k_major: bool) -> torch.Tensor:
    """``x [2 (cos, sin), rows, nbp]``, rows a multiple of ``stage`` ->
    ``[n_chunks, stages, tile]``. A chunk's 64 bins are 16 column groups
    of 8 (group ``G``: warpgroup ``G // 8``'s bins ``32 (G // 8) + 8 (G %
    4)``, cos where ``G % 8 < 4``, else sin); a group holds the stage's
    taps as core matrices: K-major ``[16-tap group][8 columns][16 taps]``
    (int8), or N contiguous ``[tap][8 columns]`` (16-bit values)."""
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
    n_chunks, stages, 16384]`` int8 and K5 ``[n_pairs, n_chunks, stages,
    8192]`` bfloat16, pair ``p = (i, j)`` of ``pair_table``'s plane ``j``
    as slice ``i``'s matrix holds it (``[cos_0 .. cos_J | sin_0 ..
    sin_J]``); K7 ``[ks, n_chunks, stages, 8192]`` float16, plane ``j`` of
    ``(cs, ss)``, rows in ``K7_TAP_ORDER``; K8 as K5, pair ``(i, j)`` of
    ``K8_SCHEDULE`` taking plane ``j`` of ``bf16_slices`` of ``(cw,
    sw)``. Raises ``ValueError`` for K7 planes that float16 does not hold
    exactly."""
    nbp = n_bins_pad
    stage = STAGE_TAPS[impl]
    rows = stages_per_pair(impl, taps) * stage

    def padded(cos, sin):
        x = torch.stack([cos[:taps], sin[:taps]])
        return torch.nn.functional.pad(x, (0, 0, 0, rows - taps))

    if impl in ("hp8", "bf3"):
        blocks = []
        for i, j, _ in pair_table(ks, cutoff):
            m = planes[i]
            n_p = m.shape[1] // (2 * nbp)
            x = padded(m[:, j * nbp:(j + 1) * nbp],
                       m[:, (n_p + j) * nbp:(n_p + j + 1) * nbp])
            blocks.append(_stage_tiles(x, stage, impl == "hp8"))
        return torch.stack(blocks).contiguous()
    if impl == "f32":
        ks8, _ = K8_SCHEDULE
        cos, sin = (bf16_slices(m, ks8) for m in planes)
        return torch.stack([
            _stage_tiles(padded(cos[j], sin[j]), stage, False)
            for _, j, _ in schedule(impl, ks, cutoff)]).contiguous()
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
        blocks.append(_stage_tiles(h, stage, False))
    return torch.stack(blocks).contiguous()


def l2_tile_bytes(impl: str, ks: int, cutoff: int, taps: int,
                  n_bins_pad: int, n_rows: int, block_frames: int) -> int:
    """The ring-tile bytes one launch copies from L2, counted from the
    loads (not measured): every block reads each pair's tiles once per
    chunk (K7: a pair reads its plane's tiles)."""
    blocks = -(-n_rows // block_frames)
    per_block = (len(schedule(impl, ks, cutoff)) * stages_per_pair(impl, taps)
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
    lib.melspec_framed_ozaki_plan.argtypes = [i, i, i, i,
                                              ctypes.POINTER(ll)]
    lib.melspec_framed_ozaki_plan.restype = ctypes.c_int
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def plan(impl: str, ks: int, taps: int, n_mels_pad: int) -> tuple:
    """``(frames per block, shared memory bytes)`` the built kernel of
    ``impl`` takes for these arguments (64, 32 or 16 frames; 0 where none
    fits)."""
    smem = ctypes.c_longlong(0)
    ks, _ = kernel_schedule(impl, ks, 0)
    tile = _bound().melspec_framed_ozaki_plan(SCHEME[impl], ks, taps,
                                              n_mels_pad, ctypes.byref(smem))
    return int(tile), int(smem.value)


def run(frames: torch.Tensor, impl: str, tiles: torch.Tensor,
        mt: torch.Tensor, *, ks: int, cutoff: int, n_mels: int, taps: int,
        power: torch.Tensor | None = None) -> torch.Tensor:
    """One launch of K5-K8 on arguments ``framed_mel`` has checked
    (contiguous float32 frames and mt on the frames' device) and the
    scheme's ``ring_tiles`` for ``taps``; ``power`` (``[N, n_bins_pad]``
    float32) also receives the DFT power. Returns the log-mel ``[N,
    n_mels]``."""
    name = KERNEL[impl]
    nbp, nmp = mt.shape
    ks, cutoff = kernel_schedule(impl, ks, cutoff)
    tile, smem = plan(impl, ks, taps, nmp)
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
