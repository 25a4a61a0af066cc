"""K5-K8: whisper log-mel of pre-framed ``[N, k_pad]`` frames through the
precision dial's four DFT schemes — the CUDA kernel (``csrc/framed_mel.cu``,
one template over the scheme), the plain PyTorch version of each, and the
wrapper that picks between them by the device the frames lie on.

| kernel | ``impl`` | replaces (``melspec_tpu/ops/mel_kernel.py``) | DFT |
|---|---|---|---|
| K5 | ``"bf3"`` | ``_bf3_mel_tile_kernel`` via ``_pallas_bf3_mel_frames`` | rounded-bf16 slice pairs |
| K6 | ``"hp8"`` | ``_hp8_mel_tile_kernel`` via ``_pallas_hp8_mel_frames`` | int8 Ozaki |
| K7 | ``"hp_bf16"`` | ``_hp_mel_tile_kernel`` via ``_pallas_hp_mel_frames`` | bf16-integer Ozaki |
| K8 | ``"f32"`` | ``_mel_tile_kernel`` via ``_pallas_mel_frames`` | float32 |

``framed_mel`` launches the kernel for a CUDA tensor (or raises) and runs
the plain version only for a CPU tensor, with the DFT dot summed in
float64 there (the f32 sum of a CPU BLAS changes with its thread count).
``launches`` counts kernel launches by kernel name; nothing else adds to
it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.kernels.sig_mel import (MAX_SMEM_BYTES, out_vals,
                                               raise_for)
from melspec_tpu_torch.ops.hp_dft import (_signal_slices, combine_groups,
                                          pow2_row_scale, two_float_power)

IMPLS = ("bf3", "hp8", "hp_bf16", "f32")
KERNEL = {"bf3": "K5", "hp8": "K6", "hp_bf16": "K7", "f32": "K8"}
# the scheme numbers of csrc/framed_mel.cu
_SCHEME = {"f32": 0, "bf3": 1, "hp8": 2, "hp_bf16": 3}
# the kernel's largest tile of frames per block; the callers pad the
# frame count to it (csrc/framed_mel.cu: plan_tile)
TILE_FRAMES = 32
MAX_SLICES = 6
MAX_MELS_PAD = 256
# bins per chunk of the kernel's loop: the plane matrices' column blocks
# are multiples of it
CHUNK_BINS = 128

launches = dict.fromkeys(KERNEL.values(), 0)


@dataclasses.dataclass(frozen=True)
class FramedMatrices:
    """One scheme's device matrices, as the JAX package passes them to its
    kernel, and its slice schedule.

    - ``"bf3"`` / ``"hp8"``: ``planes[i]`` is signal slice ``i``'s matrix
      ``[k_pad, 2 * n_p(i) * n_bins_pad]``, its cos planes ``0 .. n_p(i) -
      1`` then its sin planes, with ``n_p(i) = min(cutoff - i, ks - 1) +
      1`` (bf16 rounded slices; int8 7-bit slices clipped to +-127);
    - ``"hp_bf16"``: ``planes = (cs, ss)``, the ``ks`` integer-valued bf16
      cos planes and sin planes side by side ``[k_pad, ks * n_bins_pad]``;
    - ``"f32"``: ``planes = (cw, sw)``, the window-folded float32 cos and
      sin matrices ``[k_pad, n_bins_pad]``.

    ``mt`` is the float32 projection ``[n_bins_pad, n_mels_pad]``. There
    are ``ks`` signal slices and as many matrix planes; the pairs ``(i,
    j)`` with ``i + j <= cutoff`` are kept."""

    impl: str
    planes: tuple
    mt: torch.Tensor
    ks: int = 1
    cutoff: int = 0

    @property
    def n_bins_pad(self) -> int:
        return self.mt.shape[0]

    def to(self, device) -> "FramedMatrices":
        return dataclasses.replace(
            self, planes=tuple(p.to(device) for p in self.planes),
            mt=self.mt.to(device))


def _dot(a: torch.Tensor, b: torch.Tensor, dot_dtype) -> torch.Tensor:
    """One matmul in ``dot_dtype``, rounded to float32: float32 as in the
    JAX kernels, or float64, which sums products of slice values exactly
    before one rounding."""
    return (a.to(dot_dtype) @ b.to(dot_dtype)).to(torch.float32)


def _whisper(power: torch.Tensor, mt: torch.Tensor) -> torch.Tensor:
    """Projection (float32), log10 floor and whisper norm of the padded
    mel row: the shared epilogue of the four kernels."""
    return out_vals(power @ mt.to(torch.float32), "whisper", 0.0)


def f32_mel_reference(frames, cw, sw, mt, *,
                      dot_dtype=torch.float32) -> torch.Tensor:
    """K8's math (``_mel_tile_kernel``): frames ``[N, k_pad]`` @ the
    window-folded cos / sin matrices, power, projection, whisper epilogue
    -> ``[N, n_mels_pad]``."""
    fr = frames.to(torch.float32)
    re = _dot(fr, cw, dot_dtype)
    im = _dot(fr, sw, dot_dtype)
    return _whisper(re * re + im * im, mt)


def bf3_mel_reference(frames, mt, *slice_mats, ks: int, km: int,
                      cutoff: int, dot_dtype=torch.float32) -> torch.Tensor:
    """K5's math (``_bf3_mel_tile_kernel``): the bf16 residual cascade of
    the frames (round to nearest even), one dot per signal slice against
    its plane concat, the pair groups ``s = i + j`` added in increasing
    ``i``, the groups summed largest-first in float32, power, projection,
    whisper epilogue -> ``[N, n_mels_pad]``."""
    n_bins_pad = mt.shape[0]
    residual = frames.to(torch.float32)
    groups: dict = {}
    for i in range(ks):
        xs = residual.to(torch.bfloat16)
        if i + 1 < ks:
            residual = residual - xs.to(torch.float32)
        n_p = min(cutoff - i, km - 1) + 1
        y = _dot(xs, slice_mats[i], dot_dtype)
        for j in range(n_p):
            s = i + j
            yr = y[:, j * n_bins_pad : (j + 1) * n_bins_pad]
            yi = y[:, (n_p + j) * n_bins_pad : (n_p + j + 1) * n_bins_pad]
            if s not in groups:
                groups[s] = (yr, yi)
            else:
                groups[s] = (groups[s][0] + yr, groups[s][1] + yi)
    order = sorted(groups)
    re, im = groups[order[0]]
    for s in order[1:]:
        re = re + groups[s][0]
        im = im + groups[s][1]
    return _whisper(re * re + im * im, mt)


def hp8_mel_reference(frames, mt, *slice_mats, ks: int, km: int,
                      cutoff: int, dot_dtype=torch.float32) -> torch.Tensor:
    """K6's math (``_hp8_mel_tile_kernel``): the power-of-two row scale,
    7-bit integer signal slices, per slice one dot against its int8 plane
    concat (an exact integer: float32 holds it), the same-scale groups
    summed in int32, scaled and chained through two-sums, the two-float
    power, projection, whisper epilogue -> ``[N, n_mels_pad]``."""
    n_bins_pad = mt.shape[0]
    fr = frames.to(torch.float32)
    sigma = pow2_row_scale(fr)
    groups_re: dict = {}
    groups_im: dict = {}
    for i, t in enumerate(_signal_slices(fr / sigma, ks)):
        n_p = min(cutoff - i, km - 1) + 1
        y = _dot(t, slice_mats[i], dot_dtype).to(torch.int32)
        for j in range(n_p):
            s = i + j
            yr = y[:, j * n_bins_pad : (j + 1) * n_bins_pad]
            yi = y[:, (n_p + j) * n_bins_pad : (n_p + j + 1) * n_bins_pad]
            groups_re[s] = yr if s not in groups_re else groups_re[s] + yr
            groups_im[s] = yi if s not in groups_im else groups_im[s] + yi

    def as_f32(groups):
        return {s: g.to(torch.float32) for s, g in groups.items()}

    power = two_float_power(combine_groups(as_f32(groups_re)),
                            combine_groups(as_f32(groups_im)), sigma)
    return _whisper(power, mt)


def hp_mel_reference(frames, cs, ss, mt, *, n_slices: int, max_pair_sum: int,
                     dot_dtype=torch.float32) -> torch.Tensor:
    """K7's math (``_hp_mel_tile_kernel``): the row scale and 7-bit
    integer slices of K6, one wide dot per signal slice against the
    integer-valued bf16 planes (exact in float32), the pairs ``i + j <=
    max_pair_sum`` grouped by scale in increasing ``i`` (float32 adds),
    chained through two-sums, the two-float power, projection, whisper
    epilogue -> ``[N, n_mels_pad]``."""
    fr = frames.to(torch.float32)
    sigma = pow2_row_scale(fr)
    x_slices = _signal_slices(fr / sigma, n_slices)

    def component(c_all):
        n_bins_pad = c_all.shape[1] // n_slices
        groups: dict = {}
        for i, xs in enumerate(x_slices):
            y_all = _dot(xs, c_all, dot_dtype)
            for j in range(n_slices):
                if i + j > max_pair_sum:
                    continue
                y = y_all[:, j * n_bins_pad : (j + 1) * n_bins_pad]
                s = i + j
                groups[s] = y if s not in groups else groups[s] + y
        return combine_groups(groups)

    return _whisper(two_float_power(component(cs), component(ss), sigma),
                    mt)


def framed_mel_reference(frames: torch.Tensor, mats: FramedMatrices, *,
                         n_mels: int,
                         dot_dtype=torch.float32) -> torch.Tensor:
    """The plain version of ``mats.impl``'s kernel on whatever device the
    frames lie on: ``[N, k_pad]`` -> ``[N, n_mels]``."""
    if mats.impl == "f32":
        out = f32_mel_reference(frames, *mats.planes, mats.mt,
                                dot_dtype=dot_dtype)
    elif mats.impl == "hp_bf16":
        out = hp_mel_reference(frames, *mats.planes, mats.mt,
                               n_slices=mats.ks, max_pair_sum=mats.cutoff,
                               dot_dtype=dot_dtype)
    else:
        fn = bf3_mel_reference if mats.impl == "bf3" else hp8_mel_reference
        out = fn(frames, mats.mt, *mats.planes, ks=mats.ks, km=mats.ks,
                 cutoff=mats.cutoff, dot_dtype=dot_dtype)
    return out[:, :n_mels].contiguous()


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("framed_mel").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_framed_mel.argtypes = [
        i, p, ll, i, i,   # scheme, frames, n_rows, ld, taps
        p, p, p, i,       # re[], im[], ldm[], nbp
        i, i,             # ks, cutoff
        p, i, i,          # mt, n_mels, nmp
        p, p,             # out, stream
    ]
    lib.melspec_framed_mel.restype = ctypes.c_int
    lib.melspec_framed_mel_plan.argtypes = [i, i, i, i,
                                            ctypes.POINTER(ll)]
    lib.melspec_framed_mel_plan.restype = ctypes.c_int
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _plan(impl: str, ks: int, taps: int, n_mels_pad: int) -> tuple:
    """``(frames per block, shared memory bytes)`` the built kernel takes
    for these arguments; 0 frames where no tile fits a block."""
    smem = ctypes.c_longlong(0)
    tile = _bound().melspec_framed_mel_plan(_SCHEME[impl], ks, taps,
                                            n_mels_pad, ctypes.byref(smem))
    return int(tile), int(smem.value)


def _slice_table(mats: FramedMatrices, taps: int, dev) -> tuple:
    """Per signal slice: (re plane 0 pointer, im plane 0 pointer, row
    stride in elements), checked against the schedule."""
    impl, nbp = mats.impl, mats.n_bins_pad
    want = {"bf3": torch.bfloat16, "hp8": torch.int8,
            "hp_bf16": torch.bfloat16, "f32": torch.float32}[impl]
    planes = tuple(m.contiguous() for m in mats.planes)
    for m in planes:
        if m.dtype != want or m.device != dev or m.dim() != 2 \
                or m.shape[0] < taps:
            raise ValueError(f"{KERNEL[impl]} takes {want} plane matrices "
                             f"of >= {taps} rows on the frames' device; got "
                             f"{m.dtype} {tuple(m.shape)} on {m.device}")
    esize = planes[0].element_size()
    if impl in ("bf3", "hp8"):
        if len(planes) != mats.ks:
            raise ValueError(f"{KERNEL[impl]} takes one plane matrix per "
                             f"signal slice ({mats.ks}); got {len(planes)}")
        rows = []
        for i, m in enumerate(planes):
            n_p = min(mats.cutoff - i, mats.ks - 1) + 1
            if n_p < 1 or m.shape[1] != 2 * n_p * nbp:
                raise ValueError(f"slice {i}'s matrix must have 2 * {n_p} "
                                 f"planes of {nbp} columns; got "
                                 f"{tuple(m.shape)}")
            rows.append((m.data_ptr(), m.data_ptr() + n_p * nbp * esize,
                         m.shape[1]))
    else:
        width = nbp * (mats.ks if impl == "hp_bf16" else 1)
        if len(planes) != 2 or any(m.shape[1] != width for m in planes):
            raise ValueError(f"{KERNEL[impl]} takes (re, im) matrices of "
                             f"{width} columns")
        rows = [(planes[0].data_ptr(), planes[1].data_ptr(), width)] * mats.ks
    return planes, rows


def _launch(frames: torch.Tensor, mats: FramedMatrices, *, n_mels: int,
            taps: int) -> torch.Tensor:
    impl = mats.impl
    name = KERNEL[impl]
    dev = frames.device
    if frames.dtype != torch.float32 or frames.dim() != 2:
        raise ValueError(f"{name} takes [N, k_pad] float32 frames")
    mt = mats.mt.contiguous()
    nbp, nmp = mt.shape
    if mt.dtype != torch.float32 or mt.device != dev:
        raise ValueError("mt must be float32 on the frames' device")
    if nbp % CHUNK_BINS or nmp % 128 or nmp > MAX_MELS_PAD \
            or not 0 < n_mels <= nmp:
        raise NotImplementedError(
            f"{name} takes mt [n_bins_pad, n_mels_pad] with n_bins_pad a "
            f"multiple of {CHUNK_BINS} and n_mels_pad a multiple of 128 up "
            f"to {MAX_MELS_PAD} (n_mels {n_mels}); got {tuple(mt.shape)}")
    if not (0 < mats.ks <= MAX_SLICES and mats.cutoff >= 0):
        raise ValueError(f"{name} takes <= {MAX_SLICES} signal slices; got "
                         f"ks {mats.ks}, cutoff {mats.cutoff}")
    if not 0 < taps <= frames.shape[1]:
        raise ValueError(f"taps {taps} outside the frame of "
                         f"{frames.shape[1]}")
    planes, rows = _slice_table(mats, taps, dev)
    tile, smem = _plan(impl, mats.ks, taps, nmp)
    if tile == 0:
        raise NotImplementedError(
            f"{name} needs {smem} bytes of shared memory for {taps} taps, "
            f"{mats.ks} signal slices, {nmp} mel columns at 16 frames a "
            f"block; a block has {MAX_SMEM_BYTES}")
    frames = frames.contiguous()
    ptrs = [frames, mt, *planes]
    if any(t.data_ptr() % 16 for t in ptrs):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    n = frames.shape[0]
    out = torch.empty((n, n_mels), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    arr = ctypes.c_void_p * len(rows)
    re = arr(*(r[0] for r in rows))
    im = arr(*(r[1] for r in rows))
    ldm = (ctypes.c_int * len(rows))(*(r[2] for r in rows))
    lib = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.melspec_framed_mel(
            _SCHEME[impl], frames.data_ptr(), n, frames.shape[1], taps,
            re, im, ldm, nbp, mats.ks, mats.cutoff, mt.data_ptr(),
            n_mels, nmp, out.data_ptr(), stream)
    raise_for(lib, rc, f"{name} (framed_mel, {impl})")
    launches[name] += 1
    return out


def framed_mel(frames: torch.Tensor, mats: FramedMatrices, *, n_mels: int,
               taps: int | None = None) -> torch.Tensor:
    """``mats.impl``'s kernel on CUDA frames, its plain version (DFT dot
    summed in float64) on CPU ones: ``[N, k_pad]`` float32 -> ``[N,
    n_mels]``. The kernel contracts the first ``taps`` columns of each
    frame (all by default); the columns past them must be zero, as the
    padding to ``k_pad`` is."""
    if mats.impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}")
    if frames.device.type == "cuda":
        return _launch(frames, mats, n_mels=n_mels,
                       taps=frames.shape[1] if taps is None else taps)
    if frames.device.type == "cpu":
        return framed_mel_reference(frames, mats, n_mels=n_mels,
                                    dot_dtype=torch.float64)
    raise ValueError(f"unsupported device {frames.device}")
