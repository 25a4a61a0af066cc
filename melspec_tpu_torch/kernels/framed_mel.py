"""K5-K8: whisper log-mel of pre-framed ``[N, k_pad]`` frames through
the precision dial's four DFT schemes — the plain PyTorch version of each,
the argument checks of their kernels (``csrc/framed_ozaki.cu``, launcher
``kernels/framed_ozaki.py``), and the wrapper that picks between them by
the device the frames lie on.

| kernel | ``impl`` | replaces (``melspec_tpu/ops/mel_kernel.py``) | DFT on the tensor cores |
|---|---|---|---|
| K5 | ``"bf3"`` | ``_bf3_mel_tile_kernel`` via ``_pallas_bf3_mel_frames`` | rounded-bf16 slice pairs, bf16 ``wgmma`` |
| K6 | ``"hp8"`` | ``_hp8_mel_tile_kernel`` via ``_pallas_hp8_mel_frames`` | int8 Ozaki, int8 ``wgmma`` |
| K7 | ``"hp_bf16"`` | ``_hp_mel_tile_kernel`` via ``_pallas_hp_mel_frames`` | integer Ozaki, float16 ``wgmma`` |
| K8 | ``"f32"`` | ``_mel_tile_kernel`` via ``_pallas_mel_frames`` | float32 as 3xTF32, TF32 ``wgmma`` |

``framed_mel`` launches the kernel for a CUDA tensor (or raises) and runs
the plain version only for a CPU tensor, with the DFT dot summed in
float64 there (the f32 sum of a CPU BLAS changes with its thread count).
``launches`` counts kernel launches by kernel name; nothing else adds to
it. ``ozaki_power`` returns K6's or K7's DFT power (written before the
projection) for the checks that hold it to ``ozaki_power_reference``
bit for bit; its launches are not counted.
"""

from __future__ import annotations

import dataclasses

import torch

from melspec_tpu_torch.kernels import framed_ozaki
from melspec_tpu_torch.kernels.sig_mel import out_vals
from melspec_tpu_torch.ops.hp_dft import (_signal_slices, combine_groups,
                                          pow2_row_scale, two_float_power)

IMPLS = ("bf3", "hp8", "hp_bf16", "f32")
KERNEL = framed_ozaki.KERNEL
OZAKI = ("hp8", "hp_bf16")
MAX_SLICES = 6
MAX_MELS_PAD = 256
# the plane matrices' column blocks (n_bins_pad) are multiples of it, as
# the host builds them (the kernels walk chunks of 64 bins)
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
    # the kernel's ring tiles by taps, built at its first launch
    _tiles: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def n_bins_pad(self) -> int:
        return self.mt.shape[0]

    def ring_tiles(self, taps: int) -> torch.Tensor:
        """``framed_ozaki.ring_tiles`` of these planes, built once per
        ``taps`` and kept with the matrices."""
        if taps not in self._tiles:
            self._tiles[taps] = framed_ozaki.ring_tiles(
                self.impl, self.planes, self.ks, self.cutoff,
                self.n_bins_pad, taps)
        return self._tiles[taps]

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


def hp8_power_reference(frames, *slice_mats, ks: int, km: int,
                        cutoff: int, dot_dtype=torch.float32) -> torch.Tensor:
    """K6's DFT power (``_hp8_mel_tile_kernel`` up to its projection): the
    power-of-two row scale, 7-bit integer signal slices, per slice one dot
    against its int8 plane concat (an exact integer: float32 holds it), the
    same-scale groups summed in int32, scaled and chained through
    two-sums, the two-float power -> ``[N, n_bins_pad]``."""
    n_bins_pad = slice_mats[0].shape[1] // (2 * (min(cutoff, km - 1) + 1))
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

    return two_float_power(combine_groups(as_f32(groups_re)),
                           combine_groups(as_f32(groups_im)), sigma)


def hp8_mel_reference(frames, mt, *slice_mats, ks: int, km: int,
                      cutoff: int, dot_dtype=torch.float32) -> torch.Tensor:
    """K6's math (``_hp8_mel_tile_kernel``): ``hp8_power_reference``, then
    projection and whisper epilogue -> ``[N, n_mels_pad]``."""
    return _whisper(hp8_power_reference(frames, *slice_mats, ks=ks, km=km,
                                        cutoff=cutoff, dot_dtype=dot_dtype),
                    mt)


def hp_power_reference(frames, cs, ss, *, n_slices: int, max_pair_sum: int,
                       dot_dtype=torch.float32) -> torch.Tensor:
    """K7's DFT power (``_hp_mel_tile_kernel`` up to its projection): the
    row scale and 7-bit integer slices of K6, one wide dot per signal
    slice against the integer-valued bf16 planes (exact in float32), the
    pairs ``i + j <= max_pair_sum`` grouped by scale in increasing ``i``
    (float32 adds), chained through two-sums, the two-float power ->
    ``[N, n_bins_pad]``."""
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

    return two_float_power(component(cs), component(ss), sigma)


def hp_mel_reference(frames, cs, ss, mt, *, n_slices: int, max_pair_sum: int,
                     dot_dtype=torch.float32) -> torch.Tensor:
    """K7's math (``_hp_mel_tile_kernel``): ``hp_power_reference``, then
    projection and whisper epilogue -> ``[N, n_mels_pad]``."""
    return _whisper(hp_power_reference(frames, cs, ss, n_slices=n_slices,
                                       max_pair_sum=max_pair_sum,
                                       dot_dtype=dot_dtype), mt)


def ozaki_power_reference(frames: torch.Tensor, mats: FramedMatrices, *,
                          dot_dtype=torch.float32) -> torch.Tensor:
    """The DFT power ``[N, n_bins_pad]`` of K6's or K7's plain version."""
    if mats.impl == "hp8":
        return hp8_power_reference(frames, *mats.planes, ks=mats.ks,
                                   km=mats.ks, cutoff=mats.cutoff,
                                   dot_dtype=dot_dtype)
    if mats.impl == "hp_bf16":
        return hp_power_reference(frames, *mats.planes, n_slices=mats.ks,
                                  max_pair_sum=mats.cutoff,
                                  dot_dtype=dot_dtype)
    raise ValueError(f"impl must be one of {OZAKI}; got {mats.impl!r}")


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


def _checked_planes(mats: FramedMatrices, taps: int, dev) -> None:
    """The plane matrices against the scheme's dtype and schedule."""
    impl, nbp = mats.impl, mats.n_bins_pad
    want = {"bf3": torch.bfloat16, "hp8": torch.int8,
            "hp_bf16": torch.bfloat16, "f32": torch.float32}[impl]
    for m in mats.planes:
        if m.dtype != want or m.device != dev or m.dim() != 2 \
                or m.shape[0] < taps:
            raise ValueError(f"{KERNEL[impl]} takes {want} plane matrices "
                             f"of >= {taps} rows on the frames' device; got "
                             f"{m.dtype} {tuple(m.shape)} on {m.device}")
    if impl in ("bf3", "hp8"):
        if len(mats.planes) != mats.ks:
            raise ValueError(f"{KERNEL[impl]} takes one plane matrix per "
                             f"signal slice ({mats.ks}); got "
                             f"{len(mats.planes)}")
        for i, m in enumerate(mats.planes):
            n_p = min(mats.cutoff - i, mats.ks - 1) + 1
            if n_p < 1 or m.shape[1] != 2 * n_p * nbp:
                raise ValueError(f"slice {i}'s matrix must have 2 * {n_p} "
                                 f"planes of {nbp} columns; got "
                                 f"{tuple(m.shape)}")
        return
    width = nbp * (mats.ks if impl == "hp_bf16" else 1)
    if len(mats.planes) != 2 or any(m.shape[1] != width
                                    for m in mats.planes):
        raise ValueError(f"{KERNEL[impl]} takes (re, im) matrices of "
                         f"{width} columns")
    if impl == "f32" and (mats.ks, mats.cutoff) != (1, 0):
        raise ValueError(f"K8 takes one slice (ks 1, cutoff 0); got ks "
                         f"{mats.ks}, cutoff {mats.cutoff}")


def _checked(frames: torch.Tensor, mats: FramedMatrices, *, n_mels: int,
             taps: int) -> tuple:
    """The launch's argument checks: ``(frames, mt)``, contiguous on the
    frames' device."""
    name = KERNEL[mats.impl]
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
    _checked_planes(mats, taps, dev)
    frames = frames.contiguous()
    if any(t.data_ptr() % 16 for t in (frames, mt)):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    return frames, mt


def _launch(frames: torch.Tensor, mats: FramedMatrices, *, n_mels: int,
            taps: int) -> torch.Tensor:
    frames, mt = _checked(frames, mats, n_mels=n_mels, taps=taps)
    out = framed_ozaki.run(frames, mats.impl, mats.ring_tiles(taps), mt,
                           ks=mats.ks, cutoff=mats.cutoff, n_mels=n_mels,
                           taps=taps)
    if frames.shape[0]:
        launches[KERNEL[mats.impl]] += 1
    return out


def ozaki_power(frames: torch.Tensor, mats: FramedMatrices, *,
                taps: int | None = None) -> tuple:
    """K6's or K7's launch on CUDA frames with its DFT power written out:
    ``(power [N, n_bins_pad], log-mel [N, n_mels_pad])``, for the checks
    against ``ozaki_power_reference``. Not counted in ``launches``."""
    if mats.impl not in OZAKI or frames.device.type != "cuda":
        raise ValueError("ozaki_power takes hp8 / hp_bf16 matrices and CUDA "
                         "frames")
    taps = frames.shape[1] if taps is None else taps
    nmp = mats.mt.shape[1]
    frames, mt = _checked(frames, mats, n_mels=nmp, taps=taps)
    power = torch.empty((frames.shape[0], mt.shape[0]), dtype=torch.float32,
                        device=frames.device)
    out = framed_ozaki.run(frames, mats.impl, mats.ring_tiles(taps), mt,
                           ks=mats.ks, cutoff=mats.cutoff, n_mels=nmp,
                           taps=taps, power=power)
    return power, out


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
