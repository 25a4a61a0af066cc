"""High-precision real DFT from exactly representable slices (port of
``melspec_tpu.ops.hp_dft``).

A plain float32 DFT leaves quiet spectral bins at the float32 roundoff
floor, and the whisper norm's 8-decade window exposes that floor. Two
slice schemes beat it with float32 arithmetic only:

- **hp** (integer Ozaki split): each row is scaled by a power of two so
  ``|x| < 1``, then the signal and the DFT matrices are cut into 7-bit
  integer slices. Every slice-pair dot sums products ``<= 2^14`` over
  ``<= 1024`` taps, so it is an exact integer in float32; the pairs with
  ``i + j <= max_pair_sum`` are grouped by scale and recombined with a
  compensated (two-sum) chain into a two-float value.
- **bf3** (rounded bf16 slices): successive bf16 roundings of the residual
  (scale-free, ~8 bits a level), pairs ``i + j <= cutoff`` with float32
  accumulation, summed largest-first. The window is folded into the
  float64 matrices before slicing.

Both run as plain PyTorch on every device: one float32 ``torch.matmul``
per signal slice against the column-concatenated planes, held in float32
(every slice value has at most 8 significant bits, so each product is
exact in float32 and in TF32). The fused whisper kernels on these schemes
are K5-K7 (``kernels/framed_mel.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from melspec_tpu_torch.ops import dft
from melspec_tpu_torch.ops.windows import hann_periodic

SLICE_BITS = 7
SLICE_SCALE = float(1 << SLICE_BITS)  # 128.0


def matrix_slices(mat, n_slices: int) -> Tuple[np.ndarray, ...]:
    """Slice a float64 matrix with ``|mat| <= 1`` into integer-valued
    float32 matrices: ``mat ~= sum_j M_j * 128^-(j+1)`` with ``|M_j| <=
    128``."""
    out = []
    residual = np.asarray(mat, np.float64).copy()
    for _ in range(n_slices):
        scaled = residual * SLICE_SCALE
        t = np.trunc(scaled)
        residual = scaled - t
        out.append(t.astype(np.float32))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _dft_matrix_slices(
    fft_size: int, n_bins: int, n_slices: int, windowed: bool,
    frame_len: int = 0,
) -> Tuple[Tuple[np.ndarray, ...], Tuple[np.ndarray, ...]]:
    """7-bit slices of the (optionally periodic-Hann-folded) DFT matrices;
    ``frame_len`` truncates them for zero-padded framing (Kaldi's
    400-in-512). Folding the window in keeps the signal path exact."""
    if windowed and frame_len:
        # a truncated full-fft Hann matches no real pipeline; a custom
        # window with zero-padded framing goes through
        # hp_rdft_power_windowed
        raise ValueError("windowed=True cannot combine with frame_len; "
                         "fold the real window via hp_rdft_power_windowed")
    cos_m, msin_m = dft.rdft_matrices(fft_size, n_bins)
    if frame_len:
        cos_m = cos_m[:frame_len]
        msin_m = msin_m[:frame_len]
    if windowed:
        w = hann_periodic(fft_size)[:, None]
        cos_m = w * cos_m
        msin_m = w * msin_m
    return matrix_slices(cos_m, n_slices), matrix_slices(msin_m, n_slices)


def _concat_f32(slices, device: torch.device) -> torch.Tensor:
    """Planes concatenated column-wise, as float32 on ``device`` (every
    value has at most 8 significant bits: exact)."""
    return torch.cat([torch.as_tensor(np.asarray(m, np.float32))
                      if isinstance(m, np.ndarray) else m.to(torch.float32)
                      for m in slices], dim=1).to(device)


@functools.lru_cache(maxsize=16)
def _hp_matrix(fft_size: int, n_bins: int, n_slices: int, windowed: bool,
               device: torch.device) -> torch.Tensor:
    cs, ss = _dft_matrix_slices(fft_size, n_bins, n_slices, windowed)
    return _concat_f32(cs + ss, device)


def hp_rdft_power_windowed(frames: torch.Tensor, window, fft_size: int,
                           n_bins: int, n_slices: int = 5,
                           max_pair_sum: int = 5) -> torch.Tensor:
    """hp power spectrum with an arbitrary float64 window folded into the
    sliced matrices. ``frames`` are RAW (unwindowed) ``[..., frame_len]``
    with ``frame_len = len(window) <= fft_size`` (implicit zero padding,
    like Kaldi's 400-sample frames in a 512 FFT)."""
    frame_len = len(window)
    w = np.asarray(window, np.float64)[:, None]
    # keyed on the window bytes themselves (a hash collision would return
    # the wrong matrices) and on the device, bounded like an lru_cache
    key = (fft_size, n_bins, n_slices, frame_len, w.tobytes(), frames.device)
    c_all = _windowed_cache.get(key)
    if c_all is None:
        cos_m, msin_m = dft.rdft_matrices(fft_size, n_bins)
        c_all = _concat_f32(
            matrix_slices(w * cos_m[:frame_len], n_slices)
            + matrix_slices(w * msin_m[:frame_len], n_slices), frames.device)
        if len(_windowed_cache) >= _WINDOWED_CACHE_MAX:
            _windowed_cache.pop(next(iter(_windowed_cache)))
        _windowed_cache[key] = c_all
    return _hp_power_from_slices(frames, c_all, n_bins, n_slices,
                                 max_pair_sum)


_windowed_cache: dict = {}
_WINDOWED_CACHE_MAX = 16


def bf16_round_slices(mat, n_slices: int) -> Tuple[torch.Tensor, ...]:
    """``mat ~= sum_j M_j`` with ``M_j`` bf16 and ``|M_j| <= 2^-8j |mat|``:
    each level is the bf16 rounding of the running float64 residual.

    The JAX package rounds float64 to bf16 through ``ml_dtypes``, which
    goes via float32 (two roundings). The explicit float64 -> float32 ->
    bf16 chain here reproduces that bit for bit. Returns CPU bf16
    tensors."""
    residual = torch.as_tensor(np.asarray(mat, np.float64))
    out = []
    for _ in range(n_slices):
        t = residual.to(torch.float32).to(torch.bfloat16)
        residual = residual - t.to(torch.float64)
        out.append(t)
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _bf3_matrix_planes(
    fft_size: int, n_bins: int, km: int, windowed: bool, frame_len: int = 0
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Rounded-bf16 planes of the (optionally Hann-folded) cos and -sin
    matrices (CPU bf16 tensors)."""
    cos_m, msin_m = dft.rdft_matrices(fft_size, n_bins)
    if frame_len:
        cos_m = cos_m[:frame_len]
        msin_m = msin_m[:frame_len]
    if windowed:
        w = hann_periodic(fft_size)[: cos_m.shape[0], None]
        cos_m = w * cos_m
        msin_m = w * msin_m
    return bf16_round_slices(cos_m, km), bf16_round_slices(msin_m, km)


@functools.lru_cache(maxsize=32)
def _bf3_matrix(fft_size: int, n_bins: int, km: int, windowed: bool,
                n_p: int, device: torch.device) -> torch.Tensor:
    """Signal slice ``i``'s matrix: cos planes ``[:n_p]`` then sin planes
    ``[:n_p]``, float32 on ``device``."""
    cos_p, sin_p = _bf3_matrix_planes(fft_size, n_bins, km, windowed)
    return _concat_f32(cos_p[:n_p] + sin_p[:n_p], device)


def bf3_rdft_power(frames: torch.Tensor, fft_size: int, n_bins: int,
                   ks: int = 3, km: int = 3, cutoff: int = 2,
                   hann_windowed: bool = False) -> torch.Tensor:
    """``|rfft(frames)|^2`` over the first ``n_bins`` bins via rounded-bf16
    slice pairs. ``frames`` are RAW (unwindowed) when ``hann_windowed``;
    float32 in, float32 power out."""
    x = frames.to(torch.float32)
    ks = min(ks, cutoff + 1)  # slices past the pair-sum budget pair with
    # nothing; without the clamp the plane concatenation is empty
    terms_re: dict = {}
    terms_im: dict = {}
    residual = x
    for i in range(ks):
        # round to nearest even, as JAX's reduce_precision(x, 8, 7)
        xs = residual.to(torch.bfloat16).to(torch.float32)
        if i + 1 < ks:
            residual = residual - xs
        n_p = min(cutoff - i, km - 1) + 1
        y = xs @ _bf3_matrix(fft_size, n_bins, km, hann_windowed, n_p,
                             x.device)
        for j in range(n_p):
            s = i + j
            yr = y[..., j * n_bins : (j + 1) * n_bins]
            yi = y[..., (n_p + j) * n_bins : (n_p + j + 1) * n_bins]
            terms_re[s] = yr if s not in terms_re else terms_re[s] + yr
            terms_im[s] = yi if s not in terms_im else terms_im[s] + yi

    order = sorted(terms_re)
    re = terms_re[order[0]]
    im = terms_im[order[0]]
    for s in order[1:]:
        re = re + terms_re[s]
        im = im + terms_im[s]
    return re * re + im * im


def _signal_slices(xn: torch.Tensor, n_slices: int) -> list:
    """Exact 7-bit slicing of row-normalized values ``|xn| < 1``: every op
    is exact in float32 (power-of-two multiply; trunc; Sterbenz
    subtraction of the integer part)."""
    out = []
    residual = xn
    for _ in range(n_slices):
        scaled = residual * SLICE_SCALE
        t = torch.trunc(scaled)
        residual = scaled - t
        out.append(t)
    return out


def pow2_row_scale(x: torch.Tensor) -> torch.Tensor:
    """The power-of-two row scale ``sigma = 2^(e+1) > max|x|`` of the last
    axis, from the exponent bits (exact; no log2/exp2). The exponent is
    clamped to 0xFD so ``sigma`` stays finite for ``|x| >= 2^127``."""
    row_max = x.abs().amax(dim=-1, keepdim=True)
    bits = torch.clamp_min(row_max, 1e-38).view(torch.int32)
    exp = torch.clamp_max((bits >> 23) & 0xFF, 0xFD)
    return ((exp + 1) << 23).view(torch.float32)


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """``(s, err)`` with ``s = fl(a + b)`` and ``a + b = s + err``
    exactly (each op rounds once: PyTorch does not contract them)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def combine_groups(groups: dict) -> tuple:
    """Scale each same-scale group ``s`` by ``128^-(s+2)`` (exact) and
    chain the terms, largest scale first, into a two-float ``(hi, lo)``."""
    terms = [groups[s] * (SLICE_SCALE ** (-(s + 2))) for s in sorted(groups)]
    hi = terms[0]
    lo = torch.zeros_like(hi)
    for t in terms[1:]:
        hi, err = two_sum(hi, t)
        lo = lo + err
    return two_sum(hi, lo)  # renormalize


def two_float_power(re: tuple, im: tuple, sigma: torch.Tensor):
    """``|v|^2`` of the two-float components with the cross term, rescaled
    by ``sigma^2`` (a power of two)."""
    (re_hi, re_lo), (im_hi, im_lo) = re, im
    power = (re_hi * re_hi + im_hi * im_hi
             + 2.0 * (re_hi * re_lo + im_hi * im_lo))
    return power * (sigma * sigma)


def hp_rdft_power(frames: torch.Tensor, fft_size: int, n_bins: int,
                  n_slices: int = 5, max_pair_sum: int = 5,
                  hann_windowed: bool = False) -> torch.Tensor:
    """``|rfft(frames)|^2`` over the first ``n_bins`` bins to ~2^-30 of
    the frame amplitude from exact integer slice-pair products. ``frames``
    ``[..., fft]`` float32 (RAW when ``hann_windowed``); float32 power
    ``[..., n_bins]``. Pairs with ``i + j > max_pair_sum`` are dropped."""
    c_all = _hp_matrix(fft_size, n_bins, n_slices, hann_windowed,
                       frames.device)
    return _hp_power_from_slices(frames, c_all, n_bins, n_slices,
                                 max_pair_sum)


def _hp_power_from_slices(frames: torch.Tensor, c_all: torch.Tensor,
                          n_bins: int, n_slices: int,
                          max_pair_sum: int) -> torch.Tensor:
    """The hp power from ``c_all``: the ``n_slices`` cos planes then the
    ``n_slices`` sin planes side by side (float32, integer values)."""
    x = frames.to(torch.float32)
    sigma = pow2_row_scale(x)
    x_slices = _signal_slices(x / sigma, n_slices)
    groups_re, groups_im = {}, {}
    for i, xs in enumerate(x_slices):
        # one wide matmul per signal slice; the pairs past the budget are
        # computed and discarded, as in the JAX package
        y_all = xs @ c_all
        for j in range(n_slices):
            if i + j > max_pair_sum:
                continue
            s = i + j
            yr = y_all[..., j * n_bins : (j + 1) * n_bins]
            yi = y_all[..., (n_slices + j) * n_bins
                       : (n_slices + j + 1) * n_bins]
            groups_re[s] = yr if s not in groups_re else groups_re[s] + yr
            groups_im[s] = yi if s not in groups_im else groups_im[s] + yi
    return two_float_power(combine_groups(groups_re),
                           combine_groups(groups_im), sigma)
