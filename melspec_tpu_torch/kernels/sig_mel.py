"""K1: one frontend's features from the raw signal — the CUDA kernel
(``csrc/sig_mel.cu``), its plain PyTorch version, and the wrapper that
picks between them by the device the signal lies on.

Replaces ``melspec_tpu/ops/mel_kernel.py::_pallas_sig_mel`` (body
``_sig_mel_tile_kernel``) in its output modes ``whisper`` (log10 + the
whisper norm), ``ln_guard`` (NeMo) and ``ln_floor`` (Kaldi), with split
or N-packed DFT columns and a tap offset ``pack_off``, and with the
whisper mode's two epilogues: the per-frame u8 wire record
(``sig_mel_quantized``) and the Sobel VAD counts (``sig_mel_vad``). Each
wrapper launches the kernel for a CUDA tensor (or raises) and runs its
plain version (``sig_mel_reference``, ``sig_mel_quantized_reference``,
``sig_mel_vad_reference``) only for a CPU tensor. ``launches`` counts
kernel launches, ``epilogue_launches`` those that ran an epilogue and
``factored_launches`` those of the factored wide-hop path and
``fft_launches`` those of the float64 FFT path; nothing else adds to
them.

The factored path (``csrc/sig_factored.cuh``, block layout 3) takes the
whisper heads whose 128- and 64-frame spans do not fit a block (the wide
hops 960/480, 1024/480, 2048/512): their matrix is the periodic Hann
window times the DFT of ``dft_size`` taps, so K1 runs it as two small
DFTs of ``factored_split(dft_size)`` (``N = N1 x N2``) with a float32
twiddle between them, from the host tables of ``factored_dft``. Its
plain version is ``sig_mel_factored_reference``; on the CPU these heads
keep ``sig_mel_reference`` (float64 dot) as every head does. A head the
host gives no split (another slice schedule, a size with no split, or
matrices from elsewhere) keeps the 32-frame chunk walk.

The float64 FFT path (``csrc/sig_fft.cuh``) takes the ln heads whose
frame lies inside a DFT of ``FFT_N`` = 2048 points and that carry its
description (``FftHead``: Kaldi fbank and NeMo log-mel at n_fft 2048,
44.1 / 48 kHz): the frame's window and Kaldi's DC removal and
preemphasis applied per frame, the DFT as a 2048-point real FFT, all in
float64, then K1's bf2 projection and ln. The two-stage path's float32
roundings are relative to the frame's whole spectrum and swamp the
near-empty bins of real clips, which the ln modes keep; in float64 every
bin's power is exact to float32. Its plain version is
``sig_mel_fft_reference``; on the CPU these heads keep
``sig_mel_reference`` (float64 dot) as every head does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.ops.fastmath import ln_accurate, log10_accurate
from melspec_tpu_torch.ops.hp_dft import bf16_round_slices
from melspec_tpu_torch.ops.quant import quantize_frames
from melspec_tpu_torch.ops.vad import sobel_gradient_sq
from melspec_tpu_torch.ops.windows import hann_periodic
from melspec_tpu_torch.utils import profiling

LOG10_FLOOR = 1e-10
# the smallest normal float32: ln_accurate's bit decomposition takes
# normal inputs only, so the ln modes clamp their guard to it
MIN_NORMAL = 1.1754944e-38
OUT_MODES = ("whisper", "ln_guard", "ln_floor")
# shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
MAX_BLOCKS = 16
MAX_SLICES = 4
# K1's DFT widths: re | im halves of width / 2 (split) or width single
# components (N-packed), walked in column chunks; the energy tile of up to
# 256 padded mel columns stays in registers (K2: ``sig_multi.WIDTHS``)
WIDTHS = (256, 512, 1024, 2048)
MAX_MELS_PAD = 256
# the tile of the VAD epilogue's counts: 0 on the last two frames of every
# TILE_FRAMES where a block holds 128 or 64 frames, of every 32 in K1's
# 32-frame blocks (``vad_tile``); the kernels check that the caller's
# value is theirs (csrc/sig_common.cuh: kTileFrames, Lay::kVadTile)
TILE_FRAMES = 64
# the factored path's schedule: three slices a side, pairs i + j <= 2, the
# whisper heads' pair_i (csrc/sig_factored.cuh: f_pair_i, f_pair_j)
FACTORED_PAIR_I = (0, 0, 0, 1, 1, 2)
FACTORED_PAIRS = ((0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0))
FACTORED_N1 = (32, 64)
# stage 2's n2 (padded) and its k2 (the bins below N / 2): a chunk is 32
# k1 x 16 k2 = 512 power columns
FACTORED_N2 = 32
FACTORED_K2 = 16
# the float64 FFT path's DFT size (csrc/sig_fft.cuh: kFftN); it computes
# the bins below FFT_N / 2, so a head's filter row of the Nyquist bin
# must be at most NYQUIST_TOL: the rounding noise of a zero weight (Kaldi's
# top filter ends at Nyquist and weighs it 1.4e-14 at 80 kHz, 160 mels),
# which moves a mel's energy by at most 1e-12 of the Nyquist bin's power
FFT_N = 2048
NYQUIST_TOL = 1e-12

launches = 0
epilogue_launches = {"quant": 0, "vad": 0}
factored_launches = 0
fft_launches = 0


def mel_runs(mt: torch.Tensor) -> tuple:
    """Each projection column's run of bins in a bf2 stack ``mt [3 H,
    nmp]`` (``[F0; F1; F0]``): ``(mel_off int32 [nmp + 1], mel_lo int32
    [nmp], f0, f1)``, column m's run the bins ``mel_lo[m] ..`` from its
    first to its last nonzero F0 or F1 row, its values ``f0`` / ``f1[
    mel_off[m] : mel_off[m + 1]]`` (bf16)."""
    half = mt.shape[0] // 3
    f0, f1 = mt[:half], mt[half : 2 * half]
    nz = (f0 != 0) | (f1 != 0)
    offs, los, a, b = [0], [], [], []
    for m in range(mt.shape[1]):
        idx = torch.nonzero(nz[:, m]).flatten()
        lo, hi = (int(idx[0]), int(idx[-1]) + 1) if idx.numel() else (0, 0)
        los.append(lo)
        a.append(f0[lo:hi, m])
        b.append(f1[lo:hi, m])
        offs.append(offs[-1] + hi - lo)
    return (torch.tensor(offs, dtype=torch.int32),
            torch.tensor(los, dtype=torch.int32), torch.cat(a).contiguous(),
            torch.cat(b).contiguous())


@dataclasses.dataclass(frozen=True)
class FftHead:
    """What K1's float64 FFT path needs of an ln head whose matrix folds
    a frame of ``pack`` taps, and per-frame preprocessing, into a DFT of
    ``FFT_N`` points (Kaldi fbank, NeMo log-mel at n_fft 2048):
    ``window`` float64 ``[pack]``, the window of the frame's taps;
    ``preemph`` None (no preprocessing) or Kaldi's coefficient p (DC
    removal, then in-frame preemphasis: ``d[i] - p d[i-1]`` with ``d = x -
    mean``, ``d[0]`` as it is; ``fbank.kaldi_preproc_matrix``; 0 is DC
    removal alone, which ``fbank.sig_head`` gives for every Kaldi ``p <=
    0``, as in JAX; a negative value is refused); ``mt`` the
    bf2 projection ``[F0; F1; F0]`` of the bins below ``FFT_N / 2``, bin
    order (bf16 ``[3 FFT_N / 2, nmp]``), and its ``mel_runs`` with
    ``nnz``, their values in all (computed where the head is built unless
    given). A malformed field raises ``ValueError``."""

    window: torch.Tensor
    preemph: float | None
    mt: torch.Tensor
    mel_off: torch.Tensor | None = None
    mel_lo: torch.Tensor | None = None
    f0: torch.Tensor | None = None
    f1: torch.Tensor | None = None
    nnz: int | None = None

    def __post_init__(self):
        half = FFT_N // 2
        w, mt = self.window, self.mt
        if (w.dtype != torch.float64 or w.dim() != 1
                or not 0 < w.shape[0] <= FFT_N):
            raise ValueError(f"FftHead: the window must be float64 [pack] "
                             f"with pack <= {FFT_N}; got {w.dtype} "
                             f"{tuple(w.shape)}")
        if self.preemph is not None and not (math.isfinite(self.preemph)
                                             and self.preemph >= 0.0):
            raise ValueError(f"FftHead: preemph must be None or finite and "
                             f">= 0; got {self.preemph}")
        if (mt.dtype != torch.bfloat16 or mt.dim() != 2
                or mt.shape[0] != 3 * half
                or not torch.equal(mt[2 * half :], mt[:half])):
            raise ValueError(f"FftHead: mt must be the bf2 stack [F0; F1; "
                             f"F0] of {half} bins; got {mt.dtype} "
                             f"{tuple(mt.shape)}")
        if self.mel_off is None:
            for name, v in zip(("mel_off", "mel_lo", "f0", "f1"),
                               mel_runs(mt)):
                object.__setattr__(self, name, v)
            object.__setattr__(self, "nnz", int(self.mel_off[-1]))

    def to(self, device) -> "FftHead":
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(device)
            for k in ("window", "mt", "mel_off", "mel_lo", "f0", "f1")})


@dataclasses.dataclass(frozen=True)
class SigHead:
    """One frontend's device matrices and output, as K1 and each head of
    K2 take them: ``m_big`` bf16 ``[K_tot, width]`` whose block ``blk``
    pairs with signal slice ``pair_i[blk]``; ``mt`` the bf2 stack ``[F0;
    F1; F0]`` (bf16, ``mel_precision`` "bf2") or the f32 projection
    (``"highest"``); ``n_bins_pad`` the re|im split point (0: N-packed
    columns); the frame's contracted taps ``[pack_off, pack_off +
    pack)``; ``n_mels`` output columns in ``out_mode`` with ``guard``;
    ``live`` the power columns that can be nonzero (``live_columns``),
    computed from ``m_big`` where the head is built (on the CPU) unless
    given; ``dft_size`` the N whose periodic-Hann-windowed split DFT
    ``m_big`` is (whisper heads), or whose DFT ``m_big`` folds with
    ``fft``'s window and preprocessing (Kaldi, NeMo), 0 for any other
    matrix: where ``factored_route`` takes it, K1 runs the factored path;
    ``fft`` the description of K1's float64 FFT path, which a head
    carrying it takes."""

    m_big: torch.Tensor
    pair_i: tuple
    mt: torch.Tensor
    n_bins_pad: int
    pack: int
    n_mels: int
    pack_off: int = 0
    out_mode: str = "whisper"
    guard: float = 0.0
    live: int | None = None
    dft_size: int = 0
    fft: FftHead | None = None

    def __post_init__(self):
        if self.live is None:
            object.__setattr__(self, "live",
                               live_columns(self.m_big, self.n_bins_pad))

    @property
    def mel_precision(self) -> str:
        return "bf2" if self.mt.dtype == torch.bfloat16 else "highest"

    def kw(self) -> dict:
        """The keyword arguments of ``sig_mel`` / ``sig_mel_reference``
        besides the matrices and the frame grid."""
        return dict(pack=self.pack, pack_off=self.pack_off,
                    n_bins_pad=self.n_bins_pad, n_mels=self.n_mels,
                    mel_precision=self.mel_precision,
                    out_mode=self.out_mode, guard=self.guard,
                    live=self.live, dft_size=self.dft_size, fft=self.fft)

    def to(self, device) -> "SigHead":
        return dataclasses.replace(
            self, m_big=self.m_big.to(device), mt=self.mt.to(device),
            fft=None if self.fft is None else self.fft.to(device))


def clamped_guard(guard: float) -> float:
    """The ln modes' guard as the kernels use it: clamped to the smallest
    normal float32 and rounded to float32."""
    return float(np.float32(max(guard, MIN_NORMAL)))


def out_vals(energy: torch.Tensor, out_mode: str,
             guard: float) -> torch.Tensor:
    """Energy -> output values (``_sig_out_vals`` of the JAX kernel). The
    whisper row max runs over every padded mel column, as in the kernel
    (a pad column's energy is 0 and its log sits at the floor)."""
    if out_mode == "ln_guard":
        return ln_accurate(energy + clamped_guard(guard))
    if out_mode == "ln_floor":
        return ln_accurate(torch.clamp_min(energy, clamped_guard(guard)))
    if out_mode != "whisper":
        raise ValueError(f"out_mode must be one of {OUT_MODES}")
    log_mel = log10_accurate(torch.clamp_min(energy, LOG10_FLOOR))
    raw = log_mel.amax(dim=-1, keepdim=True)
    return (torch.maximum(log_mel, raw - 8.0) + 4.0) * 0.25


def sig_mel_reference(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
                      mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
                      offset: int, pack: int, n_bins_pad: int, n_mels: int,
                      mel_precision: str = "bf2", pack_off: int = 0,
                      out_mode: str = "whisper", guard: float = 0.0,
                      live: int | None = None, dft_size: int = 0,
                      fft: FftHead | None = None,
                      dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX kernel's math written out in plain PyTorch, on whatever
    device ``samples`` lies on: ``samples [B, T]`` f32 -> ``[B, n_frames,
    n_mels]`` f32. Frame ``k`` contracts samples ``offset + k*hop +
    pack_off ... + pack``; samples past the clip read as zero.

    ``m_big`` is the bf16 K-stack whose block ``blk`` pairs with signal
    slice ``pair_i[blk]``; its columns are re in ``[0, n_bins_pad)`` and
    im in ``[n_bins_pad, 2*n_bins_pad)`` (split), or one component each
    when ``n_bins_pad`` is 0 (N-packed: power is ``y*y`` per column).
    ``mt`` is the bf2 stack ``[F0; F1; F0]`` (bf16) for
    ``mel_precision="bf2"`` or the f32 projection for ``"highest"``. The
    DFT dot is one ``torch.matmul`` in ``dot_dtype``: float32 as in the
    JAX kernel, or float64, which sums the exact bf16 x bf16 products with
    no rounding that reaches float32 — the exact value the float32
    versions are held against. ``live``, ``dft_size`` and ``fft`` are
    K1's and not used here: the plain version multiplies every column of
    ``m_big``."""
    b = samples.shape[0]
    if n_frames <= 0:
        return samples.new_zeros((b, 0, n_mels))
    x = samples.to(torch.float32)
    start = offset + pack_off
    need = start + (n_frames - 1) * hop + pack
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    frames = x[:, start:need].unfold(-1, pack, hop)  # [B, nf, pack]
    slices = bf16_cascade(frames, ks)
    # xcat @ m_big, the blocks concatenated in pair_i order; the K-stack's
    # zero pad rows past the real blocks contribute nothing
    xcat = torch.cat([slices[i] for i in pair_i], dim=-1).to(dot_dtype)
    y = (xcat @ m_big[: xcat.shape[-1]].to(dot_dtype)).to(torch.float32)
    if n_bins_pad:
        re = y[..., :n_bins_pad]
        im = y[..., n_bins_pad : 2 * n_bins_pad]
        power = re * re + im * im
    else:
        power = y * y
    if mel_precision == "bf2":
        p0 = power.to(torch.bfloat16)
        p1 = (power - p0.to(torch.float32)).to(torch.bfloat16)
        pcat = torch.cat([p0, p0, p1], dim=-1).to(torch.float32)
        energy = pcat @ mt.to(torch.float32)
    elif mel_precision == "highest":
        energy = power @ mt.to(torch.float32)
    else:
        raise ValueError("mel_precision must be 'bf2' or 'highest'")
    return out_vals(energy, out_mode, guard)[..., :n_mels].contiguous()


def factored_split(dft_size: int) -> tuple | None:
    """``(N1, N2)`` of K1's factored path for a whisper head of
    ``dft_size`` taps, or None: ``N = N1 x N2`` with N1 32 or 64 (a chunk
    is 32 k1 values, the 64 rows of a ``wgmma``), 24 < N2 <= 32 (stage
    2's padded n2; a thread's 8-tap groups), and the head's split point
    ``n_bins_pad`` equal to 16 N1 (16 k2 a k1). 960 = 32 x 30, 1024 = 32 x
    32, 2048 = 64 x 32."""
    half = dft_size // 2
    n_bins_pad = -(-half // 128) * 128
    for n1 in FACTORED_N1:
        n2 = dft_size // n1
        if (dft_size % n1 == 0 and 24 < n2 <= FACTORED_N2
                and n_bins_pad == FACTORED_K2 * n1):
            return n1, n2
    return None


def factored_route(dft_size: int, *, ks: int, pair_i, pack: int,
                   pack_off: int, width: int, npow: int,
                   out_mode: str = "whisper") -> tuple | None:
    """The factored split the host hands K1's layout for a head, or None.
    A split only for a whisper head whose matrix is the periodic Hann
    window times the split DFT of ``dft_size`` taps (``dft_size`` set
    where it is built), contracting the whole frame, in the (3, 2) slice
    schedule; the built kernel then takes layout 3 where the head's own
    would be the 32-frame chunk walk, and keeps every other layout."""
    split = factored_split(dft_size) if dft_size else None
    if (split is None or out_mode != "whisper" or ks != 3
            or tuple(pair_i) != FACTORED_PAIR_I or pack != dft_size
            or pack_off != 0 or width != 2 * npow):
        return None
    return split


@dataclasses.dataclass(frozen=True)
class FactoredDft:
    """The host tables of K1's factored path for ``N = n1 x n2`` taps,
    each built in float64 and rounded once, in the layouts
    ``csrc/sig_factored.cuh::Factored`` reads:

    - ``window`` float32 ``[N]``: the periodic Hann window;
    - ``f1`` bf16 ``[n1 / 32, 3, 64, n1]``: stage 1's three slices of the
      real-input ``n1``-point DFT, chunk ``c``'s row ``16 w + 8 h + g``
      the cos (h 0) or -sin (h 1) row of ``k1 = 32 c + 8 w + g``;
    - ``tw`` float32 ``[n1, 32, 2]``: ``(cos, sin)(2 pi n2 k1 / N)`` (0
      past n2);
    - ``f2`` bf16 ``[3, 32, 32]``: stage 2's ``cos | sin (2 pi n2 k2 /
      n2)`` for ``k2 < 16`` below ``ceil(n2 / 2)`` (0 elsewhere);
    - ``rowmap`` int32 ``[16 n1]``: the bin ``32 c + r + n1 k2`` of chunk
      ``c``'s power column ``16 r + k2``, the mt row the projection reads;
    - ``f1_rows`` bf16 ``[3, 2 n1, n1]``, ``f1``'s slices in bin order
      (cos rows, then -sin), for the plain version."""

    n: int
    n1: int
    n2: int
    window: torch.Tensor
    f1: torch.Tensor
    tw: torch.Tensor
    f2: torch.Tensor
    rowmap: torch.Tensor
    f1_rows: torch.Tensor

    def to(self, device) -> "FactoredDft":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in (
                "window", "f1", "tw", "f2", "rowmap", "f1_rows")})


@functools.lru_cache(maxsize=16)
@profiling.spanned("setup.heads", head="factored_dft")
def factored_dft(dft_size: int, device: torch.device) -> FactoredDft:
    """``FactoredDft`` of ``factored_split(dft_size)``, cached on
    ``device``."""
    split = factored_split(dft_size)
    if split is None:
        raise ValueError(f"no factored split for {dft_size} taps")
    n1, n2 = split
    n = n1 * n2
    k2_max = min(FACTORED_K2, -(-n2 // 2))
    ang1 = 2 * np.pi * np.outer(np.arange(n1), np.arange(n1)) / n1
    rows = np.concatenate([np.cos(ang1), -np.sin(ang1)])  # [2 n1, n1]
    f1_rows = torch.stack(bf16_round_slices(rows, 3))     # [3, 2 n1, n1]
    k1 = np.arange(n1)
    w, h, g = np.meshgrid(np.arange(4), np.arange(2), np.arange(8),
                          indexing="ij")
    # chunk c, row 16 w + 8 h + g <- bin-order row h * n1 + 32 c + 8 w + g
    order = np.concatenate([(h * n1 + 32 * c + 8 * w + g).reshape(-1)
                            for c in range(n1 // 32)])
    f1 = f1_rows[:, order].reshape(3, n1 // 32, 64, n1).transpose(0, 1)
    tw = np.zeros((n1, FACTORED_N2, 2))
    ang_t = 2 * np.pi * np.outer(k1, np.arange(n2)) / n
    tw[:, :n2, 0], tw[:, :n2, 1] = np.cos(ang_t), np.sin(ang_t)
    f2 = np.zeros((FACTORED_N2, 2 * FACTORED_K2))
    ang2 = 2 * np.pi * np.outer(np.arange(n2), np.arange(k2_max)) / n2
    f2[:n2, :k2_max] = np.cos(ang2)
    f2[:n2, FACTORED_K2 : FACTORED_K2 + k2_max] = np.sin(ang2)
    c, r, k2 = np.meshgrid(np.arange(n1 // 32), np.arange(32),
                           np.arange(FACTORED_K2), indexing="ij")
    rowmap = (32 * c + r + n1 * k2).reshape(-1)
    return FactoredDft(
        n, n1, n2,
        window=torch.as_tensor(hann_periodic(n), dtype=torch.float32),
        f1=f1.contiguous(),
        tw=torch.as_tensor(tw, dtype=torch.float32),
        f2=torch.stack(bf16_round_slices(f2, 3)),
        rowmap=torch.as_tensor(rowmap, dtype=torch.int32),
        f1_rows=f1_rows).to(device)


def bf16_cascade(v: torch.Tensor, ks: int) -> list:
    """The bf16 residual cascade of a float32 tensor: slice i rounds (to
    nearest even) what slices < i left (the kernels' staging and
    ``cut3``)."""
    slices = []
    for i in range(ks):
        h = v.to(torch.bfloat16)
        if i + 1 < ks:
            v = v - h.to(torch.float32)
        slices.append(h)
    return slices


def factored_power(samples: torch.Tensor, fac: FactoredDft, *,
                   n_frames: int, hop: int, offset: int,
                   dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The DFT power of K1's factored path in plain PyTorch, the kernel's
    schedule: ``samples [B, T]`` f32 -> ``[B, n_frames, 16 n1]`` f32, bin
    ``k1 + n1 k2`` in column ``k1 + n1 k2`` (bins at or past ``N / 2``
    hold what the kernel computes there and the projection drops). Frame
    ``k`` is samples ``offset + k*hop ...`` (zero past the clip) times the
    float32 window, reshaped to ``[n1, n2]`` (``n = n2 n1 + n2``) and cut
    into three bf16 slices; stage 1 sums the six pairs ``FACTORED_PAIRS``
    against ``f1``'s slices in one ``dot_dtype`` matmul over their
    concatenation, the float32 twiddle ``Z = Y W`` follows, Z is cut into
    three slices, and stage 2 sums the six pairs against ``f2`` the same
    way; the power is ``(C_re + S_im)^2 + (C_im - S_re)^2``."""
    b = samples.shape[0]
    n, n1, n2 = fac.n, fac.n1, fac.n2
    x = samples.to(torch.float32)
    need = offset + (n_frames - 1) * hop + n
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    frames = x[:, offset:need].unfold(-1, n, hop) * fac.window
    xr = torch.nn.functional.pad(frames.reshape(b, n_frames, n1, n2),
                                 (0, FACTORED_N2 - n2))
    xs = bf16_cascade(xr, 3)                         # [B, F, n1, 32] each
    a1 = torch.cat([fac.f1_rows[j] for _, j in FACTORED_PAIRS], dim=-1)
    b1 = torch.cat([xs[i] for i, _ in FACTORED_PAIRS], dim=-2)
    y = (a1.to(dot_dtype) @ b1.to(dot_dtype)).to(torch.float32)
    yr, yi = y[..., :n1, :], y[..., n1:, :]          # [B, F, n1, 32]
    c, s = fac.tw[..., 0], fac.tw[..., 1]
    zr = yr * c + yi * s
    zi = yi * c - yr * s
    zs = [torch.cat([r, i], dim=-2)
          for r, i in zip(bf16_cascade(zr, 3), bf16_cascade(zi, 3))]
    a2 = torch.cat([zs[i] for i, _ in FACTORED_PAIRS], dim=-1)
    b2 = torch.cat([fac.f2[j] for _, j in FACTORED_PAIRS], dim=0)
    d2 = (a2.to(dot_dtype) @ b2.to(dot_dtype)).to(torch.float32)
    k2 = FACTORED_K2
    xre = d2[..., :n1, :k2] + d2[..., n1:, k2:]
    xim = d2[..., n1:, :k2] - d2[..., :n1, k2:]
    # [B, F, n1 (k1), 16 (k2)] -> bins k1 + n1 k2 in order
    return (xre * xre + xim * xim).transpose(-1, -2).reshape(
        b, n_frames, k2 * n1)


def sig_mel_factored_reference(samples: torch.Tensor, fac: FactoredDft,
                               mt: torch.Tensor, *, n_frames: int, hop: int,
                               offset: int, n_mels: int,
                               mel_precision: str = "bf2",
                               dot_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """The plain version of K1's factored path on whatever device
    ``samples`` lies on: ``samples [B, T]`` f32 -> whisper values ``[B,
    n_frames, n_mels]``: ``factored_power`` projected by ``mt`` (bins in
    order: the bf2 stack ``[F0; F1; F0]`` or the f32 projection), then
    ``out_vals``, as in ``sig_mel_reference``."""
    b = samples.shape[0]
    if n_frames <= 0:
        return samples.new_zeros((b, 0, n_mels))
    power = factored_power(samples, fac, n_frames=n_frames, hop=hop,
                           offset=offset, dot_dtype=dot_dtype)
    if mel_precision == "bf2":
        p0 = power.to(torch.bfloat16)
        p1 = (power - p0.to(torch.float32)).to(torch.bfloat16)
        energy = (torch.cat([p0, p0, p1], dim=-1).to(torch.float32)
                  @ mt.to(torch.float32))
    elif mel_precision == "highest":
        energy = power @ mt.to(torch.float32)
    else:
        raise ValueError("mel_precision must be 'bf2' or 'highest'")
    return out_vals(energy, "whisper", 0.0)[..., :n_mels].contiguous()


def fft_taps(samples: torch.Tensor, *, n_frames: int, hop: int,
             start: int, window: torch.Tensor,
             preemph: float | None) -> torch.Tensor:
    """Each frame's windowed taps as K1's float64 FFT path stages them:
    the ``len(window)`` samples from ``start + k*hop`` (zero past the
    clip), in float64, with ``preemph`` Kaldi's DC removal and in-frame
    preemphasis before the ``window`` (``FftHead``), ``[B, n_frames,
    pack]`` float64."""
    pack = window.shape[0]
    x = samples.to(torch.float64)
    need = start + (n_frames - 1) * hop + pack
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    d = x[:, start:need].unfold(-1, pack, hop)
    if preemph is not None:
        d = d - d.mean(dim=-1, keepdim=True)
        d = torch.cat([d[..., :1], d[..., 1:] - preemph * d[..., :-1]],
                      dim=-1)
    return d * window.to(torch.float64)


def fft_power(samples: torch.Tensor, *, n_frames: int, hop: int,
              offset: int, pack_off: int, window: torch.Tensor,
              preemph: float | None) -> torch.Tensor:
    """The power of K1's float64 FFT path: ``fft_taps`` from ``offset +
    pack_off`` zero-padded to ``FFT_N`` (a circular shift of the frame at
    ``pack_off``: the same power), the float64 real DFT, ``|X[k]|^2``
    for the bins ``k < FFT_N / 2`` rounded once to float32, ``[B,
    n_frames, FFT_N / 2]``."""
    y = fft_taps(samples, n_frames=n_frames, hop=hop,
                 start=offset + pack_off, window=window, preemph=preemph)
    spec = torch.fft.rfft(y, n=FFT_N)[..., : FFT_N // 2]
    return (spec.real * spec.real + spec.imag * spec.imag).to(torch.float32)


def sig_mel_fft_reference(samples: torch.Tensor, fft: FftHead, *,
                          n_frames: int, hop: int, offset: int,
                          pack_off: int, n_mels: int, out_mode: str,
                          guard: float) -> torch.Tensor:
    """The plain version of K1's float64 FFT path on whatever device
    ``samples`` lies on: ``samples [B, T]`` f32 -> ``[B, n_frames,
    n_mels]`` values of ``out_mode`` (an ln mode) with ``guard``:
    ``fft_power`` with ``fft``'s window and preprocessing, split into
    bf16 ``p0``, ``p1`` and projected by ``fft.mt`` in float32, then
    ``out_vals``, as in ``sig_mel_reference``. ``fft_args(head)`` gives a
    head's arguments."""
    b = samples.shape[0]
    if n_frames <= 0:
        return samples.new_zeros((b, 0, n_mels))
    power = fft_power(samples, n_frames=n_frames, hop=hop, offset=offset,
                      pack_off=pack_off, window=fft.window,
                      preemph=fft.preemph)
    p0 = power.to(torch.bfloat16)
    p1 = (power - p0.to(torch.float32)).to(torch.bfloat16)
    energy = (torch.cat([p0, p0, p1], dim=-1).to(torch.float32)
              @ fft.mt.to(torch.float32))
    return out_vals(energy, out_mode, guard)[..., :n_mels].contiguous()


def fft_args(head: SigHead) -> dict:
    """``sig_mel_fft_reference``'s arguments for ``head`` (which carries
    ``fft``) besides the signal and its frame grid."""
    return dict(fft=head.fft, pack_off=head.pack_off, n_mels=head.n_mels,
                out_mode=head.out_mode, guard=head.guard)


def sig_mel_quantized_reference(samples: torch.Tensor, m_big: torch.Tensor,
                                pair_i, mt: torch.Tensor, **kw) -> tuple:
    """The quant epilogue's plain version: the whisper mel of
    ``sig_mel_reference`` (same arguments) quantized per frame by
    ``ops/quant.quantize_frames``: ``(q [B, F, n_mels] u8, lo [B, F], hi
    [B, F])``."""
    return quantize_frames(sig_mel_reference(samples, m_big, pair_i, mt,
                                             **kw))


def vad_threshold(min_energy: float) -> float:
    """The squared-gradient threshold as the comparison uses it: ``g2 >=
    min_energy**2`` between float32 values."""
    return float(np.float32(min_energy * min_energy))


def vad_args(settings, n_mels: int) -> tuple:
    """The VAD epilogue's ``vad = (thr, start_y)`` for K1 and K2 from
    ``DetectionSettings``: the squared threshold and the first mel row,
    clamped so that at least one 3-row Sobel patch fits."""
    return (vad_threshold(settings.min_energy),
            min(int(settings.min_mel), n_mels - 2))


def tile_vad_counts(mel: torch.Tensor, thr: float, start_y: int,
                    tile: int = TILE_FRAMES) -> torch.Tensor:
    """The VAD epilogue's output from the whisper values ``mel [B, F,
    n_mels]``: per frame ``x`` the number of mel rows ``y`` in
    ``[start_y, n_mels - 2)`` whose squared Sobel gradient over frames
    ``x .. x+2`` is ``>= thr``, int32 ``[B, F]``. Like the kernels (K1
    and K2), which see one tile of ``tile`` frames at a time, it gives 0
    for the last two frames of every tile and of the clip."""
    b, f, _ = mel.shape
    counts = torch.zeros((b, f), dtype=torch.int32, device=mel.device)
    if f > 2:
        g2 = sobel_gradient_sq(mel.transpose(-1, -2))[..., start_y:, :]
        counts[:, : f - 2] = (g2 >= thr).sum(dim=-2, dtype=torch.int32)
    edge = torch.arange(f, device=mel.device) % tile >= tile - 2
    counts[:, edge] = 0
    return counts


def sig_mel_vad_reference(samples: torch.Tensor, m_big: torch.Tensor,
                          pair_i, mt: torch.Tensor, *, vad: tuple,
                          **kw) -> tuple:
    """The VAD epilogue's plain version: the whisper mel of
    ``sig_mel_reference`` (same arguments) and ``tile_vad_counts`` of it
    at ``vad = (thr, start_y)``: ``(mel [B, F, n_mels], counts [B, F]
    int32)``, the classification ``classify_columns`` thresholds, with
    the tile-boundary zeros of the 128- and 64-frame blocks."""
    mel = sig_mel_reference(samples, m_big, pair_i, mt, **kw)
    return mel, tile_vad_counts(mel, *vad)


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("sig_mel").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_sig_mel.argtypes = [
        p, ll, ll, i, i, i, i,  # x, batch, T, n_frames, hop, offset, tile
        p, i, i, i,             # m_big, width, pack, pack_off
        p, i, i, i, i,          # blocks, n_blocks, ks, npow, live
        p, i, i, i,             # mt, n_mels, n_mels_pad, bf2
        i, ctypes.c_float,      # out_mode, guard
        p, p, p, p,             # out, q, lo, hi
        p, ctypes.c_float, i,   # vad, vad_thr, vad_start_y
        p,                      # stream
    ]
    lib.melspec_sig_mel.restype = ctypes.c_int
    lib.melspec_sig_mel_factored.argtypes = [
        p, ll, ll, i, i, i, i,  # x, batch, T, n_frames, hop, offset, tile
        i, i, p, p, p, p, p,    # n1, n2, window, f1, tw, f2, rowmap
        p, i, i, i, i,          # mt, npow, n_mels, n_mels_pad, bf2
        p, p, p, p,             # out, q, lo, hi
        p, ctypes.c_float, i,   # vad, vad_thr, vad_start_y
        p,                      # stream
    ]
    lib.melspec_sig_mel_factored.restype = ctypes.c_int
    lib.melspec_sig_mel_fft.argtypes = [
        p, ll, ll, i, i, i,     # x, batch, T, n_frames, hop, offset
        i, i, p, p,             # pack, pack_off, window, tw
        ctypes.c_double,        # preemph
        p, p, p, p, i,          # mel_off, mel_lo, f0, f1, nnz
        i, i, ctypes.c_float,   # n_mels, out_mode, guard
        p, p,                   # out, stream
    ]
    lib.melspec_sig_mel_fft.restype = ctypes.c_int
    lib.melspec_sig_mel_fft_smem.argtypes = [i, i]
    lib.melspec_sig_mel_fft_smem.restype = ctypes.c_longlong
    lib.melspec_sig_mel_layout.argtypes = [i, i, i, i, i, i, i, i, i, p, p,
                                           p]
    lib.melspec_sig_mel_layout.restype = ctypes.c_longlong
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


class Layout(NamedTuple):
    """K1's block layout: a block's shared memory, its frames, its chunks'
    DFT columns and whether it is the factored path. The float64 FFT
    path is ``(smem, 1, FFT_N, False)``: a block takes one frame at a
    time and the whole DFT."""

    smem: int
    frames: int
    cols: int
    factored: bool


def block_layout(ks: int, hop: int, pack: int, pack_off: int, width: int,
                 npow: int, n_mels_pad: int, split=None) -> Layout:
    """K1's block layout for a head (asks the built kernel, which
    decides it): 128-frame blocks of 128-column chunks where they fit and
    the head has at most 128 padded mel columns, else 64-frame blocks of
    256-column chunks where they fit, else, for a head with a factored
    ``split`` (``factored_route``), the factored path's 64-frame blocks
    of 512 power columns (1024 DFT columns), else 32-frame blocks of
    256-column chunks."""
    n1, n2 = split or (0, 0)
    code, frames, cols = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = _bound().melspec_sig_mel_layout(ks, hop, pack, pack_off, width,
                                           npow, n_mels_pad, n1, n2,
                                           ctypes.byref(code),
                                           ctypes.byref(frames),
                                           ctypes.byref(cols))
    if smem < 0:
        raise ValueError(f"K1 has no layout for hop {hop}, {pack} taps at "
                         f"{pack_off}, width {width}, split {split}")
    return Layout(int(smem), frames.value, cols.value, code.value == 3)


def head_layout(head: SigHead, hop: int, ks: int = 3) -> Layout:
    """K1's block layout for ``head`` at ``hop`` with ``ks`` signal
    slices, the one place that decides the route: a head carrying
    ``fft`` takes the float64 FFT path (``fft_layout``, which raises
    where the head does not match its description), any other head its
    factored split (``factored_route``) handed to ``block_layout``, so a
    launch, ``k1_accepts`` and ``k1_vad_tile`` agree."""
    if head.fft is not None:
        return fft_layout(head)
    width = head.m_big.shape[1]
    npow = width if head.n_bins_pad == 0 else head.n_bins_pad
    split = factored_route(head.dft_size, ks=ks, pair_i=head.pair_i,
                           pack=head.pack, pack_off=head.pack_off,
                           width=width, npow=npow, out_mode=head.out_mode)
    return block_layout(ks, hop, head.pack, head.pack_off, width, npow,
                        head.mt.shape[1], split)


def fft_layout(head: SigHead) -> Layout:
    """The float64 FFT path's layout for ``head``, which carries ``fft``,
    after the checks its launch applies: a ``ValueError`` where the head
    does not match the description (another DFT size or output mode, a
    window that is not its ``pack`` taps, a frame past the DFT, a
    projection of other columns or precision), so no head meant for the
    path quietly takes another route. The shared memory asks the built
    kernel."""
    f = head.fft
    why = None
    if head.dft_size != FFT_N:
        why = f"dft_size {head.dft_size}, not {FFT_N}"
    elif head.out_mode not in ("ln_guard", "ln_floor"):
        why = f"out_mode {head.out_mode!r}, not an ln mode"
    elif f.window.shape[0] != head.pack:
        why = f"a window of {f.window.shape[0]} taps for pack {head.pack}"
    elif head.pack_off + head.pack > FFT_N:
        why = f"taps [{head.pack_off}, {head.pack_off + head.pack}) past it"
    elif (head.mel_precision != "bf2"
          or f.mt.shape[1] != head.mt.shape[1]):
        why = (f"a {head.mel_precision} head of {head.mt.shape[1]} mel "
               f"columns for a bf2 projection of {f.mt.shape[1]}")
    if why is not None:
        raise ValueError(f"K1's float64 FFT path: {why}")
    smem = _bound().melspec_sig_mel_fft_smem(head.n_mels, f.nnz)
    return Layout(int(smem), 1, FFT_N, False)


# the float64 FFT path's radix-4 passes that turn their inputs (csrc/
# sig_fft.cuh: fft_pass, kFftTw)
FFT_PASSES = (4, 16, 64, 256)


@functools.lru_cache(maxsize=8)
@profiling.spanned("setup.heads", head="fft_twiddles")
def fft_twiddles(device: torch.device) -> torch.Tensor:
    """The float64 FFT path's twiddle tables, ``(cos, -sin)(2 pi e /
    FFT_N)`` as float64 ``[rows, 2]`` on ``device``: ``e = k`` for the
    bins ``k < FFT_N / 2``, then for each pass of ``Ns`` in
    ``FFT_PASSES`` the ``e = r m (FFT_N / 4) / Ns`` of its input ``r =
    1..3`` and sub-transform index ``m < Ns``, at ``(r - 1) Ns + m``."""
    e = [np.arange(FFT_N // 2)]
    for ns in FFT_PASSES:
        r, m = np.meshgrid(np.arange(1, 4), np.arange(ns), indexing="ij")
        e.append((r * m * (FFT_N // 4) // ns).reshape(-1))
    ang = 2 * np.pi * np.concatenate(e) / FFT_N
    return torch.as_tensor(np.stack([np.cos(ang), -np.sin(ang)], axis=-1),
                           device=device).contiguous()


def _smem_bytes(head: SigHead, hop: int, ks: int) -> int:
    """Shared memory one K1 block needs for ``head`` (asks the built
    kernel)."""
    return head_layout(head, hop, ks).smem


def vad_tile(block_frames: int) -> int:
    """The tile of the VAD counts' zeros in blocks of ``block_frames``:
    ``TILE_FRAMES``, or the block itself where it holds fewer frames."""
    return min(TILE_FRAMES, block_frames)


def k1_vad_tile(head: SigHead, hop: int, device, ks: int = 3) -> int:
    """The tile of K1's VAD counts for ``head`` at ``hop``: on CUDA that
    of the block layout the launch takes (``head_layout``: 64 frames, 32
    in the chunk walk's 32-frame blocks), on the CPU, where the plain
    version runs, ``TILE_FRAMES``. ``fix_raw`` recomputes the columns at
    its edges."""
    if torch.device(device).type != "cuda":
        return TILE_FRAMES
    return vad_tile(head_layout(head, hop, ks).frames)


def block_order(pair_i) -> list:
    """K1's summation order of the K blocks: ``(block, slice)`` with the
    smallest slice pair ``i + j`` first, so the small terms accumulate
    while the sum is still small and only block (0, 0) rounds at full
    magnitude. ``pair_i`` is i-major, so ``j`` is a block's place in its
    run of equal ``i``."""
    ij = [(blk, i, blk - pair_i.index(i)) for blk, i in enumerate(pair_i)]
    return [(blk, i) for blk, i, j in sorted(ij, key=lambda t: -(t[1] + t[2]))]


@functools.lru_cache(maxsize=32)
def block_table(pair_i: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(block_order(pair_i), dtype=torch.int32,
                        device=device)


def shape_refusal(width: int, n_bins_pad: int, n_mels_pad: int,
                  what: str, widths: tuple = WIDTHS) -> str | None:
    """Why a kernel taking ``widths`` DFT columns (K1: ``WIDTHS``, K2:
    ``sig_multi.WIDTHS``) refuses a head of ``width`` columns split at
    ``n_bins_pad`` (0: N-packed) with ``n_mels_pad`` projection columns,
    or None."""
    if width not in widths or n_bins_pad not in (0, width // 2):
        return (f"{what} takes {widths} DFT columns, split into re|im "
                f"halves or N-packed; got width {width}, split {n_bins_pad}")
    if n_mels_pad > MAX_MELS_PAD:
        return (f"{what} takes up to {MAX_MELS_PAD} padded mel columns; got "
                f"{n_mels_pad}")
    return None


def _smem_refusal(smem: int, hop: int, pack: int, pack_off: int,
                  npow: int) -> str | None:
    """Why K1 refuses a head whose block needs ``smem`` bytes of shared
    memory, or None."""
    if smem > MAX_SMEM_BYTES:
        return (f"K1 needs {smem} bytes of shared memory for hop {hop}, "
                f"{pack} taps at {pack_off}, {npow} power columns; a block "
                f"has {MAX_SMEM_BYTES}")
    return None


def k1_accepts(head: SigHead, *, hop: int, ks: int = 3) -> bool:
    """Whether K1 takes ``head`` at ``hop`` with ``ks`` signal slices: the
    shape check of ``check_head`` and the shared-memory check of the
    launch, the same functions the launch applies. The auto routes pick
    K1 only where this holds."""
    width, split = head.m_big.shape[1], head.n_bins_pad
    if shape_refusal(width, split, head.mt.shape[1], "K1") is not None:
        return False
    npow = width if split == 0 else split
    smem = _smem_bytes(head, hop, ks)
    return _smem_refusal(smem, hop, head.pack, head.pack_off, npow) is None


def live_columns(m_big: torch.Tensor, n_bins_pad: int) -> int:
    """The power columns ``[0, live)`` of a head that can be nonzero,
    rounded up to 8: past the last column whose re or im DFT column
    (split) or whose own column (N-packed) holds a nonzero value, the
    power is zero, and the kernels skip those columns. The host builders
    call it once, on the CPU matrix (``SigHead``, ``SigMatrices``)."""
    nz = (m_big != 0).any(dim=0)
    if n_bins_pad:
        nz = nz[:n_bins_pad] | nz[n_bins_pad : 2 * n_bins_pad]
    idx = torch.nonzero(nz)
    return -(-(int(idx.max()) + 1) // 8) * 8 if idx.numel() else 0


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels copy
    m_big and mt rows in 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_head(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
               mt: torch.Tensor, *, ks: int, pack: int, pack_off: int,
               n_bins_pad: int, n_mels: int, mel_precision: str,
               out_mode: str, what: str, widths: tuple = WIDTHS) -> tuple:
    """Validate one head's arguments for K1 or K2 (``widths``: the DFT
    widths the kernel takes); returns ``(pair_i as ints, npow, n_mels_pad,
    bf2)``."""
    dev = samples.device
    if samples.dtype != torch.float32 or samples.dim() != 2:
        raise ValueError(f"{what} takes a [B, T] float32 signal")
    if m_big.dtype != torch.bfloat16 or m_big.device != dev:
        raise ValueError("m_big must be a bf16 tensor on the signal's device")
    refusal = shape_refusal(m_big.shape[1], n_bins_pad, mt.shape[-1], what,
                            widths)
    if refusal is not None:
        raise NotImplementedError(refusal)
    npow = m_big.shape[1] if n_bins_pad == 0 else n_bins_pad
    if mel_precision not in ("bf2", "highest"):
        raise ValueError("mel_precision must be 'bf2' or 'highest'")
    if out_mode not in OUT_MODES:
        raise ValueError(f"out_mode must be one of {OUT_MODES}")
    bf2 = mel_precision == "bf2"
    want = (torch.bfloat16, 3 * npow) if bf2 else (torch.float32, npow)
    if (mt.dtype, mt.shape[0]) != want or mt.device != dev:
        raise ValueError(f"mt must be {want[0]} with {want[1]} rows on the "
                         f"signal's device; got {mt.dtype} {tuple(mt.shape)}")
    n_mels_pad = mt.shape[1]
    if n_mels_pad % 128 or n_mels > n_mels_pad:
        raise ValueError("mt's columns must be n_mels padded to 128")
    pair_i = tuple(int(i) for i in pair_i)
    if not (0 < len(pair_i) <= MAX_BLOCKS and 0 < ks <= MAX_SLICES
            and max(pair_i) < ks and min(pair_i) >= 0 and pack > 0
            and pack_off >= 0 and len(pair_i) * pack <= m_big.shape[0]):
        raise ValueError(f"{what} takes <= {MAX_BLOCKS} K blocks of "
                         f"<= {MAX_SLICES} signal slices; got pair_i "
                         f"{pair_i}, ks {ks}, pack {pack}")
    return pair_i, npow, n_mels_pad, bf2


def raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.melspec_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _launch(samples, m_big, pair_i, mt, *, ks, n_frames, hop, offset, pack,
            n_bins_pad, n_mels, mel_precision, pack_off, out_mode, guard,
            live, dft_size: int = 0, fft: FftHead | None = None,
            epilogue: str | None = None, vad: tuple = (0.0, 0)) -> tuple:
    """One K1 launch. ``live``: the power columns that can be nonzero
    (None: every one). ``dft_size``, ``fft``: the head's (``SigHead``);
    where ``head_layout`` gives layout 3, the factored path runs, from
    ``factored_dft``'s tables, and with ``fft`` the float64 FFT path, from
    its description (``m_big`` is not read by either; a launch that
    fails raises: no other route stands in). ``epilogue``: None (the
    float mel), ``"quant"`` (the u8
    records ``q, lo, hi`` and no float mel) or ``"vad"`` (the mel and the
    Sobel counts at ``vad = (thr, start_y)``). Returns the outputs as a
    tuple."""
    global launches, factored_launches, fft_launches
    dev = samples.device
    pair_i, npow, n_mels_pad, bf2 = check_head(
        samples, m_big, pair_i, mt, ks=ks, pack=pack, pack_off=pack_off,
        n_bins_pad=n_bins_pad, n_mels=n_mels, mel_precision=mel_precision,
        out_mode=out_mode, what="K1")
    if epilogue is not None and out_mode != "whisper":
        raise ValueError("K1's epilogues run on the whisper mode")
    if epilogue == "vad" and n_mels < 3:
        raise ValueError("the Sobel VAD needs n_mels >= 3")
    width = m_big.shape[1]
    live = npow if live is None else live
    smem, frames, _, factored = head_layout(
        SigHead(m_big, pair_i, mt, n_bins_pad, pack, n_mels, pack_off,
                out_mode, guard, live, dft_size, fft), hop, ks)
    refusal = _smem_refusal(smem, hop, pack, pack_off, npow)
    if refusal is not None:
        raise NotImplementedError(refusal)
    b, t = samples.shape
    out = q = lo = hi = counts = None
    if epilogue == "quant":
        q = torch.empty((b, n_frames, n_mels), dtype=torch.uint8, device=dev)
        lo = torch.empty((b, n_frames), dtype=torch.float32, device=dev)
        hi = torch.empty_like(lo)
        outs = (q, lo, hi)
    else:
        out = torch.empty((b, n_frames, n_mels), dtype=torch.float32,
                          device=dev)
        outs = (out,)
        if epilogue == "vad":
            counts = torch.empty((b, n_frames), dtype=torch.int32,
                                 device=dev)
            outs = (out, counts)
    if b == 0 or n_frames <= 0:
        return outs
    samples = samples.contiguous()
    mt = aligned(mt)
    lib = _bound()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fft is not None:
            if any(getattr(fft, k).device != dev for k in (
                    "window", "mel_off", "mel_lo", "f0", "f1")):
                raise ValueError("the head's FftHead must lie on the "
                                 "signal's device")
            rc = lib.melspec_sig_mel_fft(
                samples.data_ptr(), b, t, n_frames, hop, offset, pack,
                pack_off, fft.window.contiguous().data_ptr(),
                fft_twiddles(dev).data_ptr(),
                -1.0 if fft.preemph is None else float(fft.preemph),
                fft.mel_off.data_ptr(), fft.mel_lo.data_ptr(),
                fft.f0.data_ptr(), fft.f1.data_ptr(), fft.nnz, n_mels,
                OUT_MODES.index(out_mode), clamped_guard(guard),
                out.data_ptr(), stream)
        elif factored:
            fac = factored_dft(dft_size, dev)
            rc = lib.melspec_sig_mel_factored(
                samples.data_ptr(), b, t, n_frames, hop, offset,
                vad_tile(frames), fac.n1, fac.n2, fac.window.data_ptr(),
                fac.f1.data_ptr(), fac.tw.data_ptr(), fac.f2.data_ptr(),
                fac.rowmap.data_ptr(), mt.data_ptr(), npow, n_mels,
                n_mels_pad, int(bf2), ptr(out), ptr(q), ptr(lo), ptr(hi),
                ptr(counts), vad[0], int(vad[1]), stream)
        else:
            m_big = aligned(m_big)
            blocks = block_table(pair_i, dev)
            rc = lib.melspec_sig_mel(
                samples.data_ptr(), b, t, n_frames, hop, offset,
                vad_tile(frames),
                m_big.data_ptr(), width, pack, pack_off, blocks.data_ptr(),
                len(pair_i), ks, npow, live, mt.data_ptr(), n_mels,
                n_mels_pad, int(bf2), OUT_MODES.index(out_mode),
                clamped_guard(guard), ptr(out), ptr(q), ptr(lo), ptr(hi),
                ptr(counts), vad[0], int(vad[1]), stream)
    raise_for(lib, rc, "K1 (sig_mel)")
    launches += 1
    factored_launches += int(factored)
    fft_launches += int(fft is not None)
    if epilogue is not None:
        epilogue_launches[epilogue] += 1
    return outs


def _on_device(samples: torch.Tensor, kernel, plain):
    """The kernel on a CUDA signal, the plain version on a CPU one."""
    if samples.device.type == "cuda":
        return kernel()
    if samples.device.type == "cpu":
        return plain()
    raise ValueError(f"unsupported device {samples.device}")


def sig_mel(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
            mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
            offset: int, pack: int, n_bins_pad: int, n_mels: int,
            mel_precision: str = "bf2", pack_off: int = 0,
            out_mode: str = "whisper", guard: float = 0.0,
            live: int | None = None, dft_size: int = 0,
            fft: FftHead | None = None) -> torch.Tensor:
    """K1 on a CUDA signal, its plain version on a CPU one (same
    arguments as ``sig_mel_reference``; ``live``, the head's
    ``live_columns``, lets K1 skip the power columns that are zero, and
    None has it multiply every one; ``dft_size``, the head's, takes the
    factored path where ``factored_route`` gives a split and the head's
    own layout would be 32-frame blocks; ``fft``, the head's, the float64
    FFT path). On the CPU the DFT dot is
    summed exactly (float64): the f32 sum of a CPU BLAS changes with its
    thread count, and on near-silent mel bins that order alone can cost
    more than the accuracy gates allow."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision, pack_off=pack_off,
              out_mode=out_mode, guard=guard, live=live, dft_size=dft_size,
              fft=fft)
    return _on_device(
        samples, lambda: _launch(samples, m_big, pair_i, mt, **kw)[0],
        lambda: sig_mel_reference(samples, m_big, pair_i, mt,
                                  dot_dtype=torch.float64, **kw))


def sig_mel_quantized(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
                      mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
                      offset: int, pack: int, n_bins_pad: int, n_mels: int,
                      mel_precision: str = "bf2",
                      live: int | None = None, dft_size: int = 0) -> tuple:
    """K1 in whisper mode with the quant epilogue on a CUDA signal, its
    plain version on a CPU one (float64 DFT dot, as ``sig_mel``): ``(q
    [B, n_frames, n_mels] u8, lo [B, n_frames], hi [B, n_frames])``, each
    frame's record of ``quantize_frames``; the kernel writes no float
    mel."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision, live=live, dft_size=dft_size)
    return _on_device(
        samples,
        lambda: _launch(samples, m_big, pair_i, mt, pack_off=0,
                        out_mode="whisper", guard=0.0, epilogue="quant",
                        **kw),
        lambda: sig_mel_quantized_reference(samples, m_big, pair_i, mt,
                                            dot_dtype=torch.float64, **kw))


def sig_mel_vad(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
                mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
                offset: int, pack: int, n_bins_pad: int, n_mels: int,
                vad: tuple, mel_precision: str = "bf2",
                live: int | None = None, dft_size: int = 0) -> tuple:
    """K1 in whisper mode with the Sobel VAD epilogue on a CUDA signal,
    its plain version on a CPU one (float64 DFT dot): ``(mel [B,
    n_frames, n_mels], counts [B, n_frames] int32)`` at ``vad = (thr,
    start_y)``; the counts of the last two frames of each ``k1_vad_tile``
    tile are 0 (see ``tile_vad_counts``)."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision, live=live, dft_size=dft_size)
    return _on_device(
        samples,
        lambda: _launch(samples, m_big, pair_i, mt, pack_off=0,
                        out_mode="whisper", guard=0.0, epilogue="vad",
                        vad=vad, **kw),
        lambda: sig_mel_vad_reference(samples, m_big, pair_i, mt, vad=vad,
                                      dot_dtype=torch.float64, **kw))
