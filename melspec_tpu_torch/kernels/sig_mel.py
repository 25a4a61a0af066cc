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
kernel launches, ``epilogue_launches`` those that ran an epilogue,
``factored_launches`` those of the factored wide-hop path,
``fft_launches`` those of the float64 FFT path,
``pipelined_launches`` those of the pipelined 128-frame walk and
``magnitude_launches`` those of a magnitude head; nothing else adds to
them.

A head with ``magnitude`` set takes each bin's magnitude ``sqrt(re^2 +
im^2)`` where the others take its power (NeMo's ``mag_power`` 1, Kaldi's
``use_power=False``): in float32 before the projection's bf2 split on
the chunk walks, in float64 before the one rounding to float32 on the
float64 FFT path. Only a split head holds a bin's ``re^2 + im^2`` to take
the root of, so K1 refuses an N-packed magnitude head
(``magnitude_refusal``), the factored path computes power alone and
leaves such heads to the chunk walk, and K2 refuses them.

The pipelined walk (``csrc/sig_pipe.cuh``, block layout 4) is how K1
and K2 walk every 128-frame block: a producer warp brings m_big in stage
by stage by bulk copy from a stream the host lays out once per head in
the ring's own bytes (``pipe_stages``, kept in the head's ``StageSlot``),
and the bf2 projection's rows with it; the outputs are those of the
synchronous chunk walk's sum order bit for bit, so K1 and K2 agree on a
head whichever layout each takes.

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
frame lies inside a DFT of one of ``FFT_SIZES`` (1024 or 2048 points)
and that carry its description (``FftHead``: Kaldi fbank and NeMo
log-mel at n_fft 1024, 22.05 to 40 kHz, NeMo's TTS mel among them, and
at n_fft 2048, 44.1 to 80 kHz): the frame's window and Kaldi's DC
removal and preemphasis applied per frame, the DFT as a real FFT of its
points, all in float64, then K1's bf2 projection and ln; each size is
its own instance of the kernel, where a frame belongs to a group of
``FFT_GROUP_THREADS[n]`` threads (at 1024 points a warp) that holds its
FFT in registers as the passes ``FFT_RADICES[n]``, ``FFT_GROUPS[n]``
groups a block. The two-stage
path's float32 roundings are relative to the frame's whole spectrum and
swamp the near-empty bins of real clips, which the ln modes keep; in
float64 every bin's power is exact to float32. Its plain version is
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
# the float64 FFT path's DFT sizes (csrc/sig_fft.cuh: FftSize<N>::kN), an
# instance of the kernel each; it computes the bins below n / 2, so a
# head's filter row of the Nyquist bin must be at most NYQUIST_TOL: the
# rounding noise of a zero weight (Kaldi's top filter ends at Nyquist and
# weighs it 1.4e-14 at 80 kHz, 160 mels), which moves a mel's energy by at
# most 1e-12 of the Nyquist bin's power
FFT_SIZES = (1024, 2048)
NYQUIST_TOL = 1e-12
# by DFT size: the float64 FFT path's group (FftSize<N>::kGroupThreads: one
# frame's threads), its groups a block (kGroups: frames in flight) and the
# passes of its complex FFT of n / 2 points (two radix-16 passes in
# registers, then radix-4s at 2048 points, radix-2s at 1024)
FFT_GROUP_THREADS = {1024: 32, 2048: 64}
FFT_GROUPS = {1024: 8, 2048: 4}
FFT_RADICES = {1024: (16, 16, 2), 2048: (16, 16, 4)}
# the twiddle table's rows at either size (FftSize<N>::kTw: W_n^e, e < 256)
FFT_TW = 256

# the pipelined walk (csrc/sig_pipe.cuh): its block's frames, the DFT
# columns of a chunk (Lay<0>::kCols), the bf16 values of a stage's
# 8-column group (kCoreN: 4 core matrices of 8 rows x 8 columns, then 8 of
# padding) and the mt rows of one stack a projection piece (kPipeRows)
PIPE_FRAMES = 128
PIPE_CHUNK_COLS = 128
PIPE_GROUP = 264
PIPE_ROWS = 32

launches = 0
epilogue_launches = {"quant": 0, "vad": 0}
factored_launches = 0
fft_launches = 0
pipelined_launches = 0
magnitude_launches = 0


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


class StageSlot:
    """Where a head keeps its pipelined walk's stage stream
    (``pipe_stages``): the head's first launch on the pipelined walk
    (K1's, or K2's with the head among its heads) builds it, its later
    launches reuse it. One stream per projection dtype (``SigMatrices``
    makes heads of either), each kept with the matrices and fields it was
    laid out from, so a head with others (one made by
    ``dataclasses.replace``, say) lays out its own."""

    def __init__(self):
        self._streams = {}

    def stream(self, head: SigHead) -> torch.Tensor:
        key = (head.pair_i, head.pack, head.npow, head.live)
        hit = self._streams.get(head.mt.dtype)
        if (hit is not None and hit[0] is head.m_big and hit[1] is head.mt
                and hit[2] == key):
            return hit[3]
        stream = stage_stream(head)
        self._streams[head.mt.dtype] = (head.m_big, head.mt, key, stream)
        return stream


@dataclasses.dataclass(frozen=True)
class FftHead:
    """What K1's float64 FFT path needs of an ln head whose matrix folds
    a frame of ``pack`` taps, and per-frame preprocessing, into a DFT of
    ``size`` points, one of ``FFT_SIZES`` (Kaldi fbank, NeMo log-mel at
    n_fft 1024 or 2048), which its projection's rows give:
    ``window`` float64 ``[pack]``, the window of the frame's taps, ``pack
    <= size``;
    ``preemph`` None (no preprocessing) or Kaldi's coefficient p (DC
    removal, then in-frame preemphasis: ``d[i] - p d[i-1]`` with ``d = x -
    mean``, ``d[0]`` as it is; ``fbank.kaldi_preproc_matrix``; 0 is DC
    removal alone, which ``fbank.sig_head`` gives for every Kaldi ``p <=
    0``, as in JAX; a negative value is refused); ``mt`` the
    bf2 projection ``[F0; F1; F0]`` of the bins below ``size / 2``, bin
    order (bf16 ``[3 size / 2, nmp]``), and its ``mel_runs`` with
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
        w, mt = self.window, self.mt
        halves = tuple(n // 2 for n in FFT_SIZES)
        if (mt.dtype != torch.bfloat16 or mt.dim() != 2
                or mt.shape[0] not in tuple(3 * h for h in halves)
                or not torch.equal(mt[2 * mt.shape[0] // 3 :],
                                   mt[: mt.shape[0] // 3])):
            raise ValueError(f"FftHead: mt must be the bf2 stack [F0; F1; "
                             f"F0] of {' or '.join(map(str, halves))} "
                             f"bins; got {mt.dtype} {tuple(mt.shape)}")
        if (w.dtype != torch.float64 or w.dim() != 1
                or not 0 < w.shape[0] <= self.size):
            raise ValueError(f"FftHead: the window must be float64 [pack] "
                             f"with pack <= {self.size}; got {w.dtype} "
                             f"{tuple(w.shape)}")
        if self.preemph is not None and not (math.isfinite(self.preemph)
                                             and self.preemph >= 0.0):
            raise ValueError(f"FftHead: preemph must be None or finite and "
                             f">= 0; got {self.preemph}")
        if self.mel_off is None:
            for name, v in zip(("mel_off", "mel_lo", "f0", "f1"),
                               mel_runs(mt)):
                object.__setattr__(self, name, v)
            object.__setattr__(self, "nnz", int(self.mel_off[-1]))

    @property
    def size(self) -> int:
        """The DFT's points: twice the bins of the projection's rows."""
        return 2 * self.mt.shape[0] // 3

    @property
    def bins(self) -> int:
        """The bins the runs reach: the 1024-point instance computes no
        power past them (it reads the same end from the staged runs)."""
        return int((self.mel_lo + self.mel_off[1:] - self.mel_off[:-1]).max())

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
    carrying it takes; ``magnitude`` whether the projection takes each
    bin's magnitude in place of its power (a split head only:
    ``magnitude_refusal``); ``stages`` the slot of its pipelined walk's
    stage stream (a copy on another device starts an empty one). ``pair_i`` is
    kept as a tuple of ints; ``width``, ``npow``, ``n_mels_pad`` and
    ``mel_precision`` follow from the matrices."""

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
    magnitude: bool = False
    stages: StageSlot = dataclasses.field(default_factory=StageSlot,
                                          compare=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "pair_i", tuple(int(i) for i in self.pair_i))
        if self.live is None:
            object.__setattr__(self, "live",
                               live_columns(self.m_big, self.n_bins_pad))

    @property
    def width(self) -> int:
        """``m_big``'s DFT columns."""
        return self.m_big.shape[1]

    @property
    def npow(self) -> int:
        """The power columns: the split point, or every column where
        they are N-packed."""
        return self.n_bins_pad or self.width

    @property
    def n_mels_pad(self) -> int:
        """The projection's columns."""
        return self.mt.shape[-1]

    @property
    def mel_precision(self) -> str:
        return "bf2" if self.mt.dtype == torch.bfloat16 else "highest"

    def to(self, device) -> "SigHead":
        return dataclasses.replace(
            self, m_big=self.m_big.to(device), mt=self.mt.to(device),
            fft=None if self.fft is None else self.fft.to(device),
            stages=StageSlot())


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


def project(power: torch.Tensor, mt: torch.Tensor) -> torch.Tensor:
    """The mel energy of float32 ``power`` (a magnitude head's
    magnitudes): split into bf16 ``p0``, ``p1``
    against the bf2 stack ``[F0; F1; F0]`` (bf16 ``mt``), or against the
    f32 projection, in float32."""
    if mt.dtype == torch.bfloat16:
        p0 = power.to(torch.bfloat16)
        p1 = (power - p0.to(torch.float32)).to(torch.bfloat16)
        power = torch.cat([p0, p0, p1], dim=-1).to(torch.float32)
    return power @ mt.to(torch.float32)


def sig_mel_reference(samples: torch.Tensor, head: SigHead, *, ks: int,
                      n_frames: int, hop: int, offset: int,
                      dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX kernel's math written out in plain PyTorch, on whatever
    device ``samples`` lies on: ``samples [B, T]`` f32 -> ``[B, n_frames,
    n_mels]`` f32. Frame ``k`` contracts samples ``offset + k*hop +
    pack_off ... + pack``; samples past the clip read as zero.

    The head's ``m_big`` is the bf16 K-stack whose block ``blk`` pairs
    with signal slice ``pair_i[blk]``; its columns are re in ``[0,
    n_bins_pad)`` and im in ``[n_bins_pad, 2*n_bins_pad)`` (split), or one
    component each when ``n_bins_pad`` is 0 (N-packed: power is ``y*y``
    per column); a magnitude head takes the root of the split power
    (correctly rounded, as the kernels' ``__fsqrt_rn``); ``mt`` is
    projected by ``project``. The DFT dot is one
    ``torch.matmul`` in ``dot_dtype``: float32 as in the JAX kernel, or
    float64, which sums the exact bf16 x bf16 products with no rounding
    that reaches float32 — the exact value the float32 versions are held
    against. The plain version multiplies every column of ``m_big``: the
    head's ``live``, ``dft_size``, ``fft`` and ``stages`` choose K1's
    routes and are not read here."""
    b, h = samples.shape[0], head
    if n_frames <= 0:
        return samples.new_zeros((b, 0, h.n_mels))
    x = samples.to(torch.float32)
    start = offset + h.pack_off
    need = start + (n_frames - 1) * hop + h.pack
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    frames = x[:, start:need].unfold(-1, h.pack, hop)  # [B, nf, pack]
    slices = bf16_cascade(frames, ks)
    # xcat @ m_big, the blocks concatenated in pair_i order; the K-stack's
    # zero pad rows past the real blocks contribute nothing
    xcat = torch.cat([slices[i] for i in h.pair_i], dim=-1).to(dot_dtype)
    y = (xcat @ h.m_big[: xcat.shape[-1]].to(dot_dtype)).to(torch.float32)
    if h.n_bins_pad:
        re = y[..., : h.n_bins_pad]
        im = y[..., h.n_bins_pad : 2 * h.n_bins_pad]
        power = re * re + im * im
        if h.magnitude:
            power = torch.sqrt(power)
    else:
        refusal = magnitude_refusal(h)
        if refusal is not None:
            raise NotImplementedError(refusal)
        power = y * y
    energy = project(power, h.mt)
    return out_vals(energy, h.out_mode, h.guard)[..., : h.n_mels].contiguous()


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


def factored_route(head: SigHead, ks: int) -> tuple | None:
    """The factored split the host hands K1's layout for ``head`` with
    ``ks`` signal slices, or None. A split only for a whisper head whose
    matrix is the periodic Hann window times the split DFT of its
    ``dft_size`` taps (set where it is built), contracting the whole
    frame, in the (3, 2) slice schedule; the built kernel then takes
    layout 3 where the head's own would be the 32-frame chunk walk, and
    keeps every other layout. The factored path computes power alone: a
    magnitude head keeps its chunk walk."""
    h = head
    split = factored_split(h.dft_size) if h.dft_size else None
    if (split is None or h.out_mode != "whisper" or h.magnitude or ks != 3
            or h.pair_i != FACTORED_PAIR_I or h.pack != h.dft_size
            or h.pack_off != 0 or h.width != 2 * h.npow):
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


def sig_mel_factored_reference(samples: torch.Tensor, head: SigHead, *,
                               n_frames: int, hop: int, offset: int,
                               dot_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """The plain version of K1's factored path for a whisper ``head`` on
    whatever device ``samples`` lies on: ``samples [B, T]`` f32 ->
    whisper values ``[B, n_frames, n_mels]``: ``factored_power`` with the
    tables of ``factored_dft(head.dft_size)``, projected by the head's
    ``mt`` (bins in order, ``project``), then ``out_vals``, as in
    ``sig_mel_reference``."""
    if head.magnitude:
        raise NotImplementedError("K1's factored path computes power, not "
                                  "a magnitude head's magnitudes")
    b = samples.shape[0]
    if n_frames <= 0:
        return samples.new_zeros((b, 0, head.n_mels))
    fac = factored_dft(head.dft_size, samples.device)
    power = factored_power(samples, fac, n_frames=n_frames, hop=hop,
                           offset=offset, dot_dtype=dot_dtype)
    energy = project(power, head.mt)
    return out_vals(energy, "whisper", 0.0)[..., : head.n_mels].contiguous()


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


def fft_power(samples: torch.Tensor, *, size: int, n_frames: int,
              hop: int, offset: int, pack_off: int, window: torch.Tensor,
              preemph: float | None, magnitude: bool = False
              ) -> torch.Tensor:
    """The power of K1's float64 FFT path at a DFT of ``size`` points:
    ``fft_taps`` from ``offset + pack_off`` zero-padded to ``size`` (a
    circular shift of the frame at ``pack_off``: the same power), the
    float64 real DFT, ``|X[k]|^2`` (with ``magnitude`` its root, in
    float64) for the bins ``k < size / 2`` rounded once to float32, ``[B,
    n_frames, size / 2]``."""
    y = fft_taps(samples, n_frames=n_frames, hop=hop,
                 start=offset + pack_off, window=window, preemph=preemph)
    spec = torch.fft.rfft(y, n=size)[..., : size // 2]
    power = spec.real * spec.real + spec.imag * spec.imag
    return (torch.sqrt(power) if magnitude else power).to(torch.float32)


def sig_mel_fft_reference(samples: torch.Tensor, head: SigHead, *,
                          n_frames: int, hop: int,
                          offset: int) -> torch.Tensor:
    """The plain version of K1's float64 FFT path for ``head``, which
    carries ``fft``, on whatever device ``samples`` lies on: ``samples [B,
    T]`` f32 -> ``[B, n_frames, n_mels]`` values of the head's ln mode:
    ``fft_power`` with ``fft``'s window and preprocessing (a magnitude
    head's magnitudes) at the description's DFT size, projected by
    ``fft.mt`` (``project``), then ``out_vals``, as in
    ``sig_mel_reference``."""
    b, f = samples.shape[0], head.fft
    if n_frames <= 0:
        return samples.new_zeros((b, 0, head.n_mels))
    power = fft_power(samples, size=f.size, n_frames=n_frames, hop=hop,
                      offset=offset,
                      pack_off=head.pack_off, window=f.window,
                      preemph=f.preemph, magnitude=head.magnitude)
    energy = project(power, f.mt)
    return out_vals(energy, head.out_mode,
                    head.guard)[..., : head.n_mels].contiguous()


def check_epilogue(head: SigHead, epilogue: str) -> None:
    """Raises for a head that ``epilogue`` ("quant" or "vad") cannot run
    on, alike in the kernel and in its plain version."""
    if head.out_mode != "whisper":
        raise ValueError("K1's epilogues run on the whisper mode")
    if epilogue == "vad" and head.n_mels < 3:
        raise ValueError("the Sobel VAD needs n_mels >= 3")


def sig_mel_quantized_reference(samples: torch.Tensor, head: SigHead, *,
                                ks: int, n_frames: int, hop: int,
                                offset: int, dot_dtype: torch.dtype =
                                torch.float32) -> tuple:
    """The quant epilogue's plain version: the whisper mel of
    ``sig_mel_reference`` (same arguments) quantized per frame by
    ``ops/quant.quantize_frames``: ``(q [B, F, n_mels] u8, lo [B, F], hi
    [B, F])``."""
    check_epilogue(head, "quant")
    return quantize_frames(sig_mel_reference(
        samples, head, ks=ks, n_frames=n_frames, hop=hop, offset=offset,
        dot_dtype=dot_dtype))


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


def sig_mel_vad_reference(samples: torch.Tensor, head: SigHead, *, ks: int,
                          n_frames: int, hop: int, offset: int, vad: tuple,
                          dot_dtype: torch.dtype = torch.float32) -> tuple:
    """The VAD epilogue's plain version: the whisper mel of
    ``sig_mel_reference`` (same arguments) and ``tile_vad_counts`` of it
    at ``vad = (thr, start_y)``: ``(mel [B, F, n_mels], counts [B, F]
    int32)``, the classification ``classify_columns`` thresholds, with
    the tile-boundary zeros of the 128- and 64-frame blocks."""
    check_epilogue(head, "vad")
    mel = sig_mel_reference(samples, head, ks=ks, n_frames=n_frames,
                            hop=hop, offset=offset, dot_dtype=dot_dtype)
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
        i, ctypes.c_float, i,   # out_mode, guard, magnitude
        p, p, p, p,             # out, q, lo, hi
        p, ctypes.c_float, i,   # vad, vad_thr, vad_start_y
        p, p,                   # stages, stream
    ]
    lib.melspec_sig_mel.restype = ctypes.c_int
    lib.melspec_sig_mel_pipe_bytes.argtypes = [i] * 7
    lib.melspec_sig_mel_pipe_bytes.restype = ctypes.c_longlong
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
        i, i, i, p, p,          # n, pack, pack_off, window, tw
        ctypes.c_double,        # preemph
        p, p, p, p, i,          # mel_off, mel_lo, f0, f1, nnz
        i, i, ctypes.c_float,   # n_mels, out_mode, guard
        i,                      # magnitude
        p, p,                   # out, stream
    ]
    lib.melspec_sig_mel_fft.restype = ctypes.c_int
    lib.melspec_sig_mel_fft_smem.argtypes = [i, i, i]
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
    path is ``(smem, 1, n, False)`` at a DFT of n points: each of a
    block's ``FFT_GROUPS[n]`` groups takes one frame at a time and the
    whole DFT."""

    smem: int
    frames: int
    cols: int
    factored: bool

    @property
    def pipelined(self) -> bool:
        """Whether K1 walks it on the pipelined walk: every 128-frame
        block of K1 does."""
        return self.frames == PIPE_FRAMES


def block_layout(ks: int, hop: int, pack: int, pack_off: int, width: int,
                 npow: int, n_mels_pad: int, split=None) -> Layout:
    """K1's block layout for a head (asks the built kernel, which
    decides it): 128-frame blocks of 128-column chunks on the pipelined
    walk where they and its ring of four stages fit and the head has at
    most 128 padded mel columns, else 64-frame blocks of 256-column chunks
    where they fit, else, for a head with a factored ``split``
    (``factored_route``), the factored path's 64-frame blocks of 512
    power columns (1024 DFT columns), else 32-frame blocks of 256-column
    chunks."""
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
    return block_layout(ks, hop, head.pack, head.pack_off, head.width,
                        head.npow, head.n_mels_pad, factored_route(head, ks))


def pipe_groups(split: bool, live_in: int) -> int:
    """8-column groups of the pipelined walk's stages in a chunk of
    ``live_in`` live power columns (``csrc/sig_pipe.cuh::pipe_groups``): 4
    where they hold them (split: each live re group beside its im group),
    else all 16."""
    return 4 if -(-live_in // 8) * (2 if split else 1) <= 4 else 16


def pipe_plan(width: int, npow: int, live: int) -> list:
    """The pipelined walk's chunks of a head: ``(groups, live columns,
    projection rows)`` each, the rows its live columns rounded up to 16
    (``csrc/sig_pipe.cuh``: ``pipe_groups``, ``pipe_live``,
    ``pipe_kmax``)."""
    split = npow != width
    cp = PIPE_CHUNK_COLS // (2 if split else 1)
    out = []
    for ch in range(-(-live // cp)):
        n = min(cp, live - ch * cp)
        out.append((pipe_groups(split, n), n, (n + 15) & ~15))
    return out


def pipe_index(k_tot: int, width: int, npow: int, live: int,
               blocks: list, pack: int, nmp: int, bf2: bool) -> torch.Tensor:
    """Where each bf16 value of the pipelined walk's stage stream comes
    from: an int64 index into ``m_big`` ``[k_tot, width]`` flattened,
    then (``bf2``) ``mt`` ``[3 npow, nmp]`` flattened, then one zero.
    Per chunk of ``pipe_plan``: for each K block of ``blocks`` (the
    head's ``block_order``) and each 32-row stage of its ``pack`` taps,
    the stage as the ring holds it: ``groups`` column groups of
    ``PIPE_GROUP`` values (core matrix ``k`` of rows ``8k .. 8k + 7`` by
    row and column, then 8 of padding; split: the chunk's re groups, then
    their im groups), zero past ``pack`` and in a group of no live
    column; then (``bf2``) the chunk's projection rows in pieces of
    ``PIPE_ROWS``, each piece's three stacks of ``[rows, nmp]`` swizzled
    as the kernel reads them (16-byte group ``c`` of row ``r`` at ``c ^
    (r & 7)``)."""
    split = npow != width
    cp = PIPE_CHUNK_COLS // (2 if split else 1)
    cpb = -(-pack // 32)
    n_steps = len(blocks) * cpb
    mt0 = k_tot * width
    zero = mt0 + (3 * npow * nmp if bf2 else 0)
    kblk = torch.tensor([b for b, _ in blocks], dtype=torch.int64)
    step = torch.arange(n_steps)
    row = (step % cpb * 32).view(-1, 1, 1, 1, 1) + (
        8 * torch.arange(4).view(1, 1, 4, 1, 1)
        + torch.arange(8).view(1, 1, 1, 8, 1))
    mrow = kblk[step // cpb].view(-1, 1, 1, 1, 1) * pack + row
    parts = []
    for ch, (groups, _, kmax) in enumerate(pipe_plan(width, npow, live)):
        g = torch.arange(groups)
        first = ch * cp + 8 * (g % (groups // 2) if split else g)
        col0 = first + ((g >= groups // 2).long() * npow if split else 0)
        col = col0.view(1, -1, 1, 1, 1) + torch.arange(8).view(1, 1, 1, 1, 8)
        ok = (row < pack) & (first < live).view(1, -1, 1, 1, 1)
        idx = torch.where(ok, mrow * width + col, torch.tensor(zero))
        idx = idx.reshape(n_steps, groups, 256)
        pad = torch.full((n_steps, groups, PIPE_GROUP - 256), zero,
                         dtype=torch.int64)
        parts.append(torch.cat([idx, pad], dim=2).reshape(-1))
        if not bf2:
            continue
        for k0 in range(0, kmax, PIPE_ROWS):
            r = torch.arange(min(PIPE_ROWS, kmax - k0)).view(-1, 1)
            pos = torch.arange(nmp).view(1, -1)
            colm = ((pos >> 3) ^ (r & 7)) * 8 + (pos & 7)
            for s in range(3):
                parts.append((mt0 + (s * npow + ch * cp + k0 + r) * nmp
                              + colm).reshape(-1))
    return torch.cat(parts) if parts else torch.zeros(0, dtype=torch.int64)


def pipe_stages(head: SigHead) -> torch.Tensor:
    """The pipelined walk's stage stream of ``head`` (bf16, on ``m_big``'s
    device): ``m_big`` and, for a bf2 head, ``mt`` gathered by
    ``pipe_index`` in the head's block order, so each ring stage and each
    projection piece is one contiguous copy."""
    m_big, mt = head.m_big, head.mt
    bf2 = head.mel_precision == "bf2"
    idx = pipe_index(m_big.shape[0], head.width, head.npow, head.live,
                     block_order(head.pair_i), head.pack, head.n_mels_pad,
                     bf2)
    src = [m_big.reshape(-1)] + ([mt.reshape(-1)] if bf2 else [])
    src.append(m_big.new_zeros(1))
    return torch.cat(src)[idx.to(m_big.device)].contiguous()


def stage_stream(head: SigHead) -> torch.Tensor:
    """``pipe_stages`` of ``head`` for a launch, checked against the
    kernels' own count of the stream's bytes (``csrc/sig_pipe.cuh::
    pipe_bytes``, which K1 and K2 share; asked of K1's library)."""
    with profiling.span("setup.heads", head="stages"):
        stream = pipe_stages(head)
    want = _bound().melspec_sig_mel_pipe_bytes(
        head.width, head.npow, head.live, len(head.pair_i), head.pack,
        head.n_mels_pad, int(head.mel_precision == "bf2"))
    if 2 * stream.numel() != want:
        raise RuntimeError(f"the head's stage stream holds "
                           f"{2 * stream.numel()} bytes; the kernels read "
                           f"{want}")
    return stream


def fft_layout(head: SigHead) -> Layout:
    """The float64 FFT path's layout for ``head``, which carries ``fft``,
    after the checks its launch applies: a ``ValueError`` where the head
    does not match the description (a DFT size other than the
    description's, or one the path has no instance for, another output
    mode, a window that is not its ``pack`` taps, a frame past the DFT, a
    projection of other columns or precision), so no head meant for the
    path quietly takes another route. The shared memory asks the built
    kernel's instance of the head's size."""
    f = head.fft
    n = f.size
    why = None
    if head.dft_size != n:
        why = f"dft_size {head.dft_size} for a description of {n} points"
    elif head.out_mode not in ("ln_guard", "ln_floor"):
        why = f"out_mode {head.out_mode!r}, not an ln mode"
    elif f.window.shape[0] != head.pack:
        why = f"a window of {f.window.shape[0]} taps for pack {head.pack}"
    elif head.pack_off + head.pack > n:
        why = f"taps [{head.pack_off}, {head.pack_off + head.pack}) past it"
    elif (head.mel_precision != "bf2"
          or f.mt.shape[1] != head.n_mels_pad):
        why = (f"a {head.mel_precision} head of {head.n_mels_pad} mel "
               f"columns for a bf2 projection of {f.mt.shape[1]}")
    if why is not None:
        raise ValueError(f"K1's float64 FFT path: {why}")
    smem = _bound().melspec_sig_mel_fft_smem(n, head.n_mels, f.nnz)
    return Layout(int(smem), 1, n, False)


@functools.lru_cache(maxsize=8)
@profiling.spanned("setup.heads", head="fft_twiddles")
def fft_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """The float64 FFT path's twiddle table of its ``n``-point instance,
    ``Wn^e = (cos, -sin)(2 pi e / n)`` for ``e < FFT_TW`` as float64
    ``[256, 2]`` on ``device`` (``csrc/sig_fft.cuh``: ``FftSize<N>::kTw``).
    At 2048 points, the 1024-point FFT as ``FFT_RADICES[2048]`` = (16, 16,
    4) over ``j = t + 64 n`` and ``k = k1 + 16 (c + 16 d)``: the bases each
    thread raises to the powers it needs, pass 1's ``W1024^(t k1) =
    (W2048^(2 t))^k1`` and pass 2's ``W64^(a c) = (W2048^(32 a))^c`` (``a <
    4``), and the real split's ``W2048^k = W2048^(k1 + 16 c) W8^d`` (bin
    ``1024 - k`` takes ``-conj W2048^k``). At 1024 points, the 512-point
    FFT as (16, 16, 2) over ``j = t + 32 n``: ``W512^(t k1) = (W1024^(2
    t))^k1``, ``W32^(a c) = (W1024^(32 a))^c`` (``a < 2``) and ``W1024^k =
    W1024^(k1 + 16 c) W4^d``."""
    if n not in FFT_SIZES:
        raise ValueError(f"the float64 FFT path has no {n}-point instance")
    ang = 2 * np.pi * np.arange(FFT_TW) / n
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


def magnitude_refusal(head: SigHead) -> str | None:
    """Why K1 refuses ``head`` as a magnitude head, or None: an N-packed
    head squares each DFT column alone and never holds a bin's ``re^2 +
    im^2`` to take the root of."""
    if head.magnitude and not head.n_bins_pad:
        return ("K1 takes a magnitude head split into re|im halves; an "
                "N-packed head holds no bin's re^2 + im^2")
    return None


def _smem_refusal(smem: int, head: SigHead, hop: int) -> str | None:
    """Why K1 refuses ``head`` at ``hop`` where its block needs ``smem``
    bytes of shared memory, or None."""
    if smem > MAX_SMEM_BYTES:
        return (f"K1 needs {smem} bytes of shared memory for hop {hop}, "
                f"{head.pack} taps at {head.pack_off}, {head.npow} power "
                f"columns; a block has {MAX_SMEM_BYTES}")
    return None


def k1_accepts(head: SigHead, *, hop: int, ks: int = 3) -> bool:
    """Whether K1 takes ``head`` at ``hop`` with ``ks`` signal slices: the
    shape and magnitude checks of ``check_head`` and the shared-memory
    check of the launch, the same functions the launch applies. The auto
    routes pick K1 only where this holds."""
    if (shape_refusal(head.width, head.n_bins_pad, head.n_mels_pad,
                      "K1") is not None
            or magnitude_refusal(head) is not None):
        return False
    return _smem_refusal(_smem_bytes(head, hop, ks), head, hop) is None


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


def check_head(samples: torch.Tensor, head: SigHead, *, ks: int, what: str,
               widths: tuple = WIDTHS) -> None:
    """Validate the signal and one head for K1 or K2 (``widths``: the DFT
    widths the kernel takes)."""
    h, dev = head, samples.device
    if samples.dtype != torch.float32 or samples.dim() != 2:
        raise ValueError(f"{what} takes a [B, T] float32 signal")
    if h.m_big.dtype != torch.bfloat16 or h.m_big.device != dev:
        raise ValueError("m_big must be a bf16 tensor on the signal's device")
    refusal = (shape_refusal(h.width, h.n_bins_pad, h.n_mels_pad, what,
                             widths) or magnitude_refusal(h))
    if refusal is not None:
        raise NotImplementedError(refusal)
    if h.out_mode not in OUT_MODES:
        raise ValueError(f"out_mode must be one of {OUT_MODES}")
    want = ((torch.bfloat16, 3 * h.npow) if h.mel_precision == "bf2"
            else (torch.float32, h.npow))
    if (h.mt.dtype, h.mt.shape[0]) != want or h.mt.device != dev:
        raise ValueError(f"mt must be {want[0]} with {want[1]} rows on the "
                         f"signal's device; got {h.mt.dtype} "
                         f"{tuple(h.mt.shape)}")
    if h.n_mels_pad % 128 or h.n_mels > h.n_mels_pad:
        raise ValueError("mt's columns must be n_mels padded to 128")
    pair_i = h.pair_i
    if not (0 < len(pair_i) <= MAX_BLOCKS and 0 < ks <= MAX_SLICES
            and max(pair_i) < ks and min(pair_i) >= 0 and h.pack > 0
            and h.pack_off >= 0 and len(pair_i) * h.pack <= h.m_big.shape[0]):
        raise ValueError(f"{what} takes <= {MAX_BLOCKS} K blocks of "
                         f"<= {MAX_SLICES} signal slices; got pair_i "
                         f"{pair_i}, ks {ks}, pack {h.pack}")


def raise_for(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.melspec_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({rc})")


def _launch(samples, head: SigHead, *, ks, n_frames, hop, offset,
            epilogue: str | None = None, vad: tuple = (0.0, 0)) -> tuple:
    """One K1 launch of ``head``. On the pipelined walk the head's stage
    stream comes from its ``StageSlot``; where ``head_layout`` gives
    layout 3, the factored path runs, from ``factored_dft``'s tables, and
    for a head carrying ``fft`` the float64 FFT path, from its
    description (``m_big`` is not read by either; a launch that fails
    raises: no other route stands in). ``epilogue``: None (the float
    mel), ``"quant"`` (the u8 records ``q, lo, hi`` and no float mel) or
    ``"vad"`` (the mel and the Sobel counts at ``vad = (thr, start_y)``).
    Returns the outputs as a tuple."""
    global launches, factored_launches, fft_launches, pipelined_launches
    global magnitude_launches
    h, dev = head, samples.device
    check_head(samples, h, ks=ks, what="K1")
    if epilogue is not None:
        check_epilogue(h, epilogue)
    layout = head_layout(h, hop, ks)
    smem, frames, _, factored = layout
    pipe = layout.pipelined
    refusal = _smem_refusal(smem, h, hop)
    if refusal is not None:
        raise NotImplementedError(refusal)
    b, t = samples.shape
    out = q = lo = hi = counts = None
    if epilogue == "quant":
        q = torch.empty((b, n_frames, h.n_mels), dtype=torch.uint8,
                        device=dev)
        lo = torch.empty((b, n_frames), dtype=torch.float32, device=dev)
        hi = torch.empty_like(lo)
        outs = (q, lo, hi)
    else:
        out = torch.empty((b, n_frames, h.n_mels), dtype=torch.float32,
                          device=dev)
        outs = (out,)
        if epilogue == "vad":
            counts = torch.empty((b, n_frames), dtype=torch.int32,
                                 device=dev)
            outs = (out, counts)
    if b == 0 or n_frames <= 0:
        return outs
    samples = samples.contiguous()
    staged = h.stages.stream(h) if pipe else None
    mt = aligned(h.mt)
    bf2 = int(h.mel_precision == "bf2")
    mode, guard = OUT_MODES.index(h.out_mode), clamped_guard(h.guard)
    fft = h.fft
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
                samples.data_ptr(), b, t, n_frames, hop, offset, fft.size,
                h.pack, h.pack_off,
                fft.window.contiguous().data_ptr(),
                fft_twiddles(fft.size, dev).data_ptr(),
                -1.0 if fft.preemph is None else float(fft.preemph),
                fft.mel_off.data_ptr(), fft.mel_lo.data_ptr(),
                fft.f0.data_ptr(), fft.f1.data_ptr(), fft.nnz, h.n_mels,
                mode, guard, int(h.magnitude), out.data_ptr(), stream)
        elif factored:
            fac = factored_dft(h.dft_size, dev)
            rc = lib.melspec_sig_mel_factored(
                samples.data_ptr(), b, t, n_frames, hop, offset,
                vad_tile(frames), fac.n1, fac.n2, fac.window.data_ptr(),
                fac.f1.data_ptr(), fac.tw.data_ptr(), fac.f2.data_ptr(),
                fac.rowmap.data_ptr(), mt.data_ptr(), h.npow, h.n_mels,
                h.n_mels_pad, bf2, ptr(out), ptr(q), ptr(lo), ptr(hi),
                ptr(counts), vad[0], int(vad[1]), stream)
        else:
            m_big = aligned(h.m_big)
            blocks = block_table(h.pair_i, dev)
            rc = lib.melspec_sig_mel(
                samples.data_ptr(), b, t, n_frames, hop, offset,
                vad_tile(frames), m_big.data_ptr(), h.width, h.pack,
                h.pack_off, blocks.data_ptr(), len(h.pair_i), ks, h.npow,
                h.live, mt.data_ptr(), h.n_mels, h.n_mels_pad, bf2, mode,
                guard, int(h.magnitude), ptr(out), ptr(q), ptr(lo), ptr(hi),
                ptr(counts), vad[0], int(vad[1]), ptr(staged), stream)
    raise_for(lib, rc, "K1 (sig_mel)")
    launches += 1
    factored_launches += int(factored)
    fft_launches += int(fft is not None)
    pipelined_launches += int(pipe)
    magnitude_launches += int(h.magnitude)
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


def sig_mel(samples: torch.Tensor, head: SigHead, *, ks: int,
            n_frames: int, hop: int, offset: int) -> torch.Tensor:
    """K1 on ``head`` for a CUDA signal, its plain version
    (``sig_mel_reference``) for a CPU one. On the CUDA signal the head's
    ``live`` lets K1 skip the power columns that are zero, its
    ``dft_size`` takes the factored path where ``factored_route`` gives a
    split and the head's own layout would be 32-frame blocks, its ``fft``
    the float64 FFT path, and its ``stages`` keeps the pipelined walk's
    stage stream between launches. On the CPU the DFT dot is summed
    exactly (float64): the f32 sum of a CPU BLAS changes with its thread
    count, and on near-silent mel bins that order alone can cost more
    than the accuracy gates allow."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset)
    return _on_device(
        samples, lambda: _launch(samples, head, **kw)[0],
        lambda: sig_mel_reference(samples, head, dot_dtype=torch.float64,
                                  **kw))


def sig_mel_quantized(samples: torch.Tensor, head: SigHead, *, ks: int,
                      n_frames: int, hop: int, offset: int) -> tuple:
    """K1 on a whisper ``head`` with the quant epilogue for a CUDA signal,
    its plain version for a CPU one (float64 DFT dot, as ``sig_mel``):
    ``(q [B, n_frames, n_mels] u8, lo [B, n_frames], hi [B, n_frames])``,
    each frame's record of ``quantize_frames``; the kernel writes no
    float mel."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset)
    return _on_device(
        samples, lambda: _launch(samples, head, epilogue="quant", **kw),
        lambda: sig_mel_quantized_reference(samples, head,
                                            dot_dtype=torch.float64, **kw))


def sig_mel_vad(samples: torch.Tensor, head: SigHead, *, ks: int,
                n_frames: int, hop: int, offset: int, vad: tuple) -> tuple:
    """K1 on a whisper ``head`` with the Sobel VAD epilogue for a CUDA
    signal, its plain version for a CPU one (float64 DFT dot): ``(mel [B,
    n_frames, n_mels], counts [B, n_frames] int32)`` at ``vad = (thr,
    start_y)``; the counts of the last two frames of each
    ``k1_vad_tile`` tile are 0 (see ``tile_vad_counts``)."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset)
    return _on_device(
        samples,
        lambda: _launch(samples, head, epilogue="vad", vad=vad, **kw),
        lambda: sig_mel_vad_reference(samples, head, vad=vad,
                                      dot_dtype=torch.float64, **kw))
