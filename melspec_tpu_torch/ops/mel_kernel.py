"""Whisper log-mel through the fused kernels (port of
``melspec_tpu.ops.mel_kernel``): the signal-input sig route on K1 (with
its u8 wire-record and Sobel VAD epilogues, ``whisper_mel_quantized`` and
``whisper_mel_vad_sig``; at the wide hops K1's factored path, from the
DFT size the matrices carry) and the precision dial's framed routes on
K5-K8.

The host builders make the device matrices exactly as the JAX package
does. For K1 the window-folded real-DFT matrix is cut into rounded-bf16
planes and K-stacked in slice-pair order (``m_big``, ``pair_i``), next to
the mel projection in f32 (``mt``) and as a 2-slice bf16 stack
(``mt_bf2``). For K5-K8 it is cut per scheme into rounded-bf16 planes
(bf3), int8 7-bit planes (hp8), integer-valued bf16 planes (hp_bf16) or
kept in float32 (f32). ``whisper_mel_sig`` runs K1
(``kernels/sig_mel.py``) and ``whisper_mel_pallas`` any of the five
(``kernels/framed_mel.py`` for K5-K8) on a CUDA signal, and their plain
PyTorch versions on a CPU one.

Not carried over from the JAX functions: ``interpret`` (no interpret mode
for a CUDA kernel), the quant epilogue's ``qabl`` ablations,
``input_mode`` / ``flat_rows`` and the macro-row ``row_w`` / ``phases`` /
``rows_tile`` geometry, the ``_pad_for_flat`` batch padding and the framed
kernels' 256- and 512-frame tiles with the frame-count padding to them —
all TPU tiling. K1 frames any ``[B, T]`` signal as it is, and its VAD
epilogue's tile-boundary columns follow its own tile (64 frames, 32 in
its 32-frame blocks, which the wide whisper heads of the (3, 2) schedule
leave for the factored path's 64); the framed
kernels mask their ragged last block, so the framed route passes exactly
``B * n_frames`` frames.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from melspec_tpu_torch._device import as_signal, resolve_device
from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.kernels.framed_mel import (IMPLS, FramedMatrices,
                                                  framed_mel)
from melspec_tpu_torch.kernels.sig_mel import (FFT_N, NYQUIST_TOL,
                                               FftHead, SigHead,
                                               StageSlot, k1_accepts,
                                               k1_vad_tile, live_columns,
                                               sig_mel,
                                               sig_mel_quantized,
                                               sig_mel_reference, sig_mel_vad,
                                               vad_args)
from melspec_tpu_torch.ops import dft, framing
from melspec_tpu_torch.ops.vad import fix_raw
from melspec_tpu_torch.ops.filterbank import mel_filterbank
from melspec_tpu_torch.ops.hp_dft import bf16_round_slices, matrix_slices
from melspec_tpu_torch.ops.windows import hann_periodic
from melspec_tpu_torch.utils import profiling

__all__ = [
    "FramedMatrices", "SigHead", "SigMatrices", "framed_input",
    "framed_matrices", "pallas_schedule", "resolve_pallas_impl",
    "sig_geometry", "sig_mel_reference",
    "whisper_head", "whisper_mel_pallas", "whisper_mel_quantized",
    "whisper_mel_sig", "whisper_mel_vad_sig",
]

LANES = 128


def sig_geometry(fft_size: int, hop_size: int, offset: int = 0):
    """The JAX kernel's macro-row geometry ``(row_w, phases, rows_tile)``,
    or ``None`` for a config it rejects. The port keeps it only as the
    acceptance predicate, so both packages take the same configs."""
    if hop_size < 8:
        return None
    k_pad = -(-fft_size // LANES) * LANES
    base = hop_size * LANES // math.gcd(hop_size, LANES)
    row_w = base
    while row_w + hop_size < k_pad + offset:
        row_w += base
    if row_w > 4096:
        return None
    phases = row_w // hop_size
    rows_tile = max(8, ((512 // phases) // 8) * 8)
    while rows_tile > 8 and 2 * (rows_tile + 8) * row_w * 4 > (4 << 20):
        rows_tile -= 8
    return row_w, phases, rows_tile


def sig_packed_im_bins(fft_size: int, n_bins: int) -> list:
    """Bins whose imaginary DFT column is not identically zero: every bin
    except DC and (for even fft sizes) Nyquist."""
    return [j for j in range(1, n_bins) if 2 * j != fft_size]


def _sig_stack_combined(csw: np.ndarray, ks: int, km: int, cutoff: int,
                        pack: int | None = None, pack_off: int = 0):
    """Cut the float64 spectral matrix ``[k_pad, width]`` into rounded-bf16
    planes and K-stack the kept slice pairs ``(i, j)``, ``i + j <=
    cutoff``, i-major; each block keeps its ``pack`` real rows starting
    at row ``pack_off`` (all ``k_pad`` rows when ``pack`` is None) and
    the stack is padded to a multiple of 128 rows. Returns ``(m_big bf16
    [K_tot, width], pair_i)``."""
    k_rows = csw.shape[0] if pack is None else pack
    k_lo = pack_off if pack is not None else 0
    planes = bf16_round_slices(csw, km)
    pair_i = []
    blocks = []
    for i in range(ks):
        for j in range(min(cutoff - i, km - 1) + 1):
            pair_i.append(i)
            blocks.append(planes[j][k_lo : k_lo + k_rows])
    stack = torch.cat(blocks, dim=0)
    k_tot = -(-stack.shape[0] // LANES) * LANES
    if k_tot != stack.shape[0]:
        stack = torch.cat([stack, stack.new_zeros(
            (k_tot - stack.shape[0], stack.shape[1]))])
    return stack, tuple(pair_i)


def bf2_stack(mt) -> torch.Tensor:
    """2-slice rounded-bf16 K-stack ``[F0; F1; F0]`` of a filter
    projection, pairing with K1's power slices ``[p0 | p0 | p1]``."""
    f0, f1 = bf16_round_slices(np.asarray(mt, np.float64), 2)
    return torch.cat([f0, f1, f0], dim=0)


def _sig_frontend_matrices(fft_size: int, n_bins: int, window: np.ndarray,
                           filters: np.ndarray, ks: int, km: int,
                           cutoff: int, pack: int | None = None,
                           pack_off: int = 0, npack: str | bool = "auto",
                           preproc: np.ndarray | None = None):
    """K1's and K2's matrices for any windowed-rDFT -> power ->
    filterbank frontend (whisper mel, NeMo log-mel, Kaldi fbank): the
    K-stacked bf16 plane matrix with ``window`` folded in, its pair
    order, and the float64 projection from ``filters [n_mels, >=
    n_bins]``. Bit for bit the JAX function's matrices.

    Two column layouts (``npack``; ``"auto"`` picks the narrower):

    - SPLIT (``npack=False``): re in ``[0, n_bins_pad)``, im in
      ``[n_bins_pad, 2*n_bins_pad)``; power is ``re*re + im*im`` and
      ``mt`` is ``[n_bins_pad, n_mels_pad]``.
    - N-PACKED (``npack=True``): re columns for every bin, then im columns
      only for bins whose sin column is not identically zero (not DC, not
      Nyquist); power is ``y*y`` per column and ``mt [n_cols_pad,
      n_mels_pad]`` holds each filter row twice (once per component), so
      the re/im add rides the projection. A 257-bin head (fft 512) takes
      512 columns instead of 768.

    ``window`` may be shorter than ``fft_size`` (Kaldi's 400-in-512
    frame). ``preproc`` left-folds a per-frame linear map ``[taps,
    taps_src]`` into the spectral rows (Kaldi's DC removal and
    preemphasis); a rectangular one widens the frame to ``taps_src`` raw
    samples (NeMo's cross-frame preemphasis). ``pack`` / ``pack_off``
    keep rows ``[pack_off, pack_off + pack)`` of each K block.

    Returns ``(m_big, pair_i, mt, n_bins_pad, n_mels_pad, k_pad, npack)``
    where ``n_bins_pad`` is the split point, 0 when packed."""
    n_mels = filters.shape[0]
    n_bins_pad = -(-n_bins // LANES) * LANES
    n_mels_pad = -(-n_mels // LANES) * LANES
    k_pad = -(-fft_size // LANES) * LANES

    im_bins = sig_packed_im_bins(fft_size, n_bins)
    n_cols_pad = -(-(n_bins + len(im_bins)) // LANES) * LANES
    if npack == "auto":
        npack = n_cols_pad < 2 * n_bins_pad

    cos_m, msin_m = dft.rdft_matrices(fft_size, n_bins)
    w = np.asarray(window, np.float64)[:, None]
    taps = w.shape[0]
    if pack_off and taps < fft_size:
        # a short window writes rows [0, taps) while pack_off keeps rows
        # [pack_off, pack_off + pack): real rows would drop silently
        raise ValueError(
            "pack_off > 0 requires a full fft_size-length window"
        )
    cwf = w * cos_m[:taps]  # [taps, n_bins] float64, window folded
    swf = w * msin_m[:taps]
    if preproc is not None:
        pre_t = np.asarray(preproc, np.float64).T
        cwf = pre_t @ cwf
        swf = pre_t @ swf
        # the spectral rows now index RAW window positions
        taps = cwf.shape[0]
        k_pad = max(k_pad, -(-taps // LANES) * LANES)
    filt = np.asarray(filters, np.float64)[:, :n_bins].T  # [n_bins, n_mels]
    if npack:
        csw = np.zeros((k_pad, n_cols_pad))
        csw[:taps, :n_bins] = cwf
        csw[:taps, n_bins : n_bins + len(im_bins)] = swf[:, im_bins]
        mt = np.zeros((n_cols_pad, n_mels_pad))
        mt[:n_bins, :n_mels] = filt
        mt[n_bins : n_bins + len(im_bins), :n_mels] = filt[im_bins]
    else:
        csw = np.zeros((k_pad, 2 * n_bins_pad))
        csw[:taps, :n_bins] = cwf
        csw[:taps, n_bins_pad : n_bins_pad + n_bins] = swf
        mt = np.zeros((n_bins_pad, n_mels_pad))
        mt[:n_bins, :n_mels] = filt
    m_big, pair_i = _sig_stack_combined(
        csw, ks, km, cutoff, pack=fft_size if pack is None else pack,
        pack_off=pack_off)
    return (m_big, pair_i, mt, 0 if npack else n_bins_pad, n_mels_pad,
            k_pad, npack)


def sig_fft_head(fft_size: int, window: np.ndarray, mt: np.ndarray,
                 preemph: float | None = None) -> tuple:
    """``(dft_size, FftHead)`` of an ln head whose frame is
    ``len(window)`` taps inside an ``fft_size``-point DFT (Kaldi fbank,
    NeMo log-mel), for K1's float64 FFT path: the float64 window, the
    preprocessing (``preemph``: Kaldi's DC removal and preemphasis, None
    for none) and the bf2 projection in bin order, ``bf2_stack`` of the
    float64 ``mt``'s rows of the bins below ``fft_size / 2`` (so its rows
    equal those of the head's own stack bit for bit; a split magnitude
    head's ``mt`` may end there, ``magnitude_matrices``). ``(0, None)`` where
    the path does not take the head: a DFT of other than ``FFT_N``
    points, or filters whose Nyquist row, which it does not compute,
    exceeds ``NYQUIST_TOL``; such a head keeps its chunk walk."""
    half = fft_size // 2
    if (fft_size != FFT_N or len(window) > fft_size
            or (mt.shape[0] > half
                and float(np.abs(mt[half]).max()) > NYQUIST_TOL)):
        return 0, None
    return fft_size, FftHead(
        torch.as_tensor(np.asarray(window, np.float64)),
        None if preemph is None else float(preemph), bf2_stack(mt[:half]))


def magnitude_matrices(fft_size: int, window: np.ndarray,
                       filters: np.ndarray, **kw) -> tuple:
    """``_sig_frontend_matrices`` (``kw``: its keywords past ``filters``)
    of a magnitude head, which is split (an N-packed head never holds a
    bin's ``re^2 + im^2`` to take the root of): ``(m_big, pair_i, mt,
    n_bins_pad)``. Its bins are the ``fft_size // 2`` below the Nyquist
    bin where the filters weigh it at most ``NYQUIST_TOL`` (re|im halves
    of ``fft_size // 2`` columns each, a width K1 takes: 512 and 512 at
    n_fft 1024), else all ``fft_size // 2 + 1``; the re and im columns of
    the bins past the last one any filter weighs are zero (NeMo's TTS mel
    stops at 8 kHz of 11.025), so that the head's ``live_columns`` ends
    there and K1 skips them: their magnitude meets only zero rows of the
    projection."""
    half = fft_size // 2
    n_bins = half if float(np.abs(filters[:, half]).max()) <= NYQUIST_TOL \
        else half + 1
    m_big, pair_i, mt, n_bins_pad, _, _, _ = _sig_frontend_matrices(
        fft_size, n_bins, window, filters, npack=False, **kw)
    weighted = np.nonzero(np.abs(filters[:, :n_bins]).max(axis=0))[0]
    last = int(weighted[-1]) + 1 if weighted.size else 0
    m_big[:, last:n_bins_pad] = 0
    m_big[:, n_bins_pad + last :] = 0
    return m_big, pair_i, mt, n_bins_pad


@functools.lru_cache(maxsize=8)
def _sig_device_matrices(fft_size: int, n_mels: int, sampling_rate: float,
                         ks: int, km: int, cutoff: int):
    """Whisper instantiation (the projection zeroes bins >= fft/2), plus
    the bf2 mel stack. The JAX function's tuple less its ``npack``, as
    CPU tensors: ``(m_big, pair_i, mt f32, mt_bf2, n_bins_pad, n_mels_pad,
    k_pad)``. Always the split layout: the kernels take 256- to
    2048-column heads (K2: to 1024), and where JAX's "auto" would pack a
    whisper head (fft 320: 384 columns) the split layout keeps a width
    they take."""
    half = fft_size // 2
    filters = mel_filterbank(sampling_rate, fft_size, n_mels)
    m_big, pair_i, mt, n_bins_pad, n_mels_pad, k_pad, _ = \
        _sig_frontend_matrices(fft_size, half, hann_periodic(fft_size),
                               filters, ks, km, cutoff, npack=False)
    mt_bf2 = bf2_stack(mt)
    return (m_big, pair_i, torch.as_tensor(mt, dtype=torch.float32), mt_bf2,
            n_bins_pad, n_mels_pad, k_pad)


@dataclasses.dataclass(frozen=True)
class SigMatrices:
    """K1's device matrices: ``m_big`` bf16 ``[K_tot, 2*n_bins_pad]``,
    ``pair_i``, ``mt`` f32 ``[n_bins_pad, n_mels_pad]``, ``mt_bf2`` bf16
    ``[3*n_bins_pad, n_mels_pad]``, the re|im split point ``n_bins_pad``,
    the power columns that can be nonzero (``live_columns`` of the host
    matrix), ``dft_size``, the N whose Hann-windowed DFT ``m_big`` is
    (``SigHead.dft_size``; 0 for matrices from elsewhere), and ``stages``,
    the slot of K1's pipelined stage stream (``SigHead.stages``), which
    the heads that ``head`` makes share."""

    m_big: torch.Tensor
    pair_i: tuple
    mt: torch.Tensor
    mt_bf2: torch.Tensor
    n_bins_pad: int
    live: int
    dft_size: int = 0
    stages: StageSlot = dataclasses.field(default_factory=StageSlot,
                                          compare=False, repr=False)

    def to(self, device) -> "SigMatrices":
        if all(t.device == torch.device(device)
               for t in (self.m_big, self.mt, self.mt_bf2)):
            return self
        return dataclasses.replace(
            self, m_big=self.m_big.to(device), mt=self.mt.to(device),
            mt_bf2=self.mt_bf2.to(device), stages=StageSlot())

    def head(self, fft_size: int, n_mels: int, mel_precision: str = "bf2",
             pack_off: int = 0) -> SigHead:
        """The whisper head of these matrices: taps ``[pack_off, pack_off
        + fft_size)`` of each frame, ``n_mels`` columns, the bf2 stack
        (``"bf2"``) or the f32 projection (``"highest"``)."""
        if mel_precision not in ("bf2", "highest"):
            raise ValueError("mel_precision must be 'bf2' or 'highest'")
        return SigHead(self.m_big, self.pair_i,
                       self.mt_bf2 if mel_precision == "bf2" else self.mt,
                       self.n_bins_pad, fft_size, n_mels, pack_off=pack_off,
                       live=self.live, dft_size=self.dft_size,
                       stages=self.stages)


@functools.lru_cache(maxsize=16)
@profiling.spanned("setup.heads", head="whisper")
def sig_matrices(fft_size: int, n_mels: int, sampling_rate: float, ks: int,
                 cutoff: int, device: torch.device) -> SigMatrices:
    """The whisper matrices for ``(ks, cutoff)``, cached on ``device``."""
    m_big, pair_i, mt, mt_bf2, n_bins_pad, _, _ = _sig_device_matrices(
        fft_size, n_mels, float(sampling_rate), ks, ks, cutoff)
    return SigMatrices(m_big, pair_i, mt, mt_bf2, n_bins_pad,
                       live_columns(m_big, n_bins_pad), fft_size).to(device)


def whisper_head(fft_size: int, n_mels: int, sampling_rate: float,
                 device: torch.device, pack_off: int = 0) -> SigHead:
    """The whisper frontend (bf2 projection, (ks, cutoff) = (3, 2)) as a
    head of K2, contracting taps ``[pack_off, pack_off + fft_size)`` of
    each frame."""
    return sig_matrices(fft_size, n_mels, float(sampling_rate), 3, 2,
                        device).head(fft_size, n_mels, pack_off=pack_off)


def _k1_input(samples, fft_size: int, hop_size: int, streaming: bool,
              device, what: str) -> tuple:
    """``samples`` ``[T]`` or ``[B, T]`` as a 2-D signal on the resolved
    device and K1's frame grid: ``(x [B, T], squeeze, offset, n_frames)``;
    ``streaming`` offsets the frames by ``ceil(fft/hop)*hop - fft``.
    Raises for a config without the JAX package's macro-row geometry."""
    x = as_signal(samples, resolve_device(device))
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    offset = 0
    if streaming:
        offset = framing.streaming_frame_offset(fft_size, hop_size)
        n_frames = framing.num_frames_streaming(x.shape[-1], fft_size,
                                                hop_size)
    else:
        n_frames = framing.num_frames_batch(x.shape[-1], fft_size, hop_size)
    if sig_geometry(fft_size, hop_size, offset) is None:
        raise ValueError(
            f"no macro-row geometry for this (fft, hop); {what}, as the "
            "JAX package does"
        )
    return x, squeeze, offset, n_frames


def whisper_mel_sig(
    samples,
    fft_size: int = 400,
    hop_size: int = 160,
    n_mels: int = 80,
    sampling_rate: float = 16000.0,
    streaming: bool = False,
    ks: int = 3,
    cutoff: int = 2,
    mel_precision: str = "bf2",
    device=None,
    matrices: SigMatrices | None = None,
) -> torch.Tensor:
    """Whisper log-mel from the raw signal through K1 (bf16 slice-pair
    DFT, framing inside the kernel). ``samples`` ``[T]`` or ``[B, T]`` ->
    ``[n_frames, n_mels]`` / ``[B, n_frames, n_mels]`` float32 on
    ``device``; ``streaming=True`` gives the streaming-equivalent frames
    (offset by ``ceil(fft/hop)*hop - fft``) in the same frame-major
    layout.

    ``mel_precision``: ``"bf2"`` (2-slice bf16 projection) or
    ``"highest"`` (f32). ``(ks, cutoff)`` is the slice-pair schedule;
    (3, 2) is the least with 24-bit absolute DFT accuracy, (2, 1) misses
    the 1e-5 JFK gate (1.0e-3 in the JAX package's measurement).
    ``matrices`` replaces the host-built matrices (for example with the
    JAX package's, through ``convert.from_jax_sig_matrices``)."""
    x, squeeze, offset, n_frames = _k1_input(
        samples, fft_size, hop_size, streaming, device,
        "use whisper_mel_pallas(impl='bf3')")
    if mel_precision not in ("bf2", "highest"):
        raise ValueError("mel_precision must be 'bf2' or 'highest'")
    if n_frames <= 0 or x.shape[0] == 0:
        out = torch.zeros((x.shape[0], max(n_frames, 0), n_mels),
                          dtype=torch.float32, device=x.device)
        return out[0] if squeeze else out
    mats = (sig_matrices(fft_size, n_mels, float(sampling_rate), ks, cutoff,
                         x.device)
            if matrices is None else matrices.to(x.device))
    out = sig_mel(x, mats.head(fft_size, n_mels, mel_precision), ks=ks,
                  n_frames=n_frames, hop=hop_size, offset=offset)
    return out[0] if squeeze else out


def whisper_mel_quantized(
    samples,
    fft_size: int = 400,
    hop_size: int = 160,
    n_mels: int = 80,
    sampling_rate: float = 16000.0,
    streaming: bool = False,
    ks: int = 3,
    cutoff: int = 2,
    mel_precision: str = "bf2",
    device=None,
) -> tuple:
    """Whisper log-mel emitted directly as per-frame 8-bit wire records
    through K1's quant epilogue: ``(q [B, F, n_mels] uint8, lo [B, F] f32,
    hi [B, F] f32)`` (1-D input: unbatched), on ``device``.

    The reference's live path quantizes every emitted mel column with its
    own min/max range before shipping it (``src/wasm.rs:95-145``, the
    ``min | max | u8[n_mels]`` record). K1 quantizes each frame while its
    normalized row is still in shared memory, bit-equal to
    ``ops.quant.quantize_frames`` of ``whisper_mel_sig``'s mel on the same
    input, and writes ``n_mels + 8`` bytes a frame where the float mel
    takes ``4 * n_mels``. Same geometry and arguments as
    ``whisper_mel_sig``; on a CPU signal the plain version runs."""
    x, squeeze, offset, n_frames = _k1_input(
        samples, fft_size, hop_size, streaming, device,
        "quantize whisper_mel_pallas's output with quantize_frames instead")
    if n_frames <= 0 or x.shape[0] == 0:
        nf = max(n_frames, 0)
        q = torch.zeros((x.shape[0], nf, n_mels), dtype=torch.uint8,
                        device=x.device)
        z = torch.zeros((x.shape[0], nf), dtype=torch.float32,
                        device=x.device)
        return (q[0], z[0], z[0]) if squeeze else (q, z, z)
    head = sig_matrices(fft_size, n_mels, float(sampling_rate), ks, cutoff,
                        x.device).head(fft_size, n_mels, mel_precision)
    q, lo, hi = sig_mel_quantized(x, head, ks=ks, n_frames=n_frames,
                                  hop=hop_size, offset=offset)
    return (q[0], lo[0], hi[0]) if squeeze else (q, lo, hi)


def whisper_mel_vad_sig(
    samples,
    settings: DetectionSettings,
    fft_size: int = 400,
    hop_size: int = 160,
    n_mels: int = 80,
    sampling_rate: float = 16000.0,
    streaming: bool = False,
    device=None,
) -> tuple:
    """Whisper log-mel and the raw Sobel VAD column activity from one K1
    launch with the VAD epilogue: ``(mel [..., F, n_mels], raw [..., F-2]
    bool)``, ``raw`` equal to ``classify_columns(mel.T, settings)`` (the
    reference's per-column decision input, ``src/vad.rs:373-415``).

    K1 counts each frame's edges on the tile it holds in shared memory;
    the two columns whose 3-frame patch crosses each boundary of its
    tiles (``kernels/sig_mel.py::k1_vad_tile``: 64 frames, 32 in the
    32-frame blocks) are recomputed here from the mel
    output (``ops.vad.fix_raw``). A clip of 1-2 frames has no Sobel column: it
    returns ``whisper_mel_sig``'s real mel and an empty ``raw``. On a CPU
    signal the plain version runs."""
    x, squeeze, offset, n_frames = _k1_input(
        samples, fft_size, hop_size, streaming, device,
        "compute the mel with whisper_mel_pallas and classify_columns "
        "separately")
    if n_mels < 3:
        raise ValueError("Sobel VAD needs n_mels >= 3")
    if n_frames < 3 or x.shape[0] == 0:
        mel = whisper_mel_sig(x, fft_size, hop_size, n_mels, sampling_rate,
                              streaming=streaming, device=x.device)
        raw = torch.zeros((x.shape[0], 0), dtype=torch.bool, device=x.device)
        return (mel[0], raw[0]) if squeeze else (mel, raw)
    head = whisper_head(fft_size, n_mels, sampling_rate, x.device)
    mel, counts = sig_mel_vad(x, head, ks=3, n_frames=n_frames,
                              hop=hop_size, offset=offset,
                              vad=vad_args(settings, n_mels))
    tile = k1_vad_tile(head, hop_size, x.device)
    raw = fix_raw(counts, mel, n_frames, n_frames - 2, settings, tile)
    return (mel[0], raw[0]) if squeeze else (mel, raw)


# --------------------------------------------------------------------------
# The precision dial: framed routes on K5-K8. Host builders in float64,
# bit for bit the JAX package's (CPU tensors), cached per device.


def _build_matrices(fft_size: int, n_mels: int, sampling_rate: float):
    """Window-folded DFT matrices ``[k_pad, n_bins_pad]`` and the padded
    mel projection ``[n_bins_pad, n_mels_pad]`` (float64 host build, cast
    by the caller): ``(cw, sw, mt, n_bins_pad, n_mels_pad, k_pad)``."""
    half = fft_size // 2  # the whisper projection zeroes bins >= fft/2
    n_bins_pad = -(-half // LANES) * LANES
    n_mels_pad = -(-n_mels // LANES) * LANES
    k_pad = -(-fft_size // LANES) * LANES
    cos_m, msin_m = dft.rdft_matrices(fft_size, half)
    window = hann_periodic(fft_size)
    cw = np.zeros((k_pad, n_bins_pad))
    sw = np.zeros((k_pad, n_bins_pad))
    cw[:fft_size, :half] = window[:, None] * cos_m
    sw[:fft_size, :half] = window[:, None] * msin_m
    filters = mel_filterbank(sampling_rate, fft_size, n_mels)
    mt = np.zeros((n_bins_pad, n_mels_pad))
    mt[:half, :n_mels] = filters[:, :half].T
    return cw, sw, mt, n_bins_pad, n_mels_pad, k_pad


def _matrix_slices_i8(mat, n_slices: int) -> list:
    """7-bit integer slices CLIPPED to the int8 range: int8 cannot hold
    +-128, which the window-folded DFT matrices hit (``|w*cos| = 1`` on the
    frame-centre row); the clipped remainder flows into the next plane's
    residual."""
    out = []
    residual = np.asarray(mat, np.float64).copy()
    for _ in range(n_slices):
        t = np.clip(np.trunc(residual * 128.0), -127.0, 127.0)
        residual = residual * 128.0 - t
        out.append(t.astype(np.int8))
    return out


def _hp8_plane_widths(ks: int, km: int, cutoff: int) -> list:
    """Number of matrix planes signal slice ``i`` pairs with; slices past
    ``cutoff`` pair with nothing, so ``ks`` is clamped."""
    return [min(cutoff - i, km - 1) + 1 for i in range(min(ks, cutoff + 1))]


@functools.lru_cache(maxsize=8)
def _hp8_device_matrices(fft_size: int, n_mels: int, sampling_rate: float,
                         ks: int, km: int, cutoff: int):
    """Per signal slice ``i`` its int8 plane concat ``[cos_0 .. cos_J |
    sin_0 .. sin_J]``, ``J = n_p(i) - 1``: ``(slice_mats, mt f32,
    n_bins_pad, n_mels_pad, k_pad)``."""
    cw, sw, mt, n_bins_pad, n_mels_pad, k_pad = _build_matrices(
        fft_size, n_mels, sampling_rate)
    cos_planes = _matrix_slices_i8(cw, km)
    sin_planes = _matrix_slices_i8(sw, km)
    slice_mats = tuple(
        torch.from_numpy(np.concatenate(cos_planes[:n_p] + sin_planes[:n_p],
                                        axis=1))
        for n_p in _hp8_plane_widths(ks, km, cutoff))
    return (slice_mats, torch.as_tensor(mt, dtype=torch.float32), n_bins_pad,
            n_mels_pad, k_pad)


@functools.lru_cache(maxsize=8)
def _bf3_device_matrices(fft_size: int, n_mels: int, sampling_rate: float,
                         ks: int, km: int, cutoff: int):
    """The bf3 scheme's per-slice bf16 plane concats (layout of
    ``_hp8_device_matrices``); the window is folded into the float64
    matrices before slicing."""
    cw, sw, mt, n_bins_pad, n_mels_pad, k_pad = _build_matrices(
        fft_size, n_mels, sampling_rate)
    cos_planes = bf16_round_slices(cw, km)
    sin_planes = bf16_round_slices(sw, km)
    slice_mats = tuple(torch.cat(cos_planes[:n_p] + sin_planes[:n_p], dim=1)
                       for n_p in _hp8_plane_widths(ks, km, cutoff))
    return (slice_mats, torch.as_tensor(mt, dtype=torch.float32), n_bins_pad,
            n_mels_pad, k_pad)


@functools.lru_cache(maxsize=8)
def _hp_device_matrices(fft_size: int, n_mels: int, sampling_rate: float,
                        n_slices: int):
    """The integer-valued bf16 cos and sin planes side by side: ``(cs, ss,
    mt f32, n_bins_pad, n_mels_pad, k_pad)``."""
    cw, sw, mt, n_bins_pad, n_mels_pad, k_pad = _build_matrices(
        fft_size, n_mels, sampling_rate)

    def planes(m):
        return torch.from_numpy(np.concatenate(matrix_slices(m, n_slices),
                                               axis=1)).to(torch.bfloat16)

    return (planes(cw), planes(sw), torch.as_tensor(mt, dtype=torch.float32),
            n_bins_pad, n_mels_pad, k_pad)


@functools.lru_cache(maxsize=8)
def _f32_device_matrices(fft_size: int, n_mels: int, sampling_rate: float):
    cw, sw, mt, n_bins_pad, n_mels_pad, k_pad = _build_matrices(
        fft_size, n_mels, sampling_rate)
    f32 = functools.partial(torch.as_tensor, dtype=torch.float32)
    return f32(cw), f32(sw), f32(mt), n_bins_pad, n_mels_pad, k_pad


def pallas_schedule(impl: str, hp_n_slices: int | None = None,
                    hp_max_pair_sum: int | None = None) -> tuple:
    """``(ks, cutoff)`` of a framed ``impl``: the JAX defaults (bf3 (3, 2),
    hp8 (4, 4), hp_bf16 (5, 5)) unless given, with ``ks`` clamped to
    ``cutoff + 1`` (slices past the pair-sum budget pair with nothing);
    f32 has one slice."""
    if impl == "f32":
        return 1, 0
    ks, cutoff = {"bf3": (3, 2), "hp8": (4, 4), "hp_bf16": (5, 5)}[impl]
    ks = ks if hp_n_slices is None else hp_n_slices
    cutoff = cutoff if hp_max_pair_sum is None else hp_max_pair_sum
    return min(ks, cutoff + 1), cutoff


@functools.lru_cache(maxsize=16)
def framed_matrices(impl: str, fft_size: int, n_mels: int,
                    sampling_rate: float, ks: int, cutoff: int,
                    device: torch.device) -> FramedMatrices:
    """``impl``'s matrices for the slice schedule ``(ks, cutoff)`` (as many
    matrix planes as signal slices, as the JAX package builds them),
    cached on ``device``."""
    sr = float(sampling_rate)
    if impl == "bf3":
        slice_mats, mt, *_ = _bf3_device_matrices(fft_size, n_mels, sr, ks,
                                                  ks, cutoff)
        mats = FramedMatrices("bf3", slice_mats, mt, ks, cutoff)
    elif impl == "hp8":
        slice_mats, mt, *_ = _hp8_device_matrices(fft_size, n_mels, sr, ks,
                                                  ks, cutoff)
        mats = FramedMatrices("hp8", slice_mats, mt, ks, cutoff)
    elif impl == "hp_bf16":
        cs, ss, mt, *_ = _hp_device_matrices(fft_size, n_mels, sr, ks)
        mats = FramedMatrices("hp_bf16", (cs, ss), mt, ks, cutoff)
    elif impl == "f32":
        cw, sw, mt, *_ = _f32_device_matrices(fft_size, n_mels, sr)
        mats = FramedMatrices("f32", (cw, sw), mt)
    else:
        raise ValueError(f"impl must be one of {IMPLS}")
    return mats.to(device)


def framed_input(x: torch.Tensor, fft_size: int, hop_size: int,
                 streaming: bool = False) -> tuple:
    """The framed kernels' input (the framing and padding of JAX's
    ``_framed_pallas_mel``): ``x [B, T]`` framed at ``hop_size`` in batch
    framing, or in streaming framing (offset ``streaming_frame_offset``,
    up to the last whole hop), as ``(frames [B * n_frames, k_pad],
    n_frames)``: the frames padded with zeros to the matrices' 128-row
    multiple of taps (JAX also pads their count to its TPU tile; the
    Hopper kernels mask a ragged last block instead)."""
    n = x.shape[-1]
    if streaming:
        offset = framing.streaming_frame_offset(fft_size, hop_size)
        n_frames = framing.num_frames_streaming(n, fft_size, hop_size)
        x = x[:, offset : (n // hop_size) * hop_size]
    else:
        n_frames = framing.num_frames_batch(n, fft_size, hop_size)
    n_frames = max(n_frames, 0)
    total = x.shape[0] * n_frames
    needed = (n_frames - 1) * hop_size + fft_size
    if x.shape[-1] < needed:
        x = torch.nn.functional.pad(x, (0, needed - x.shape[-1]))
    frames = framing.frame_signal(x, fft_size, hop_size, n_frames).reshape(
        total, fft_size)
    k_pad = -(-fft_size // LANES) * LANES
    frames = torch.nn.functional.pad(frames, (0, k_pad - fft_size))
    return frames, n_frames


def resolve_pallas_impl(fft_size: int, hop_size: int, n_mels: int,
                        sampling_rate: float, *, streaming: bool = False,
                        hp: bool = False, hp_n_slices: int | None = None,
                        hp_max_pair_sum: int | None = None,
                        device=None) -> str:
    """``whisper_mel_pallas``'s ``impl=None``: ``"hp_bf16"`` with ``hp``;
    else ``"sig"`` where the macro-row geometry applies and, on CUDA, K1
    takes the config's head (``kernels/sig_mel.py::k1_accepts``: 256,
    512, 1024 or 2048 DFT columns, a span within a block's shared memory
    in 128-, 64- or 32-frame blocks, or the factored path's tables at
    the wide hops); else
    ``"bf3"``. The
    head is built on the CPU; no kernel runs."""
    if hp:
        return "hp_bf16"
    off = framing.streaming_frame_offset(fft_size, hop_size) if streaming \
        else 0
    if sig_geometry(fft_size, hop_size, off) is None:
        return "bf3"
    if torch.device("cuda" if device is None else device).type != "cuda":
        return "sig"
    ks = 3 if hp_n_slices is None else hp_n_slices
    cutoff = 2 if hp_max_pair_sum is None else hp_max_pair_sum
    head = sig_matrices(fft_size, n_mels, float(sampling_rate), ks, cutoff,
                        torch.device("cpu")).head(fft_size, n_mels)
    return "sig" if k1_accepts(head, hop=hop_size, ks=ks) else "bf3"


def whisper_mel_pallas(
    samples,
    fft_size: int = 400,
    hop_size: int = 160,
    n_mels: int = 80,
    sampling_rate: float = 16000.0,
    streaming: bool = False,
    hp: bool = False,
    hp_n_slices: int | None = None,
    hp_max_pair_sum: int | None = None,
    impl: str | None = None,
    device=None,
    matrices=None,
) -> torch.Tensor:
    """Whisper log-mel via a fused kernel, by the JAX function's name.
    ``samples`` ``[T]`` or ``[B, T]`` -> ``[n_frames, n_mels]`` / ``[B,
    n_frames, n_mels]`` float32 on ``device``; ``streaming=True`` gives
    the streaming-equivalent frames in the same frame-major layout.

    ``impl`` picks the kernel (``None``: ``resolve_pallas_impl``):

    - ``"sig"``: K1, the signal-input kernel (``whisper_mel_sig``);
    - ``"bf3"``: K5, rounded-bf16 3-slice pairs with the window folded
      into the sliced matrices (default (3, 2));
    - ``"hp8"``: K6, int8 Ozaki split, exact integer groups (default (4,
      4));
    - ``"hp_bf16"``: K7, the integer-bf16 Ozaki split (default (5, 5));
      also ``hp=True``;
    - ``"f32"``: K8, plain float32 DFT.

    ``(hp_n_slices, hp_max_pair_sum)`` override the slice schedule ``(ks,
    cutoff)``. ``matrices`` replaces the host-built matrices: a
    ``SigMatrices`` for ``"sig"``, a ``FramedMatrices`` of the same
    ``impl`` otherwise (for example the JAX package's, through
    ``convert.from_jax_framed_matrices``)."""
    dev = resolve_device(device)
    if impl is None:
        impl = resolve_pallas_impl(
            fft_size, hop_size, n_mels, sampling_rate, streaming=streaming,
            hp=hp, hp_n_slices=hp_n_slices, hp_max_pair_sum=hp_max_pair_sum,
            device=dev)
    if impl not in ("sig",) + IMPLS:
        raise ValueError(
            "impl must be 'sig', 'bf3', 'hp8', 'hp_bf16' or 'f32'"
        )
    if impl == "sig":
        return whisper_mel_sig(
            samples, fft_size, hop_size, n_mels, sampling_rate,
            streaming=streaming,
            ks=3 if hp_n_slices is None else hp_n_slices,
            cutoff=2 if hp_max_pair_sum is None else hp_max_pair_sum,
            device=dev, matrices=matrices,
        )
    if matrices is not None and (not isinstance(matrices, FramedMatrices)
                                 or matrices.impl != impl):
        raise ValueError(f"matrices must be FramedMatrices of impl {impl!r}")
    x = as_signal(samples, dev)
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    frames, n_frames = framed_input(x, fft_size, hop_size, streaming)
    batch = x.shape[0]
    if n_frames == 0 or batch == 0:
        out = torch.zeros((batch, n_frames, n_mels), dtype=torch.float32,
                          device=dev)
        return out[0] if squeeze else out
    ks, cutoff = pallas_schedule(impl, hp_n_slices, hp_max_pair_sum)
    mats = (framed_matrices(impl, fft_size, n_mels, float(sampling_rate), ks,
                            cutoff, dev)
            if matrices is None else matrices.to(dev))
    out = framed_mel(frames, mats, n_mels=n_mels, taps=fft_size)
    out = out.reshape(batch, n_frames, n_mels)
    return out[0] if squeeze else out
