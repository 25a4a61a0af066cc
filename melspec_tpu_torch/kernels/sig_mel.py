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
kernel launches and ``epilogue_launches`` those that ran an epilogue;
nothing else adds to them.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.ops.fastmath import ln_accurate, log10_accurate
from melspec_tpu_torch.ops.quant import quantize_frames
from melspec_tpu_torch.ops.vad import sobel_gradient_sq

LOG10_FLOOR = 1e-10
# the smallest normal float32: ln_accurate's bit decomposition takes
# normal inputs only, so the ln modes clamp their guard to it
MIN_NORMAL = 1.1754944e-38
OUT_MODES = ("whisper", "ln_guard", "ln_floor")
# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
MAX_BLOCKS = 16
MAX_SLICES = 4
# the kernels' DFT columns: re | im halves of 256 (split) or 512 single
# components (N-packed)
WIDTH = 512
# frames of one clip per block; the kernels check that the caller's
# value is theirs (csrc/sig_common.cuh: kTileFrames)
TILE_FRAMES = 64

launches = 0
epilogue_launches = {"quant": 0, "vad": 0}


@dataclasses.dataclass(frozen=True)
class SigHead:
    """One frontend's device matrices and output, as K1 and each head of
    K2 take them: ``m_big`` bf16 ``[K_tot, 512]`` whose block ``blk``
    pairs with signal slice ``pair_i[blk]``; ``mt`` the bf2 stack ``[F0;
    F1; F0]`` (bf16, ``mel_precision`` "bf2") or the f32 projection
    (``"highest"``); ``n_bins_pad`` the re|im split point (0: N-packed
    columns); the frame's contracted taps ``[pack_off, pack_off +
    pack)``; ``n_mels`` output columns in ``out_mode`` with ``guard``."""

    m_big: torch.Tensor
    pair_i: tuple
    mt: torch.Tensor
    n_bins_pad: int
    pack: int
    n_mels: int
    pack_off: int = 0
    out_mode: str = "whisper"
    guard: float = 0.0

    @property
    def mel_precision(self) -> str:
        return "bf2" if self.mt.dtype == torch.bfloat16 else "highest"

    def kw(self) -> dict:
        """The keyword arguments of ``sig_mel`` / ``sig_mel_reference``
        besides the matrices and the frame grid."""
        return dict(pack=self.pack, pack_off=self.pack_off,
                    n_bins_pad=self.n_bins_pad, n_mels=self.n_mels,
                    mel_precision=self.mel_precision,
                    out_mode=self.out_mode, guard=self.guard)

    def to(self, device) -> "SigHead":
        return dataclasses.replace(self, m_big=self.m_big.to(device),
                                   mt=self.mt.to(device))


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
    versions are held against."""
    b = samples.shape[0]
    if n_frames <= 0:
        return samples.new_zeros((b, 0, n_mels))
    x = samples.to(torch.float32)
    start = offset + pack_off
    need = start + (n_frames - 1) * hop + pack
    if x.shape[-1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[-1]))
    frames = x[:, start:need].unfold(-1, pack, hop)  # [B, nf, pack]
    # the bf16 residual cascade: slice i rounds what slices < i left
    residual = frames
    slices = []
    for i in range(ks):
        xs = residual.to(torch.bfloat16)
        if i + 1 < ks:
            residual = residual - xs.to(torch.float32)
        slices.append(xs)
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


def tile_vad_counts(mel: torch.Tensor, thr: float,
                    start_y: int) -> torch.Tensor:
    """The VAD epilogue's output from the whisper values ``mel [B, F,
    n_mels]``: per frame ``x`` the number of mel rows ``y`` in
    ``[start_y, n_mels - 2)`` whose squared Sobel gradient over frames
    ``x .. x+2`` is ``>= thr``, int32 ``[B, F]``. Like the kernels (K1
    and K2), which see one tile of ``TILE_FRAMES`` frames at a time, it
    gives 0 for the last two frames of every tile and of the clip."""
    b, f, _ = mel.shape
    counts = torch.zeros((b, f), dtype=torch.int32, device=mel.device)
    if f > 2:
        g2 = sobel_gradient_sq(mel.transpose(-1, -2))[..., start_y:, :]
        counts[:, : f - 2] = (g2 >= thr).sum(dim=-2, dtype=torch.int32)
    edge = torch.arange(f, device=mel.device) % TILE_FRAMES >= TILE_FRAMES - 2
    counts[:, edge] = 0
    return counts


def sig_mel_vad_reference(samples: torch.Tensor, m_big: torch.Tensor,
                          pair_i, mt: torch.Tensor, *, vad: tuple,
                          **kw) -> tuple:
    """The VAD epilogue's plain version: the whisper mel of
    ``sig_mel_reference`` (same arguments) and ``tile_vad_counts`` of it
    at ``vad = (thr, start_y)``: ``(mel [B, F, n_mels], counts [B, F]
    int32)``, the classification ``classify_columns`` thresholds, with
    the kernel's tile-boundary zeros."""
    mel = sig_mel_reference(samples, m_big, pair_i, mt, **kw)
    return mel, tile_vad_counts(mel, *vad)


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("sig_mel").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_sig_mel.argtypes = [
        p, ll, ll, i, i, i, i,  # x, batch, T, n_frames, hop, offset, tile
        p, i, i, i,             # m_big, W, pack, pack_off
        p, i, i, i,             # blocks, n_blocks, ks, npow
        p, i, i, i,             # mt, n_mels, n_mels_pad, bf2
        i, ctypes.c_float,      # out_mode, guard
        p, p, p, p,             # out, q, lo, hi
        p, ctypes.c_float, i,   # vad, vad_thr, vad_start_y
        p,                      # stream
    ]
    lib.melspec_sig_mel.restype = ctypes.c_int
    lib.melspec_sig_mel_smem_bytes.argtypes = [i, i, i, i, i, i]
    lib.melspec_sig_mel_smem_bytes.restype = ctypes.c_longlong
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _smem_bytes(ks: int, hop: int, pack: int, pack_off: int, npow: int,
                n_mels_pad: int) -> int:
    """Dynamic shared memory one K1 block needs (asks the built kernel)."""
    return int(_bound().melspec_sig_mel_smem_bytes(ks, hop, pack, pack_off,
                                                   npow, n_mels_pad))


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


def _width_refusal(width: int, n_bins_pad: int, what: str) -> str | None:
    """Why K1 and K2 refuse a head of ``width`` DFT columns split at
    ``n_bins_pad`` (0: N-packed), or None."""
    if width != WIDTH or n_bins_pad not in (0, WIDTH // 2):
        return (f"{what} takes {WIDTH} DFT columns, split into re|im halves "
                f"or N-packed; got width {width}, split {n_bins_pad}")
    return None


def _smem_refusal(ks: int, hop: int, pack: int, pack_off: int, npow: int,
                  n_mels_pad: int) -> str | None:
    """Why K1 refuses a head for its shared memory (asks the built
    kernel), or None."""
    smem = _smem_bytes(ks, hop, pack, pack_off, npow, n_mels_pad)
    if smem > MAX_SMEM_BYTES:
        return (f"K1 needs {smem} bytes of shared memory for hop {hop}, "
                f"{pack} taps at {pack_off}, {npow} power columns; a block "
                f"has {MAX_SMEM_BYTES}")
    return None


def k1_accepts(head: SigHead, *, hop: int, ks: int = 3) -> bool:
    """Whether K1 takes ``head`` at ``hop`` with ``ks`` signal slices: the
    width and split check of ``check_head`` and the shared-memory check of
    the launch, the same functions the launch applies. The auto routes
    pick K1 only where this holds."""
    width, split = head.m_big.shape[1], head.n_bins_pad
    if _width_refusal(width, split, "K1") is not None:
        return False
    npow = WIDTH if split == 0 else split
    return _smem_refusal(ks, hop, head.pack, head.pack_off, npow,
                         head.mt.shape[1]) is None


def check_head(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
               mt: torch.Tensor, *, ks: int, pack: int, pack_off: int,
               n_bins_pad: int, n_mels: int, mel_precision: str,
               out_mode: str, what: str) -> tuple:
    """Validate one head's arguments for K1 or K2; returns ``(pair_i as
    ints, npow, n_mels_pad, bf2)``."""
    dev = samples.device
    if samples.dtype != torch.float32 or samples.dim() != 2:
        raise ValueError(f"{what} takes a [B, T] float32 signal")
    if m_big.dtype != torch.bfloat16 or m_big.device != dev:
        raise ValueError("m_big must be a bf16 tensor on the signal's device")
    refusal = _width_refusal(m_big.shape[1], n_bins_pad, what)
    if refusal is not None:
        raise NotImplementedError(refusal)
    npow = WIDTH if n_bins_pad == 0 else n_bins_pad
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
            epilogue: str | None = None, vad: tuple = (0.0, 0)) -> tuple:
    """One K1 launch. ``epilogue``: None (the float mel), ``"quant"`` (the
    u8 records ``q, lo, hi`` and no float mel) or ``"vad"`` (the mel and
    the Sobel counts at ``vad = (thr, start_y)``). Returns the outputs as
    a tuple."""
    global launches
    dev = samples.device
    pair_i, npow, n_mels_pad, bf2 = check_head(
        samples, m_big, pair_i, mt, ks=ks, pack=pack, pack_off=pack_off,
        n_bins_pad=n_bins_pad, n_mels=n_mels, mel_precision=mel_precision,
        out_mode=out_mode, what="K1")
    if epilogue is not None and out_mode != "whisper":
        raise ValueError("K1's epilogues run on the whisper mode")
    if epilogue == "vad" and n_mels < 3:
        raise ValueError("the Sobel VAD needs n_mels >= 3")
    refusal = _smem_refusal(ks, hop, pack, pack_off, npow, n_mels_pad)
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
    m_big = m_big.contiguous()
    mt = mt.contiguous()
    blocks = block_table(pair_i, dev)
    lib = _bound()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.melspec_sig_mel(
            samples.data_ptr(), b, t, n_frames, hop, offset, TILE_FRAMES,
            m_big.data_ptr(), WIDTH, pack, pack_off, blocks.data_ptr(),
            len(pair_i), ks, npow, mt.data_ptr(), n_mels, n_mels_pad,
            int(bf2), OUT_MODES.index(out_mode), clamped_guard(guard),
            ptr(out), ptr(q), ptr(lo), ptr(hi), ptr(counts), vad[0],
            int(vad[1]), stream)
    raise_for(lib, rc, "K1 (sig_mel)")
    launches += 1
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
            out_mode: str = "whisper", guard: float = 0.0) -> torch.Tensor:
    """K1 on a CUDA signal, its plain version on a CPU one (same
    arguments as ``sig_mel_reference``). On the CPU the DFT dot is summed
    exactly (float64): the f32 sum of a CPU BLAS changes with its thread
    count, and on near-silent mel bins that order alone can cost more
    than the accuracy gates allow."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision, pack_off=pack_off,
              out_mode=out_mode, guard=guard)
    return _on_device(
        samples, lambda: _launch(samples, m_big, pair_i, mt, **kw)[0],
        lambda: sig_mel_reference(samples, m_big, pair_i, mt,
                                  dot_dtype=torch.float64, **kw))


def sig_mel_quantized(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
                      mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
                      offset: int, pack: int, n_bins_pad: int, n_mels: int,
                      mel_precision: str = "bf2") -> tuple:
    """K1 in whisper mode with the quant epilogue on a CUDA signal, its
    plain version on a CPU one (float64 DFT dot, as ``sig_mel``): ``(q
    [B, n_frames, n_mels] u8, lo [B, n_frames], hi [B, n_frames])``, each
    frame's record of ``quantize_frames``; the kernel writes no float
    mel."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision)
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
                vad: tuple, mel_precision: str = "bf2") -> tuple:
    """K1 in whisper mode with the Sobel VAD epilogue on a CUDA signal,
    its plain version on a CPU one (float64 DFT dot): ``(mel [B,
    n_frames, n_mels], counts [B, n_frames] int32)`` at ``vad = (thr,
    start_y)``; the counts of each tile's last two frames are 0 (see
    ``tile_vad_counts``)."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision)
    return _on_device(
        samples,
        lambda: _launch(samples, m_big, pair_i, mt, pack_off=0,
                        out_mode="whisper", guard=0.0, epilogue="vad",
                        vad=vad, **kw),
        lambda: sig_mel_vad_reference(samples, m_big, pair_i, mt, vad=vad,
                                      dot_dtype=torch.float64, **kw))
