"""K1: whisper log-mel from the raw signal — the CUDA kernel
(``csrc/sig_mel.cu``), its plain PyTorch version, and the wrapper that
picks between them by the device the signal lies on.

Replaces ``melspec_tpu/ops/mel_kernel.py::_pallas_sig_mel`` (body
``_sig_mel_tile_kernel``) in its whisper output mode. ``sig_mel`` launches
the kernel for a CUDA tensor (or raises) and runs ``sig_mel_reference``
only for a CPU tensor. ``launches`` counts kernel launches; nothing else
adds to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from melspec_tpu_torch.kernels import build
from melspec_tpu_torch.ops.fastmath import log10_accurate
from melspec_tpu_torch.ops.framing import frame_signal

LOG10_FLOOR = 1e-10
# dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
MAX_BLOCKS = 16
MAX_SLICES = 4
# K1's DFT columns: re in [0, 256), im in [256, 512) (fft 258..512)
WIDTH = 512

launches = 0


def sig_mel_reference(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
                      mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
                      offset: int, pack: int, n_bins_pad: int, n_mels: int,
                      mel_precision: str = "bf2",
                      dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The JAX kernel's math written out in plain PyTorch, on whatever
    device ``samples`` lies on: ``samples [B, T]`` f32 -> ``[B, n_frames,
    n_mels]`` f32.

    ``m_big`` is the bf16 K-stack ``[K_tot, 2*n_bins_pad]`` whose block
    ``blk`` pairs with signal slice ``pair_i[blk]``, re in columns
    ``[0, n_bins_pad)`` and im in ``[n_bins_pad, 2*n_bins_pad)``; ``mt`` is
    the bf2 stack ``[F0; F1; F0]`` (bf16) for ``mel_precision="bf2"`` or
    the f32 projection for ``"highest"``. The DFT dot is one ``torch.matmul``
    in ``dot_dtype``: float32 as in the JAX kernel, or float64, which sums
    the exact bf16 x bf16 products with no rounding that reaches float32 —
    the exact value the float32 versions are held against."""
    b = samples.shape[0]
    if n_frames <= 0:
        return samples.new_zeros((b, 0, n_mels))
    frames = frame_signal(samples.to(torch.float32), pack, hop, n_frames,
                          offset)  # [B, nf, pack]
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
    re = y[..., :n_bins_pad]
    im = y[..., n_bins_pad : 2 * n_bins_pad]
    power = re * re + im * im
    if mel_precision == "bf2":
        p0 = power.to(torch.bfloat16)
        p1 = (power - p0.to(torch.float32)).to(torch.bfloat16)
        pcat = torch.cat([p0, p0, p1], dim=-1).to(torch.float32)
        energy = pcat @ mt.to(torch.float32)
    elif mel_precision == "highest":
        energy = power @ mt.to(torch.float32)
    else:
        raise ValueError("mel_precision must be 'bf2' or 'highest'")
    # the row max runs over every padded mel column, as in the JAX kernel
    # (a pad column's energy is 0 and its log sits at the floor)
    log_mel = log10_accurate(torch.clamp_min(energy, LOG10_FLOOR))
    raw = log_mel.amax(dim=-1, keepdim=True)
    vals = (torch.maximum(log_mel, raw - 8.0) + 4.0) * 0.25
    return vals[..., :n_mels].contiguous()


@functools.cache
def _bound() -> ctypes.CDLL:
    lib = build.load("sig_mel").lib
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.melspec_sig_mel.argtypes = [
        p, ll, ll, i, i, i,   # x, batch, T, n_frames, hop, offset
        p, i, i, p, i, i,     # m_big, W, pack, blocks, n_blocks, ks
        p, i, i, i,           # mt, n_mels, n_mels_pad, bf2
        p, p,                 # out, stream
    ]
    lib.melspec_sig_mel.restype = ctypes.c_int
    lib.melspec_sig_mel_smem_bytes.argtypes = [i, i, i, i]
    lib.melspec_sig_mel_smem_bytes.restype = ctypes.c_longlong
    lib.melspec_cuda_error_string.argtypes = [ctypes.c_int]
    lib.melspec_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _smem_bytes(ks: int, hop: int, pack: int, n_mels_pad: int) -> int:
    """Dynamic shared memory one K1 block needs (asks the built kernel)."""
    return int(_bound().melspec_sig_mel_smem_bytes(ks, hop, pack,
                                                   n_mels_pad))


def block_order(pair_i) -> list:
    """K1's summation order of the K blocks: ``(block, slice)`` with the
    smallest slice pair ``i + j`` first, so the small terms accumulate
    while the sum is still small and only block (0, 0) rounds at full
    magnitude. ``pair_i`` is i-major, so ``j`` is a block's place in its
    run of equal ``i``."""
    ij = [(blk, i, blk - pair_i.index(i)) for blk, i in enumerate(pair_i)]
    return [(blk, i) for blk, i, j in sorted(ij, key=lambda t: -(t[1] + t[2]))]


@functools.lru_cache(maxsize=16)
def _block_table(pair_i: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(block_order(pair_i), dtype=torch.int32,
                        device=device)


def _launch(samples, m_big, pair_i, mt, *, ks, n_frames, hop, offset, pack,
            n_bins_pad, n_mels, mel_precision) -> torch.Tensor:
    global launches
    dev = samples.device
    if samples.dtype != torch.float32 or samples.dim() != 2:
        raise ValueError("K1 takes a [B, T] float32 signal")
    if m_big.dtype != torch.bfloat16 or m_big.device != dev:
        raise ValueError("m_big must be a bf16 tensor on the signal's device")
    width = m_big.shape[1]
    n_pow = WIDTH // 2
    if (width, n_bins_pad) != (WIDTH, n_pow):
        raise NotImplementedError(
            f"K1 takes {WIDTH} DFT columns split into re|im halves (fft "
            f"258..512); got width {width}, split {n_bins_pad}")
    bf2 = mel_precision == "bf2"
    if mel_precision not in ("bf2", "highest"):
        raise ValueError("mel_precision must be 'bf2' or 'highest'")
    want = (torch.bfloat16, 3 * n_pow) if bf2 else (torch.float32, n_pow)
    if (mt.dtype, mt.shape[0]) != want or mt.device != dev:
        raise ValueError(f"mt must be {want[0]} with {want[1]} rows on the "
                         f"signal's device; got {mt.dtype} {tuple(mt.shape)}")
    n_mels_pad = mt.shape[1]
    if n_mels_pad % 128 or n_mels > n_mels_pad:
        raise ValueError("mt's columns must be n_mels padded to 128")
    pair_i = tuple(int(i) for i in pair_i)
    if not (0 < len(pair_i) <= MAX_BLOCKS and 0 < ks <= MAX_SLICES
            and max(pair_i) < ks and min(pair_i) >= 0
            and len(pair_i) * pack <= m_big.shape[0]):
        raise ValueError(f"K1 takes <= {MAX_BLOCKS} K blocks of "
                         f"<= {MAX_SLICES} signal slices; got pair_i "
                         f"{pair_i}, ks {ks}")
    smem = _smem_bytes(ks, hop, pack, n_mels_pad)
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"K1 needs {smem} bytes of shared memory for hop {hop}, "
            f"{pack} taps; a block has {MAX_SMEM_BYTES}")
    b, t = samples.shape
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=dev)
    if b == 0 or n_frames <= 0:
        return out
    samples = samples.contiguous()
    m_big = m_big.contiguous()
    mt = mt.contiguous()
    blocks = _block_table(pair_i, dev)
    lib = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.melspec_sig_mel(
            samples.data_ptr(), b, t, n_frames, hop, offset,
            m_big.data_ptr(), width, pack, blocks.data_ptr(), len(pair_i), ks,
            mt.data_ptr(), n_mels, n_mels_pad, int(bf2),
            out.data_ptr(), stream)
    if rc != 0:
        msg = lib.melspec_cuda_error_string(rc).decode()
        raise RuntimeError(f"K1 (sig_mel) launch failed: {msg} ({rc})")
    launches += 1
    return out


def sig_mel(samples: torch.Tensor, m_big: torch.Tensor, pair_i,
            mt: torch.Tensor, *, ks: int, n_frames: int, hop: int,
            offset: int, pack: int, n_bins_pad: int, n_mels: int,
            mel_precision: str = "bf2") -> torch.Tensor:
    """K1 on a CUDA signal, its plain version on a CPU one (same
    arguments as ``sig_mel_reference``). On the CPU the DFT dot is summed
    exactly (float64): the f32 sum of a CPU BLAS changes with its thread
    count, and on near-silent mel bins that order alone can cost more
    than the accuracy gates allow."""
    kw = dict(ks=ks, n_frames=n_frames, hop=hop, offset=offset, pack=pack,
              n_bins_pad=n_bins_pad, n_mels=n_mels,
              mel_precision=mel_precision)
    if samples.device.type == "cuda":
        return _launch(samples, m_big, pair_i, mt, **kw)
    if samples.device.type == "cpu":
        return sig_mel_reference(samples, m_big, pair_i, mt,
                                 dot_dtype=torch.float64, **kw)
    raise ValueError(f"unsupported device {samples.device}")
