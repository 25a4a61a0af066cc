"""Polyphase sample-rate conversion, host side (port of the host part of
``melspec_tpu.ops.resample``).

Semantics of ``scipy.signal.resample_poly``: kaiser-5.0-windowed sinc,
zero phase, ``ceil(n*up/down)`` outputs, the first output aligned with the
first input, zero signal extension at the edges. The polyphase identity

    y[q*up + p] = sum_j x[q*down + r_lo + j] * G[j, p]

makes every block of ``up`` outputs one fixed ``[K, up]`` matrix (the
phase matrix ``G``) applied to a ``down``-strided window of the input.
``resample_poly`` runs it as one strided ``conv1d`` with ``up`` output
channels; the serving tick's kernels K3/K4 (``kernels/resample.py``) run
the same windows against the same ``G``. The JAX package's lane blocking
(``_lane_blocks``, several windows folded into extra output channels to
fill a TPU's 128-lane matrix unit) has no counterpart here.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from melspec_tpu_torch._device import full_f32, resolve_device

__all__ = [
    "MAX_MATRIX_ENTRIES",
    "StreamingResampler",
    "resample_filter",
    "resample_output_len",
    "resample_poly",
    "validate_ratio",
]

# The phase matrix holds K*up ~= up*down + 2*half_len f64 entries
# (half_len = 10*max(up, down)). Every standard audio-rate pair reduces to
# <= 615,680 entries (11.025k <-> 32k); 2**20 (an 8 MB matrix) leaves
# headroom without admitting hostile ratios (44101/16000 is coprime).
MAX_MATRIX_ENTRIES = 1 << 20


def validate_ratio(up: int, down: int,
                   max_entries: int = MAX_MATRIX_ENTRIES
                   ) -> tuple[int, int]:
    """Gcd-reduce ``up/down`` and reject ratios unsafe to construct.

    Serving boundaries that accept a client-controlled rate call this
    before constructing a resampler: ``_phase_matrix`` allocates the
    matrix in f64 host memory and caches it. Returns the reduced
    ``(up, down)``; raises ``ValueError`` otherwise."""
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    g = math.gcd(up, down)
    up, down = up // g, down // g
    entries = up * down + 20 * max(up, down)
    if entries > max_entries:
        raise ValueError(
            f"resample ratio reduces to {up}/{down}: the polyphase matrix"
            f" would be ~{entries * 8 / 1e6:.0f} MB of host memory"
            f" (bound {max_entries * 8 / 1e6:.0f} MB); use a standard"
            f" rate pair")
    return up, down


def _kaiser_sinc_filter(half_len: int, cutoff: float,
                        beta: float) -> np.ndarray:
    """Odd-length linear-phase lowpass, kaiser-windowed sinc with DC gain
    1: ``scipy.signal.firwin(2*half_len+1, cutoff, window=("kaiser",
    beta))`` (cutoff in Nyquist units), numpy only."""
    n = np.arange(2 * half_len + 1, dtype=np.float64) - half_len
    taps = cutoff * np.sinc(cutoff * n) * np.kaiser(2 * half_len + 1, beta)
    return taps / taps.sum()


def resample_filter(up: int, down: int, beta: float = 5.0) -> np.ndarray:
    """The f64 anti-alias filter ``resample_poly`` uses after gcd
    reduction: cutoff ``1/max(up,down)`` of Nyquist, ``half_len =
    10*max(up,down)``, kaiser(beta), scaled by ``up``."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    max_rate = max(up, down)
    return _kaiser_sinc_filter(10 * max_rate, 1.0 / max_rate, beta) * up


def phase_matrix_rows(up: int, down: int, m: int = 1) -> tuple[int, int]:
    """``(K, r_lo)`` of the phase matrix of gcd-reduced ``up/down`` with
    ``m`` windows folded into its columns (JAX's blocked variant, whose
    row count ``(m-1)*down + K`` fixes the serving state length)."""
    half_len = 10 * max(up, down)
    r_lo = -(half_len // up)                   # p = 0
    r_hi = ((up - 1) * down + half_len) // up  # p = up-1
    return (m - 1) * down + r_hi - r_lo + 1, r_lo


@lru_cache(maxsize=64)  # bounded: a boundary cycling through many rates
def _phase_matrix(up: int, down: int, beta: float) -> tuple[np.ndarray, int]:
    """Host-built ``(G [K, up] float64, r_lo)`` for gcd-reduced
    ``up/down``: ``G[j, p] = h[half_len + p*down - (j + r_lo)*up]`` (0
    outside the filter support); column ``p`` is phase ``p``'s FIR over
    the input window ``x[q*down + r_lo : q*down + r_lo + K]``. Bit for bit
    the JAX package's ``_phase_matrix(up, down, beta, m=1)``."""
    h = resample_filter(up, down, beta)
    half_len = (len(h) - 1) // 2
    k, r_lo = phase_matrix_rows(up, down)
    g = np.zeros((k, up), dtype=np.float64)
    r = np.arange(r_lo, r_lo + k)
    for p in range(up):
        idx = half_len + p * down - r * up
        valid = (idx >= 0) & (idx < len(h))
        g[valid, p] = h[idx[valid]]
    return g, r_lo


@lru_cache(maxsize=64)
def _phase_matrix_cast(up: int, down: int, beta: float,
                       dtype_str: str) -> tuple[np.ndarray, int]:
    """``_phase_matrix`` cast to the working dtype, cached and read-only:
    a serving boundary builds one ``StreamingResampler`` per client."""
    g, r_lo = _phase_matrix(up, down, beta)
    g = g.astype(dtype_str)
    g.setflags(write=False)
    return g, r_lo


def kernel_block_m(up: int, down: int) -> int:
    """The lane-block count of the JAX package's resample kernel: the
    smallest ``m`` with ``m*down`` a multiple of 128 and ``m*up >= 128``.
    Kept only for the serving state-length rule
    (``streaming.resample.MultiStreamResampler``)."""
    m = 128 // math.gcd(down, 128)
    while m * up < 128:
        m *= 2
    return m


def resample_kernel_geometry(up: int, down: int, q: int):
    """The JAX resample kernel's ``(m, stride, kb, nblk, ch)`` for ``q``
    windows, or ``None`` where the JAX package keeps the conv route (a
    ragged ``q``, or a block matrix too large for the TPU's VMEM, as at
    44.1 kHz). Kept only for the serving state-length rule: the JAX
    streaming resampler carries ``(nblk-1)*stride`` more samples of tail
    on its kernel routes, which moves its frame grid, and the port keeps
    that grid."""
    m = kernel_block_m(up, down)
    if q % m:
        return None
    kb, _ = phase_matrix_rows(up, down, m)
    stride = m * down
    nblk = -(-kb // stride)
    ch = m * up
    if stride * nblk * ch * 4 > (2 << 20):
        return None
    return m, stride, kb, nblk, ch


def resample_output_len(n_in: int, up: int, down: int) -> int:
    """``ceil(n_in * up / down)`` after gcd reduction (scipy's rule)."""
    g = math.gcd(up, down)
    up, down = up // g, down // g
    return -(-(n_in * up) // down)


def resample_poly(x, up: int, down: int, beta: float = 5.0,
                  device=None) -> torch.Tensor:
    """Resample ``x [..., N]`` by the rational factor ``up/down`` on
    ``device`` (``None``: CUDA).

    Matches ``scipy.signal.resample_poly(x, up, down, axis=-1)`` (its
    default kaiser-5.0 design, ``padtype="constant"``): output length
    ``ceil(N*up/down)``, zero phase, edges treated as zero. Floating input
    keeps its dtype; integer input is resampled in float32. One strided
    ``conv1d`` with ``up`` output channels, in full float32 or float64
    (no TF32)."""
    if up < 1 or down < 1:
        raise ValueError("up and down must be >= 1")
    gcd = math.gcd(up, down)
    up, down = up // gcd, down // gcd
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if up == down:
        return x
    n_in = x.shape[-1]
    n_out = -(-(n_in * up) // down)
    if n_in == 0:
        return x.new_zeros(x.shape[:-1] + (0,))
    g_np, r_lo = _phase_matrix(up, down, beta)
    k = g_np.shape[0]
    q = -(-n_out // up)  # windows: each yields `up` outputs
    # window q covers padded indices [q*down, q*down + K); the padded
    # signal is (-r_lo) zeros | x | right zeros
    pad_left = -r_lo
    needed = (q - 1) * down + k
    pad_right = max(0, needed - pad_left - n_in)
    lead = x.shape[:-1]
    xp = torch.nn.functional.pad(x.reshape(-1, 1, n_in),
                                 (pad_left, pad_right))[..., :needed]
    w = torch.as_tensor(g_np.T[:, None, :], dtype=x.dtype, device=dev)
    with full_f32():
        y = torch.nn.functional.conv1d(xp, w, stride=down)  # [B, up, q]
    y = y.transpose(-1, -2).reshape(lead + (q * up,))
    return y[..., :n_out]


class StreamingResampler:
    """Chunked resampler for serving ingest, host numpy: push chunks of
    any length at the source rate and receive the samples the offline
    :func:`resample_poly` would produce (prefix parity up to float
    associativity), with :meth:`flush` emitting the zero-extended tail
    and resetting for the next stream. State is ``O(K)``: the input tail
    from the next window's start, plus the emitted / consumed counts."""

    def __init__(self, up: int, down: int, beta: float = 5.0,
                 dtype=np.float32):
        if up < 1 or down < 1:
            raise ValueError("up and down must be >= 1")
        gcd = math.gcd(up, down)
        self.up, self.down = up // gcd, down // gcd
        self._dtype = np.dtype(dtype)
        if self.identity:
            self._n_in = 0
            return
        self._g, r_lo = _phase_matrix_cast(self.up, self.down, beta,
                                           self._dtype.name)
        self._k = self._g.shape[0]
        self._pad_left = -r_lo
        # the buffer starts at padded index q_next*down; seed the left pad
        self._buf = np.zeros(self._pad_left, dtype=dtype)
        self._n_in = 0
        self._n_emitted = 0

    @property
    def identity(self) -> bool:
        return self.up == self.down

    def push(self, chunk: np.ndarray) -> np.ndarray:
        """Consume ``chunk [n]``; return every output sample now fully
        determined by the input seen so far."""
        chunk = np.asarray(chunk, dtype=self._dtype)
        if chunk.ndim != 1:
            raise ValueError("chunk must be 1-D")
        self._n_in += len(chunk)
        if self.identity:
            return chunk
        self._buf = np.concatenate([self._buf, chunk])
        return self._drain()

    def flush(self) -> np.ndarray:
        """Emit the remaining outputs of the stream seen so far (zero
        signal extension, like the offline right edge), then reset."""
        if self.identity:
            self._n_in = 0
            return np.zeros(0, dtype=self._dtype)
        n_out = resample_output_len(self._n_in, self.up, self.down)
        limit = n_out - self._n_emitted
        q_rem = -(-limit // self.up)
        needed = (q_rem - 1) * self.down + self._k if q_rem > 0 else 0
        if needed > len(self._buf):
            pad = np.zeros(needed - len(self._buf), dtype=self._dtype)
            self._buf = np.concatenate([self._buf, pad])
        out = self._drain(limit=limit)
        self._buf = np.zeros(self._pad_left, dtype=self._dtype)
        self._n_in = 0
        self._n_emitted = 0
        return out

    def _drain(self, limit: int | None = None) -> np.ndarray:
        avail = len(self._buf)
        q = (avail - self._k) // self.down + 1 if avail >= self._k else 0
        if limit is not None:
            q = min(q, -(-limit // self.up))
        if q <= 0:
            return np.zeros(0, dtype=self._dtype)
        # the same windows and per-row dots as the offline conv
        stride = self._buf.strides[0]
        frames = np.lib.stride_tricks.as_strided(
            self._buf, (q, self._k), (self.down * stride, stride))
        y = frames @ self._g
        self._buf = self._buf[q * self.down:].copy()
        out = y.reshape(-1)
        if limit is not None:
            out = out[:limit]
        self._n_emitted += len(out)
        return out
