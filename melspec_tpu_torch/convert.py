"""Carrying state across from the JAX package.

The whisper frontend has no learned weights; its parameters are the
host-built device matrices. ``from_jax_sig_matrices`` takes them as
``melspec_tpu.ops.mel_kernel._sig_device_matrices(...)`` returns them,
converted to numpy (bf16 arrays as ml_dtypes ``bfloat16``, as their
``uint16`` bit patterns, or as float32 holding bf16 values), and returns
the port's ``SigMatrices`` for ``whisper_mel_sig(matrices=...)``.

A live serving fleet's state crosses over too: ``from_jax_frontend_state``
and ``from_jax_source_rate_state`` take a JAX ``FrontendState`` or
``SourceRateState`` whose leaves are numpy arrays (``jax.device_get`` of
the state) and return the port's state on a device, carried windows, VAD
history and resampler tails included.
"""

from __future__ import annotations

import numpy as np
import torch

from melspec_tpu_torch._device import resolve_device
from melspec_tpu_torch.ops.mel_kernel import SigMatrices
from melspec_tpu_torch.streaming.multistream import MultiStreamState
from melspec_tpu_torch.streaming.resample import MultiResampleState
from melspec_tpu_torch.streaming.serving import (FrontendState,
                                                 SourceRateState,
                                                 VadStreamState)


def _bf16(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.itemsize == 2:  # ml_dtypes bfloat16 or its uint16 bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    f32 = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    out = f32.to(torch.bfloat16)
    if not torch.equal(out.to(torch.float32), f32):
        raise ValueError("float32 matrix holds values that are not bf16")
    return out


def from_jax_sig_matrices(m_big, pair_i, mt, mt_bf2) -> SigMatrices:
    """JAX ``(m_big [K_tot, W] bf16, pair_i, mt [W/2, n_mels_pad] f32,
    mt_bf2 [3*W/2, n_mels_pad] bf16)`` in the split column layout -> the
    port's ``SigMatrices`` (CPU tensors, bit for bit). The re|im split
    point is ``W / 2``; N-packed sets (``mt [W, n_mels_pad]``) are not
    taken."""
    big = _bf16(m_big)
    mt_t = torch.tensor(np.asarray(mt, dtype=np.float32))
    bf2 = _bf16(mt_bf2)
    width, n_pow = big.shape[1], mt_t.shape[0]
    if 2 * n_pow != width or bf2.shape[0] != 3 * n_pow:
        raise ValueError(f"inconsistent shapes for split columns: m_big "
                         f"{tuple(big.shape)}, mt {tuple(mt_t.shape)}, "
                         f"mt_bf2 {tuple(bf2.shape)}")
    return SigMatrices(big, tuple(int(i) for i in pair_i), mt_t, bf2, n_pow)


def _leaf(arr, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=dtype, device=dev)


def from_jax_frontend_state(state, device=None) -> FrontendState:
    """JAX ``FrontendState(mel=MultiStreamState(hop_buf, idx),
    vad=VadStreamState(hist, count))`` with numpy leaves -> the port's
    ``FrontendState`` on ``device`` (``None``: CUDA). ``hop_buf`` keeps
    its float dtype; the counters are int32."""
    dev = resolve_device(device)
    hop_buf = np.asarray(state.mel.hop_buf)
    dtype = torch.float64 if hop_buf.dtype == np.float64 else torch.float32
    return FrontendState(
        MultiStreamState(_leaf(hop_buf, dtype, dev),
                         _leaf(state.mel.idx, torch.int32, dev)),
        VadStreamState(_leaf(state.vad.hist, torch.float32, dev),
                       _leaf(state.vad.count, torch.int32, dev)))


def from_jax_source_rate_state(state, device=None) -> SourceRateState:
    """JAX ``SourceRateState(rs=MultiResampleState(buf), fe=...)`` with
    numpy leaves -> the port's ``SourceRateState`` on ``device``."""
    dev = resolve_device(device)
    return SourceRateState(
        MultiResampleState(_leaf(state.rs.buf, torch.float32, dev)),
        from_jax_frontend_state(state.fe, dev))
