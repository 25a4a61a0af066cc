"""Carrying state across from the JAX package.

The frontends have no learned weights; their parameters are the
host-built kernel matrices. ``from_jax_sig_matrices`` takes the whisper
set as ``melspec_tpu.ops.mel_kernel._sig_device_matrices(...)`` returns
it, converted to numpy (bf16 arrays as ml_dtypes ``bfloat16``, as their
``uint16`` bit patterns, or as float32 holding bf16 values), and returns
the port's ``SigMatrices`` for ``whisper_mel_sig(matrices=...)``.
``from_jax_head`` takes one frontend's set (``m_big``, ``pair_i``, the
projection, the split point and the contracted taps, e.g. JAX's
``Fbank._sig_m_big`` / ``_sig_pair_i`` / ``_sig_mt``) and returns a
``SigHead`` for the ``matrices=`` argument of ``Fbank``, ``BatchLogMel``
and the fused frontends. ``from_jax_framed_matrices`` takes the tuple of
one of the precision dial's builders (``_bf3_device_matrices``,
``_hp8_device_matrices``, ``_hp_device_matrices``,
``_f32_device_matrices``) and returns ``FramedMatrices`` for
``whisper_mel_pallas(impl=..., matrices=...)``.

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
from melspec_tpu_torch.ops.mel_kernel import (FramedMatrices, SigHead,
                                              SigMatrices, live_columns,
                                              pallas_schedule)
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
    """JAX ``(m_big [K_tot, W] bf16, pair_i, mt f32, mt_bf2 bf16)`` -> the
    port's ``SigMatrices`` (CPU tensors, bit for bit). The layout follows
    from the shapes: split columns (``mt [W/2, n_mels_pad]``, re|im split
    point ``W / 2``) or N-packed ones (``mt [W, n_mels_pad]``, split point
    0); ``mt_bf2`` has three times ``mt``'s rows."""
    big = _bf16(m_big)
    mt_t = torch.tensor(np.asarray(mt, dtype=np.float32))
    bf2 = _bf16(mt_bf2)
    width, n_pow = big.shape[1], mt_t.shape[0]
    if n_pow not in (width, width // 2) or width % 2 \
            or bf2.shape != (3 * n_pow, mt_t.shape[1]):
        raise ValueError(f"inconsistent shapes for split or N-packed "
                         f"columns: m_big {tuple(big.shape)}, mt "
                         f"{tuple(mt_t.shape)}, mt_bf2 {tuple(bf2.shape)}")
    split = 0 if n_pow == width else n_pow
    return SigMatrices(big, tuple(int(i) for i in pair_i), mt_t, bf2, split,
                       live_columns(big, split))


def from_jax_head(m_big, pair_i, mt, n_bins_pad: int, pack: int,
                  pack_off: int, n_mels: int, out_mode: str = "whisper",
                  guard: float = 0.0) -> SigHead:
    """One JAX frontend's kernel matrices as numpy arrays -> the port's
    ``SigHead`` (CPU tensors, bit for bit), for ``Fbank``, ``BatchLogMel``,
    ``WhisperKaldiFused`` and ``WhisperKaldiNemoFused`` (``matrices=``).
    ``m_big`` is the bf16 K-stack ``[K_tot, W]``, ``mt`` the projection as
    the kernel takes it: the bf2 stack (bf16, ``3 * npow`` rows, as JAX's
    ``Fbank._sig_mt``) or f32 (``npow`` rows); ``n_bins_pad`` the re|im
    split point (0: N-packed, ``npow = W``; else ``npow = n_bins_pad``);
    ``(pack, pack_off)`` the frame's contracted taps; ``n_mels`` the
    output columns in ``out_mode`` with ``guard``."""
    big = _bf16(m_big)
    a = np.asarray(mt)
    proj = (_bf16(a) if a.dtype.itemsize == 2
            else torch.tensor(np.asarray(a, dtype=np.float32)))
    npow = big.shape[1] if n_bins_pad == 0 else n_bins_pad
    rows = 3 * npow if proj.dtype == torch.bfloat16 else npow
    if proj.shape[0] != rows or n_bins_pad not in (0, big.shape[1] // 2):
        raise ValueError(f"inconsistent shapes: m_big {tuple(big.shape)}, "
                         f"mt {tuple(proj.shape)}, split {n_bins_pad}")
    return SigHead(big, tuple(int(i) for i in pair_i), proj, int(n_bins_pad),
                   int(pack), int(n_mels), pack_off=int(pack_off),
                   out_mode=out_mode, guard=float(guard))


def from_jax_framed_matrices(impl: str, *mats, hp_n_slices: int | None = None,
                             hp_max_pair_sum: int | None = None
                             ) -> FramedMatrices:
    """The tuple a JAX builder returns, converted to numpy, -> the port's
    ``FramedMatrices`` (CPU tensors, bit for bit) for
    ``whisper_mel_pallas(impl=impl, matrices=...)``:

    - ``"bf3"``: ``_bf3_device_matrices(...)`` = ``(slice_mats, mt, ...)``,
      bf16 planes;
    - ``"hp8"``: ``_hp8_device_matrices(...)``, int8 planes;
    - ``"hp_bf16"``: ``_hp_device_matrices(...)`` = ``(cs, ss, mt, ...)``;
    - ``"f32"``: ``_f32_device_matrices(...)`` = ``(cw, sw, mt, ...)``.

    Trailing ints (the pads) are ignored. The slice schedule is
    ``whisper_mel_pallas``'s for the same ``hp_n_slices`` /
    ``hp_max_pair_sum``, and must match the matrices' slice count."""
    if impl not in ("bf3", "hp8", "hp_bf16", "f32"):
        raise ValueError("impl must be 'bf3', 'hp8', 'hp_bf16' or 'f32'")
    ks, cutoff = pallas_schedule(impl, hp_n_slices, hp_max_pair_sum)
    if impl in ("bf3", "hp8"):
        slice_mats, mt = mats[0], mats[1]
        conv = (_bf16 if impl == "bf3" else
                (lambda a: torch.from_numpy(np.array(a, dtype=np.int8))))
        planes = tuple(conv(m) for m in slice_mats)
        if len(planes) != ks:
            raise ValueError(f"{len(planes)} slice matrices for ks {ks}")
    elif impl == "hp_bf16":
        planes, mt = (_bf16(mats[0]), _bf16(mats[1])), mats[2]
    else:
        planes = tuple(torch.tensor(np.asarray(m, dtype=np.float32))
                       for m in mats[:2])
        mt = mats[2]
    return FramedMatrices(impl, planes,
                          torch.tensor(np.asarray(mt, dtype=np.float32)),
                          ks, cutoff)


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
