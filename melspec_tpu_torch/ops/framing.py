"""Frame extraction (port of ``melspec_tpu.ops.framing``).

Frame-count semantics are the reference's:
- batch (whisper / fbank): ``(len - fft) // hop + 1``, zero frames when
  ``len < fft``;
- NeMo centered: ``len // hop + 1``;
- streaming overlap-and-save: the k-th emitted frame starts at
  ``ceil(fft/hop)*hop - fft + k*hop`` (``streaming_frame_offset``).

``frame_signal`` is a strided view (``Tensor.unfold``) of the signal: no
gather and no copy.
"""

from __future__ import annotations

import torch


def num_frames_batch(n_samples: int, fft_size: int, hop_size: int) -> int:
    """Whisper/fbank batch frame count (reference ``src/stft.rs:157``)."""
    if n_samples < fft_size:
        return 0
    return (n_samples - fft_size) // hop_size + 1


def num_frames_centered(n_samples: int, hop_size: int) -> int:
    """NeMo centered frame count (reference ``src/mel.rs:387-390``)."""
    return n_samples // hop_size + 1


def streaming_frame_offset(fft_size: int, hop_size: int) -> int:
    """Sample offset of the first frame the streaming path emits: the
    zero-initialized hop buffer first emits after ``ceil(fft/hop)`` hops,
    covering samples ``[first_hops*hop - fft, first_hops*hop)``."""
    first_hops = -(-fft_size // hop_size)
    return first_hops * hop_size - fft_size


def num_frames_streaming(n_samples: int, fft_size: int, hop_size: int) -> int:
    """Frames the streaming path emits for ``n_samples`` pushed in
    hop-sized chunks (a leftover < hop is never processed)."""
    n_hops = n_samples // hop_size
    first_hops = -(-fft_size // hop_size)
    return max(0, n_hops - first_hops + 1)


def frame_signal(
    samples: torch.Tensor,
    fft_size: int,
    hop_size: int,
    num_frames: int,
    offset: int = 0,
) -> torch.Tensor:
    """``[..., num_frames, fft_size]`` overlapping frames of ``[..., T]``:
    frame ``k`` is ``samples[..., offset + k*hop : offset + k*hop + fft]``.
    The result is a view of ``samples``."""
    if num_frames <= 0:
        return samples.new_zeros(samples.shape[:-1] + (0, fft_size))
    needed = offset + (num_frames - 1) * hop_size + fft_size
    if samples.shape[-1] < needed:
        raise ValueError(
            f"samples too short: have {samples.shape[-1]}, need {needed}"
        )
    return samples[..., offset:needed].unfold(-1, fft_size, hop_size)
