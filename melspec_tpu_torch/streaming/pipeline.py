"""Live-audio streaming pipeline: sample ring -> hop drain -> device mel
(port of ``melspec_tpu.streaming.pipeline``).

The counterpart of the reference's ``RingBuffer`` (``src/rb.rs``): a
native lock-free sample ring (``runtime.SampleRing``) feeds hop-sized
chunks into the streaming mel state. Two drain modes:

- ``maybe_mel()``: one hop per call, the reference's cadence
  (``src/rb.rs:86-121``): drains exactly ``hop_size`` samples and returns
  a whisper-normalized ``[n_mels, 1]`` column once the first window
  fills;
- ``drain_mels()``: drains every complete hop buffered and runs them
  through one bulk ``StreamingMel.push_many``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.runtime.ringbuffer import SampleRing
from melspec_tpu_torch.streaming.stft import StreamingMel


class RingBuffer:
    def __init__(self, config: MelConfig, capacity: int,
                 dtype=torch.float32, device=None):
        if capacity < config.hop_size:
            # SampleRing rounds capacity to a power of two; anything below
            # one hop could never drain a frame
            raise ValueError(
                f"capacity {capacity} < hop_size {config.hop_size}: "
                "the ring could never hold one hop"
            )
        self.config = config
        self._mel = StreamingMel(config, dtype=dtype, device=device)
        self._ring = SampleRing(capacity)
        self._accumulated = np.zeros(0, dtype=np.float32)
        self._state = self._mel.init()

    def add_frame(self, samples: np.ndarray) -> int:
        """Push a block of samples; the excess beyond capacity is dropped
        (reference ``src/rb.rs:54-70``). Returns the samples accepted."""
        return self._ring.push(np.asarray(samples, dtype=np.float32))

    def add(self, sample: float) -> None:
        self._ring.push(np.asarray([sample], dtype=np.float32))

    def _drain_hops(self, max_hops: Optional[int] = None) -> np.ndarray:
        """Pull as many complete hops as are available (<= max_hops)."""
        hop = self.config.hop_size
        n_hops = (len(self._ring) + self._accumulated.size) // hop
        if max_hops is not None:
            n_hops = min(n_hops, max_hops)
        if n_hops == 0:
            return np.zeros((0, hop), dtype=np.float32)
        pulled = self._ring.pop(n_hops * hop - self._accumulated.size)
        samples = np.concatenate([self._accumulated, pulled])
        n_hops = samples.size // hop
        self._accumulated = samples[n_hops * hop:]
        return samples[: n_hops * hop].reshape(n_hops, hop)

    def maybe_mel(self) -> Optional[np.ndarray]:
        """Drain one hop if available; returns ``[n_mels, 1]`` once the
        overlap window has filled, else None."""
        chunks = self._drain_hops(max_hops=1)
        if chunks.shape[0] == 0:
            return None
        self._state, mels, valid = self._mel.push_many(self._state, chunks)
        if not bool(valid[0]):
            return None
        return mels[0][:, None]

    def drain_mels(self) -> List[np.ndarray]:
        """Drain every buffered complete hop in one bulk push; returns a
        list of ``[n_mels, 1]`` frames (possibly empty)."""
        chunks = self._drain_hops()
        if chunks.shape[0] == 0:
            return []
        self._state, mels, valid = self._mel.push_many(self._state, chunks)
        return [mels[i][:, None] for i in range(mels.shape[0]) if valid[i]]
