"""Streaming voice-activity detector (port of ``melspec_tpu.streaming.vad``).

Frame-at-a-time wrapper with the exact buffering/decision protocol of the
reference's ``VoiceActivityDetector`` (``src/vad.rs:137-205``): frames
accumulate in a bounded buffer (``max(min_x, 128)``, drained back to the
last ``min_x`` on overflow), decisions start once ``min_x`` frames are
buffered, and each decision classifies the window of the last ``min_x``
frames (in float64 on the CPU, ``ops.vad.vad_boundaries``). For offline
evaluation ``ops.vad.streaming_decisions`` gives the identical decision
sequence in one vectorized pass.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from melspec_tpu_torch.config import DetectionSettings, VadFrameTiming
from melspec_tpu_torch.ops.vad import (VoiceActivity, leading_active_columns,
                                       vad_boundaries)


class VoiceActivityDetector:
    def __init__(
        self,
        settings: DetectionSettings = DetectionSettings(),
        timing: Optional[VadFrameTiming] = None,
    ):
        self.settings = settings
        self.timing = timing
        self._mel_buffer: List[np.ndarray] = []
        self._frame_index = 0

    def add(self, frame: np.ndarray) -> Optional[bool]:
        """Push one mel frame; returns the activity decision once enough
        frames are buffered (reference ``src/vad.rs:156-158``)."""
        activity = self.add_activity(frame)
        return activity.active if activity is not None else None

    def add_activity(self, frame: np.ndarray) -> Optional[VoiceActivity]:
        """Push one mel frame (``[n_mels]`` or ``[n_mels, w]``); returns
        the decision with its timestamps once ``min_x`` frames are
        buffered, else None."""
        frame = np.asarray(frame, dtype=np.float64)
        if frame.ndim == 1:
            frame = frame[:, None]

        frame_index = self._frame_index
        self._frame_index += 1

        min_x = self.settings.min_x
        self._mel_buffer.append(frame)
        if len(self._mel_buffer) > max(min_x, 128):
            self._mel_buffer = self._mel_buffer[len(self._mel_buffer) - min_x:]
        if len(self._mel_buffer) < min_x:
            return None

        edge_info = vad_boundaries(self._mel_buffer[-min_x:], self.settings)
        intersected = edge_info.intersected_columns
        active_columns = len(intersected)
        window_columns = active_columns + len(edge_info.non_intersected_columns)
        return VoiceActivity(
            active=bool(intersected) and intersected[0] == 0,
            frame_index=frame_index,
            leading_active_columns=leading_active_columns(intersected),
            active_columns=active_columns,
            window_columns=window_columns,
            confidence=(
                0.0 if window_columns == 0 else active_columns / window_columns
            ),
            timestamps=(
                self.timing.timestamps_for_frame(frame_index)
                if self.timing
                else None
            ),
        )
