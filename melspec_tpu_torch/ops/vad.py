"""Model-free Sobel-edge voice activity detection (port of
``melspec_tpu.ops.vad``).

Same decision function as the reference (``src/vad.rs``), vectorized: the
squared Sobel gradient of a whole mel image is eight shifted slices, a
column's classification is one masked row count, and the majority-vote
smoothing (``src/vad.rs:343-360``) is a prefix sum. The batched streaming
decision fields evaluate every per-frame decision of
``VoiceActivityDetector::add_activity`` (``src/vad.rs:156-205``) at once,
on any device. The host functions (``vad_boundaries``,
``streaming_decision_fields``, ``streaming_decisions``, the images) take
numpy images and classify in float64 on the CPU, as the JAX package's do.
``boundary_columns`` / ``fix_raw`` turn a fused kernel's Sobel counts
(K1's or K2's VAD epilogue) into raw column activity, recomputing the
columns whose patch crosses one of the kernel's tiles.

Geometry (bit-parity critical):
- gradients are evaluated with the 3x3 patch's TOP-LEFT corner at
  ``(y, x)``, ``y`` from ``start_y = min(min_mel, H-2)`` to ``H-3``;
- a window of ``W`` columns yields ``W-2`` classified columns;
- the smoothing window is ±4 columns, majority = ``2*count >= window_len``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from melspec_tpu_torch.config import (DetectionSettings, VadFrameTiming,
                                      VoiceActivityTimestamps)


@dataclasses.dataclass
class EdgeInfo:
    """Result of VAD boundary detection (reference ``src/vad.rs:488-524``).

    ``non_intersected_columns`` are good places to cut audio for ASR.
    """

    non_intersected_columns: List[int]
    intersected_columns: List[int]
    gradient_positions: Set[Tuple[int, int]]

    def non_intersected(self) -> List[int]:
        return list(self.non_intersected_columns)

    def intersected(self) -> List[int]:
        return list(self.intersected_columns)


def sobel_gradient_sq(img: torch.Tensor) -> torch.Tensor:
    """Squared Sobel gradient magnitude ``gx^2 + gy^2`` of every 3x3 patch:
    ``img [..., H, W]`` -> ``[..., H-2, W-2]``, entry ``(y, x)`` for the
    patch whose top-left corner is ``(y, x)`` (``src/vad.rs:472-486``)."""
    tl = img[..., :-2, :-2]
    tc = img[..., :-2, 1:-1]
    tr = img[..., :-2, 2:]
    ml = img[..., 1:-1, :-2]
    mr = img[..., 1:-1, 2:]
    bl = img[..., 2:, :-2]
    bc = img[..., 2:, 1:-1]
    br = img[..., 2:, 2:]
    gx = (tr + 2.0 * mr + br) - (tl + 2.0 * ml + bl)
    gy = (bl + 2.0 * bc + br) - (tl + 2.0 * tc + tr)
    return gx * gx + gy * gy


def classify_columns(img: torch.Tensor,
                     settings: DetectionSettings) -> torch.Tensor:
    """Raw per-column activity over a ``[..., H, W]`` mel image -> bool
    ``[..., W-2]``: a column is active when >= ``min_y`` of its gradients
    (rows ``start_y .. H-3``) have squared magnitude >= ``min_energy**2``
    (``src/vad.rs:373-415``); ``min_y == 0`` marks everything active."""
    height = img.shape[-2]
    width = img.shape[-1]
    if settings.min_y == 0:
        return torch.ones(img.shape[:-2] + (width - 2,), dtype=torch.bool,
                          device=img.device)
    g2 = sobel_gradient_sq(img)
    start_y = min(settings.min_mel, height - 2)
    g2 = g2[..., start_y:, :]
    thr = settings.min_energy * settings.min_energy
    counts = torch.sum(g2 >= thr, dim=-2)
    return counts >= settings.min_y


def smooth_mask(mask: torch.Tensor, window: int = 4) -> torch.Tensor:
    """Moving-window majority vote over a boolean mask: index ``i`` is true
    when at least half of ``mask[max(0,i-window) : min(i+window+1, n)]`` is
    true (``src/vad.rs:343-360``)."""
    n = mask.shape[-1]
    prefix = torch.cat(
        [torch.zeros(mask.shape[:-1] + (1,), dtype=torch.int32,
                     device=mask.device),
         torch.cumsum(mask.to(torch.int32), dim=-1, dtype=torch.int32)],
        dim=-1)
    i = torch.arange(n, device=mask.device)
    start = torch.clamp_min(i - window, 0)
    end = torch.clamp_max(i + window + 1, n)
    count = prefix[..., end] - prefix[..., start]
    return count * 2 >= (end - start)


def streaming_decision_fields_batched(mels, settings: DetectionSettings,
                                      raw=None) -> dict:
    """Batched decision fields of the streaming detector: ``mels [B,
    n_mels, T]`` -> dict of ``[B, n_dec]`` tensors, ``n_dec = T - min_x +
    1`` (decision ``i`` is for frame ``min_x - 1 + i``). ``raw`` (``[B,
    T-2]`` bool column classes) skips ``classify_columns``; ``mels`` may
    then be None. Requires ``T >= min_x >= 3`` and ``n_mels >= 3``."""
    if raw is not None:
        height, total = 3, raw.shape[-1] + 2  # height only gates the guard
    else:
        height, total = mels.shape[-2], mels.shape[-1]
    min_x = settings.min_x
    win_cols = min_x - 2
    if total < min_x or height < 3 or win_cols < 1:
        raise ValueError("need T >= min_x >= 3 and n_mels >= 3")
    if raw is None:
        raw = classify_columns(mels, settings)  # [B, T-2]
    n_dec = total - min_x + 1
    windows = torch.stack(
        [raw[..., j : j + n_dec] for j in range(win_cols)], dim=-1
    )  # [B, n_dec, win_cols]
    smoothed = smooth_mask(windows, 4)
    active_columns = torch.sum(smoothed, dim=-1)
    leading = torch.sum(torch.cumprod(smoothed.to(torch.int32), dim=-1),
                        dim=-1)
    return {
        "active": smoothed[..., 0],
        "leading": leading,
        "active_columns": active_columns,
        "window_columns": torch.full_like(active_columns, win_cols),
        "confidence": active_columns / win_cols,
    }


def boundary_columns(n_frames: int, n_cols: int, tile: int) -> list:
    """Raw VAD columns whose 3-frame patch crosses a boundary between two
    of a fused kernel's ``tile``-frame tiles (two per boundary): the
    kernel sees one tile at a time and cannot classify them."""
    tiles = -(-n_frames // tile)
    return [x for k in range(1, tiles) for x in (k * tile - 2, k * tile - 1)
            if x < n_cols]


def fix_raw(counts: torch.Tensor, mel: torch.Tensor, n_frames: int,
            n_cols: int, settings: DetectionSettings,
            tile: int) -> torch.Tensor:
    """Raw Sobel activity ``[B, n_cols]`` from a fused kernel's counts
    ``[B, >= n_cols]`` over its ``tile``-frame tiles, with the
    tile-boundary columns recomputed from the mel output ``[B, F,
    n_mels]`` by ``classify_columns`` (the same float32 expression tree as
    the kernels' epilogue)."""
    raw = counts[:, :n_cols] >= int(settings.min_y)
    bidx = boundary_columns(n_frames, n_cols, tile)
    if bidx:
        tri = torch.stack([mel[:, x : x + 3, :] for x in bidx], dim=1)
        raw[:, bidx] = classify_columns(tri.transpose(-1, -2),
                                        settings)[..., 0]
    return raw


def _image(frames) -> np.ndarray:
    """A ``[H, W]`` float64 image from an image or a list of ``[H, w]``
    frames concatenated on the time axis."""
    if isinstance(frames, (list, tuple)):
        return np.concatenate([np.asarray(f, np.float64) for f in frames],
                              axis=1)
    return np.asarray(frames, dtype=np.float64)


def vad_boundaries(
    frames: Union[np.ndarray, Sequence[np.ndarray]],
    settings: DetectionSettings,
) -> EdgeInfo:
    """Classify all columns of a mel image (or list of frames, logically
    concatenated on the time axis) into intersected / non-intersected
    (reference ``src/vad.rs:251-338``), in float64 on the CPU."""
    if isinstance(frames, (list, tuple)) and len(frames) == 0:
        return EdgeInfo([], [], set())
    img = _image(frames)
    height, width = img.shape
    if height < 3 or width < 3:
        return EdgeInfo([], [], set())
    raw = classify_columns(torch.from_numpy(img), settings)
    smoothed = smooth_mask(raw, 4).numpy()
    intersected = [int(x) for x in np.nonzero(smoothed)[0]]
    non_intersected = [int(x) for x in np.nonzero(~smoothed)[0]]
    # gradient_positions stays empty, as the reference ships it ("We leave
    # gradient_positions empty in this version", src/vad.rs:330-331);
    # as_image renders the overlay when a caller fills it
    return EdgeInfo(non_intersected, intersected, set())


def vad_on(edge_info: EdgeInfo, n: int) -> bool:
    """True when ``n`` contiguous intersected columns exist
    (reference ``src/vad.rs:224-249``)."""
    cols = edge_info.intersected_columns
    if not cols:
        return False
    contiguous = 1
    if contiguous >= n:  # the first column is itself a run of one
        return True
    prev = cols[0]
    for idx in cols[1:]:
        contiguous = contiguous + 1 if idx == prev + 1 else 1
        if contiguous >= n:
            return True
        prev = idx
    return False


def leading_active_columns(intersected: Sequence[int]) -> int:
    """Length of the consecutive run 0,1,2,... present in ``intersected``
    (reference ``src/vad.rs:212-222``)."""
    expected = 0
    for column in intersected:
        if column == expected:
            expected += 1
        elif column > expected:
            break
    return expected


@dataclasses.dataclass(frozen=True)
class VoiceActivity:
    """Streaming VAD decision (reference ``src/vad.rs:126-135``)."""

    active: bool
    frame_index: int
    leading_active_columns: int
    active_columns: int
    window_columns: int
    confidence: float
    timestamps: Optional[VoiceActivityTimestamps] = None


def streaming_decision_fields(
    mel: np.ndarray, settings: DetectionSettings
) -> Optional[dict]:
    """Every per-frame decision field of the streaming detector over a
    ``[n_mels, T]`` image, as numpy arrays (decision ``i`` is for frame
    ``min_x - 1 + i``), classified in float64 on the CPU. Returns None
    when the clip never reaches ``min_x`` frames."""
    mel = np.asarray(mel, dtype=np.float64)
    height, total = mel.shape
    min_x = settings.min_x
    if total < min_x:
        return None
    n_dec = total - min_x + 1
    if height < 3 or min_x - 2 < 1:
        zeros = np.zeros(n_dec)
        return {
            "active": zeros.astype(bool),
            "leading": zeros.astype(int),
            "active_columns": zeros.astype(int),
            "window_columns": zeros.astype(int),
            "confidence": zeros,
        }
    fields = streaming_decision_fields_batched(torch.from_numpy(mel[None]),
                                               settings)
    out = {k: v[0].numpy() for k, v in fields.items()}
    # the ratio in float64, as the detector's Python division gives it
    out["confidence"] = out["active_columns"] / (min_x - 2)
    return out


def streaming_decisions(
    mel: np.ndarray,
    settings: DetectionSettings,
    timing: Optional[VadFrameTiming] = None,
) -> List[Optional[VoiceActivity]]:
    """Evaluate every per-frame decision of the streaming detector over a
    full ``[n_mels, T]`` mel image in one vectorized pass.

    Equal to feeding frames one by one into ``VoiceActivityDetector`` (the
    reference loop, ``src/vad.rs:156-205``): the detector's window at
    frame ``t`` is the last ``min_x`` columns, whose raw Sobel
    classification equals the global classification restricted to columns
    ``t-min_x+1 .. t-2`` (the gradient is local), while the majority
    smoothing is re-run inside each window because it clips at window
    edges. Entry ``t`` is ``None`` while fewer than ``min_x`` frames are
    buffered.
    """
    mel = np.asarray(mel, dtype=np.float64)
    total = mel.shape[1]
    min_x = settings.min_x
    results: List[Optional[VoiceActivity]] = [None] * min(total, min_x - 1)
    fields = streaming_decision_fields(mel, settings)
    if fields is None:
        return results
    for i in range(len(fields["active"])):
        t = min_x - 1 + i
        results.append(
            VoiceActivity(
                active=bool(fields["active"][i]),
                frame_index=t,
                leading_active_columns=int(fields["leading"][i]),
                active_columns=int(fields["active_columns"][i]),
                window_columns=int(fields["window_columns"][i]),
                confidence=float(fields["confidence"][i]),
                timestamps=timing.timestamps_for_frame(t) if timing else None,
            )
        )
    return results


def as_image(
    frames: Union[np.ndarray, Sequence[np.ndarray]],
    non_intersected_columns: Sequence[int],
    gradient_positions: Set[Tuple[int, int]],
) -> np.ndarray:
    """Debug RGB render of a mel image with boundary columns tinted green
    and gradient positions red (reference ``src/vad.rs:528-577``); returns
    ``[H, W, 3] uint8`` with mel row 0 at the bottom."""
    img = _image(frames)
    height, width = img.shape
    max_val = max(img.max(), 0.0)
    if max_val > 0:
        # saturating cast (Rust `as u8` semantics): negatives -> 0
        scaled = np.clip(img * (255.0 / max_val), 0.0, 255.0).astype(np.uint8)
    else:
        scaled = np.zeros_like(img, np.uint8)
    scaled = scaled[::-1]  # row 0 at the bottom

    rgb = np.stack([scaled] * 3, axis=-1).astype(np.int32)
    for x in set(non_intersected_columns):
        if 0 <= x < width:
            rgb[:10, x] = [0, 255, 0]
            rgb[10:, x, 1] = np.minimum(rgb[10:, x, 1] + 60, 255)
    for (x, inv_y) in gradient_positions:
        y = height - inv_y - 3
        if 0 <= y < height and 0 <= x < width:
            rgb[y, x, 0] = min(int(rgb[y, x, 0]) + 200, 255)
    return rgb.astype(np.uint8)


def save_image(path, rgb: np.ndarray) -> None:
    """Write a debug image as PNG (needs Pillow)."""
    from PIL import Image

    Image.fromarray(rgb, mode="RGB").save(str(path))
