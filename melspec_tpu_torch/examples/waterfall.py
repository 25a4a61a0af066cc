"""Render a colormapped mel waterfall PNG with a VAD activity strip (port
of the JAX package's ``examples/waterfall.py``).

The offline counterpart of the reference's browser canvas waterfall
(``examples/browser/app.js:102-186``: colormapped mel columns with a VAD
indicator row): the WAV's whisper mel and streaming VAD decisions,
written as an image with PIL.

    python -m melspec_tpu_torch.examples.waterfall testdata/jfk_f32le.wav \\
        --out /tmp/waterfall.png --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.io.wav import read_wav_mono
from melspec_tpu_torch.ops.spectrogram import compute_mel_spectrogram
from melspec_tpu_torch.ops.vad import streaming_decision_fields


def viridis_like(x: np.ndarray) -> np.ndarray:
    """Tiny fixed colormap: [0,1] -> RGB uint8 (dark blue -> green ->
    yellow)."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(3.0 * (x - 0.5), 0, 1)
    g = np.clip(1.8 * x, 0, 1) * (0.4 + 0.6 * x)
    b = np.clip(1.0 - 1.4 * x, 0.05, 1) * (1.0 - 0.5 * x)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("wav", type=Path)
    ap.add_argument("--out", type=Path, default=Path("waterfall.png"))
    ap.add_argument("--n-mels", type=int, default=80)
    _cli.add_device_flag(ap)
    args = ap.parse_args()
    dev = _cli.device(args)

    samples, rate = read_wav_mono(args.wav)
    mel = compute_mel_spectrogram(samples, 400, 160, args.n_mels,
                                  float(rate), device=dev).T  # [n_mels, T]

    lo, hi = mel.min(), mel.max()
    rgb = viridis_like((mel - lo) / max(hi - lo, 1e-9))[::-1]  # low at bottom

    fields = streaming_decision_fields(mel.astype(np.float64),
                                       DetectionSettings())
    strip = np.zeros((6, mel.shape[1], 3), dtype=np.uint8)
    if fields is not None:
        active = np.zeros(mel.shape[1], dtype=bool)
        active[len(active) - len(fields["active"]):] = fields["active"]
        strip[:, active] = [255, 64, 64]
        strip[:, ~active] = [32, 32, 32]

    img = np.concatenate([strip, rgb], axis=0)
    from PIL import Image

    Image.fromarray(img, "RGB").save(args.out)
    print(f"wrote {args.out}: {img.shape[1]}x{img.shape[0]}")


if __name__ == "__main__":
    main()
