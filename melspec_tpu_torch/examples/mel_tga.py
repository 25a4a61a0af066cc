"""stdin f32le PCM -> streaming mel -> chunked TGA files (port of the JAX
package's ``examples/mel_tga.py``).

Analogue of the reference's ``examples/mel_tga`` binary: pipe raw mono
float32 PCM (e.g. from ffmpeg) and get 8-bit quantized mel spectrogram
images on disk.

    ffmpeg -i talk.mp3 -f f32le -ar 16000 -ac 1 - | \\
        python -m melspec_tpu_torch.examples.mel_tga --out-dir /tmp/mels
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.io.tga import interleave_frames, save_tga_8bit
from melspec_tpu_torch.io.wav import iter_pcm_f32le
from melspec_tpu_torch.streaming.pipeline import RingBuffer


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--fft-size", type=int, default=400)
    ap.add_argument("--hop-size", type=int, default=160)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--sampling-rate", type=float, default=16000.0)
    ap.add_argument("--chunk-frames", type=int, default=1000,
                    help="frames per TGA file")
    ap.add_argument("--out-dir", type=Path, default=Path("."))
    _cli.add_device_flag(ap)
    args = ap.parse_args()
    dev = _cli.device(args)

    config = MelConfig(args.fft_size, args.hop_size, args.n_mels,
                       args.sampling_rate)
    rb = RingBuffer(config, capacity=1 << 20, device=dev)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    frames = []
    file_idx = 0

    def flush():
        nonlocal frames, file_idx
        if not frames:
            return
        interleaved = interleave_frames(frames, False, 0)
        path = args.out_dir / f"mel_{file_idx:05d}.tga"
        save_tga_8bit(interleaved, args.n_mels, str(path))
        print(f"wrote {path} ({len(frames)} frames)", file=sys.stderr)
        frames = []
        file_idx += 1

    for samples in iter_pcm_f32le(sys.stdin.buffer):
        rb.add_frame(samples)
        frames.extend(rb.drain_mels())
        if len(frames) >= args.chunk_frames:
            flush()
    flush()


if __name__ == "__main__":
    main()
