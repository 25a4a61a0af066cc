"""stdin PCM -> streaming mel + VAD -> speech segments ready for ASR (port
of the JAX package's ``examples/stream_asr_segments.py``).

Analogue of the reference's ``examples/stream_whisper`` binary
(``examples/stream_whisper/src/main.rs:76-172``): stream f32le PCM, detect
non-speech boundaries with the Sobel VAD, and at each boundary after at
least ``--min-frames`` frames emit the accumulated segment as a TGA file,
printed with its ``format_milliseconds`` start time. With
``--whisper-model DIR`` (a local transformers checkpoint, loaded with
``local_files_only=True``; nothing is downloaded) each segment is also
transcribed: the normalized mel IS whisper's ``input_features`` scaling
(``(max(x, max-8)+4)/4``), the ``set_mel`` pattern of the reference's
whisper-rs fork.

    ffmpeg -i talk.mp3 -f f32le -ar 16000 -ac 1 - | \\
        python -m melspec_tpu_torch.examples.stream_asr_segments \\
        --out-dir /tmp/segs
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from melspec_tpu_torch.config import DetectionSettings, MelConfig
from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.io.tga import interleave_frames, save_tga_8bit
from melspec_tpu_torch.io.wav import iter_pcm_f32le
from melspec_tpu_torch.streaming.pipeline import RingBuffer
from melspec_tpu_torch.streaming.vad import VoiceActivityDetector
from melspec_tpu_torch.utils.timing import format_milliseconds


def maybe_load_whisper(model_path, device):
    """``(model, processor)`` from a local checkpoint, or None (with a
    note on stderr) when none was given or it cannot be loaded offline."""
    if model_path is None:
        return None
    try:
        from melspec_tpu_torch.examples.tga_to_asr import load_whisper

        model, processor = load_whisper(model_path, device)
        if processor is None:
            raise OSError(f"no tokenizer files in {model_path}")
        return model, processor
    except Exception as exc:  # noqa: BLE001 — offline-safe example
        print(f"whisper unavailable ({exc}); emitting TGA segments only",
              file=sys.stderr)
        return None


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--fft-size", type=int, default=400)
    ap.add_argument("--hop-size", type=int, default=160)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--sampling-rate", type=float, default=16000.0)
    ap.add_argument("--min-frames", type=int, default=25,
                    help="minimum frames per emitted segment")
    ap.add_argument("--min-energy", type=float, default=1.0)
    ap.add_argument("--min-y", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=5)
    ap.add_argument("--min-mel", type=int, default=0)
    ap.add_argument("--out-dir", type=Path, default=Path("."))
    ap.add_argument("--whisper-model", default=None,
                    help="local transformers Whisper checkpoint directory")
    _cli.add_device_flag(ap)
    args = ap.parse_args()
    dev = _cli.device(args)

    config = MelConfig(args.fft_size, args.hop_size, args.n_mels,
                       args.sampling_rate)
    settings = DetectionSettings(args.min_energy, args.min_y, args.min_x,
                                 args.min_mel)
    rb = RingBuffer(config, capacity=1 << 20, device=dev)
    vad = VoiceActivityDetector(settings)
    whisper = maybe_load_whisper(args.whisper_model, dev)
    args.out_dir.mkdir(parents=True, exist_ok=True)

    segment = []
    seg_start_frame = 0
    frame_count = 0
    ms_per_frame = args.hop_size / args.sampling_rate * 1000.0

    def emit(frames, start_frame):
        if len(frames) < args.min_frames:
            return
        start_ms = int(start_frame * ms_per_frame)
        stamp = format_milliseconds(start_ms)
        interleaved = interleave_frames(frames, False, 100)
        path = args.out_dir / f"segment_{start_frame:08d}.tga"
        save_tga_8bit(interleaved, args.n_mels, str(path))
        text = ""
        if whisper is not None:
            import torch

            from melspec_tpu_torch.examples.tga_to_asr import \
                whisper_features

            model, processor = whisper
            mel = np.concatenate(frames, axis=1).astype(np.float32)
            if mel.shape[1] > 3000:
                print(f"warning: segment of {mel.shape[1]} frames exceeds "
                      "whisper's 3000-frame window; transcribing the first "
                      "30 s only", file=sys.stderr)
            feats = torch.from_numpy(whisper_features(mel)).to(model.device)
            with torch.no_grad():
                ids = model.generate(feats)
            text = processor.batch_decode(ids, skip_special_tokens=True)[0]
        print(f"frame [{stamp}] {len(frames)} frames -> {path.name} {text}")

    for samples in iter_pcm_f32le(sys.stdin.buffer):
        rb.add_frame(samples)
        for mel_frame in rb.drain_mels():
            decision = vad.add(mel_frame)
            segment.append(mel_frame)
            frame_count += 1
            if decision is False and len(segment) >= args.min_frames:
                emit(segment, seg_start_frame)
                segment = []
                seg_start_frame = frame_count
    emit(segment, seg_start_frame)


if __name__ == "__main__":
    main()
