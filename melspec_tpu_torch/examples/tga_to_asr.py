"""Load a TGA-stored mel spectrogram and hand it to an ASR runtime (port of
the JAX package's ``examples/tga_to_asr.py``).

Analogue of the reference's ``examples/tga_whisper``: inference from the
quantized mel alone, no audio needed. Exports the ``set_mel``-style
payload:

- default: writes an ``.npz`` with whisper-normalized ``input_features``
  [1, n_mels, T] plus the ONNX-style ``(audio, lengths)`` pair from
  ``mel_tensor`` (reference ``src/mel.rs:420-433``);
- with ``--whisper-model DIR`` (a local transformers checkpoint, loaded
  with ``local_files_only=True``: nothing is downloaded): transcribes on
  ``--device``. ``transformers`` is imported on that route only.

    python -m melspec_tpu_torch.examples.tga_to_asr \\
        /tmp/mels/mel_00000.tga --out feats.npz --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.io.tga import load_tga_8bit, to_array2
from melspec_tpu_torch.ops.batch_logmel import mel_tensor


def whisper_features(mel: np.ndarray, width: int = 3000) -> np.ndarray:
    """Pack a ``[n_mels, T]`` whisper-normalized mel into the
    ``input_features`` tensor a Whisper checkpoint consumes
    (``[1, n_mels, 3000]``, silence-padded): the ``set_mel`` contract of
    the reference's ``examples/tga_whisper/src/main.rs:40-41``."""
    feats = np.full((1, mel.shape[0], width), mel.min(), dtype=np.float32)
    feats[0, :, : min(width, mel.shape[1])] = mel[:, :width]
    return feats


def transcribe(mel: np.ndarray, model, processor=None, max_new_tokens=64):
    """Run a transformers Whisper model from mel features alone, on the
    model's device. Returns the decoded text when a processor is
    available, else the raw ids (numpy)."""
    max_new_tokens = min(max_new_tokens,
                         model.config.max_target_positions - 8)
    feats = torch.from_numpy(whisper_features(mel)).to(model.device)
    with torch.no_grad():
        ids = model.generate(feats, max_new_tokens=max_new_tokens)
    if processor is None:
        return ids.cpu().numpy()
    return processor.batch_decode(ids, skip_special_tokens=True)[0]


def load_whisper(model_dir, device: torch.device):
    """``(model, processor or None)`` from a LOCAL checkpoint directory
    (``local_files_only=True``: a missing file fails fast, it is never
    fetched). ``transformers`` is imported here only."""
    from transformers import (WhisperForConditionalGeneration,
                              WhisperProcessor)

    model = WhisperForConditionalGeneration.from_pretrained(
        model_dir, local_files_only=True).to(device).eval()
    try:
        processor = WhisperProcessor.from_pretrained(
            model_dir, local_files_only=True)
    except Exception:  # noqa: BLE001 — tokenizer files absent
        processor = None
    return model, processor


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("tga", type=Path)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--whisper-model", default=None,
                    help="local transformers Whisper checkpoint directory")
    _cli.add_device_flag(ap)
    args = ap.parse_args()
    dev = _cli.device(args)

    interleaved = load_tga_8bit(args.tga)
    mel = to_array2(interleaved, args.n_mels).astype(np.float32)
    print(f"loaded {args.tga}: {mel.shape[0]} mels x {mel.shape[1]} frames")

    audio, lengths = mel_tensor(interleaved, args.n_mels)

    if args.out is not None:
        np.savez(args.out, input_features=mel[None], audio=audio,
                 lengths=lengths)
        print(f"wrote {args.out}")

    if args.whisper_model is not None:
        model, processor = load_whisper(args.whisper_model, dev)
        print(transcribe(mel, model, processor))


if __name__ == "__main__":
    main()
