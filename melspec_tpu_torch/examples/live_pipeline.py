"""Three-stage threaded live pipeline over a lock-free ring (port of the
JAX package's ``examples/live_pipeline.py``).

The native analogue of the reference's browser pipeline: AudioWorklet
thread -> SAB ring -> WASM DSP worker -> SAB ring -> UI thread. Here a
producer thread pushes PCM into the native C++ SPSC ``SampleRing``, a
compute thread drains hop-sized chunks through ``SpeechToMel`` (streaming
mel + VAD, u8 records) into a queue, and the main thread consumes the
records and prints a summary.

    python -m melspec_tpu_torch.examples.live_pipeline \\
        --wav testdata/jfk_f32le.wav --device cpu
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
from pathlib import Path

from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.io.wav import read_wav_mono
from melspec_tpu_torch.runtime import SampleRing
from melspec_tpu_torch.streaming.speech_to_mel import SpeechToMel


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--wav", type=Path,
                    default=_cli.REPO / "testdata" / "jfk_f32le.wav")
    ap.add_argument("--realtime", action="store_true",
                    help="pace the producer at realtime (default: as fast "
                         "as possible)")
    _cli.add_device_flag(ap)
    args = ap.parse_args()
    dev = _cli.device(args)

    samples, rate = read_wav_mono(args.wav)
    pcm_ring = SampleRing(1 << 15)
    mel_queue: "queue.Queue" = queue.Queue(maxsize=4096)
    done = threading.Event()

    def producer():
        # mimics a 128-sample audio worklet callback
        for off in range(0, len(samples), 128):
            remaining = samples[off : off + 128]
            while remaining.size:
                accepted = pcm_ring.push(remaining)
                remaining = remaining[accepted:]
                if remaining.size:
                    time.sleep(0.001)  # ring full: backpressure
            if args.realtime:
                time.sleep(128 / rate)
        done.set()

    def compute():
        stm = SpeechToMel(400, 160, float(rate), 80, device=dev)
        while not (done.is_set() and len(pcm_ring) == 0):
            chunk = pcm_ring.pop(160)
            if chunk.size == 0:
                time.sleep(0.0005)
                continue
            out = stm.add(chunk)
            if out.get("ok"):
                mel_queue.put(out)
        mel_queue.put(None)

    t_prod = threading.Thread(target=producer, name="audio-worklet")
    t_comp = threading.Thread(target=compute, name="dsp-worker")
    started = time.perf_counter()
    t_prod.start()
    t_comp.start()

    frames = 0
    va_on = 0
    while True:
        item = mel_queue.get()
        if item is None:
            break
        frames += 1
        if item.get("va"):
            va_on += 1
    t_prod.join()
    t_comp.join()
    wall = time.perf_counter() - started
    audio_s = len(samples) / rate
    print(
        f"{frames} mel frames, {va_on} voice-active decisions, "
        f"dropped={pcm_ring.dropped}, {audio_s:.1f}s audio in {wall:.2f}s "
        f"({audio_s / wall:.1f}x realtime)"
    )


if __name__ == "__main__":
    main()
