"""Entry: ``ops/spectrogram.py::WhisperMelPipeline.mel_batch`` with the
configuration's ``fft_impl`` (``"auto"`` takes K1 on the card), on
``[B, T]`` clips, giving ``[B, F, n_mels]`` whisper log-mel.

``reference`` is ``portbench/reference/features.py::whisper_log_mel`` on
the same clips; ``compare`` gives ``mel_gap``, the largest absolute
difference over every value of every checked call. ``FAULTS``: what the
call's answer can suffer (``tests/test_portbench_control.py`` plants
each): half of the batch left out, the mel altered where it is made."""

from __future__ import annotations

import torch

from portbench.lib.gaps import max_gap, worst
from portbench.reference import features

FAULTS = [("half_batch", None), ("altered", None)]


class Sut:
    def __init__(self, config: dict, params: dict, device: torch.device):
        from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline

        fe = config["frontend"]
        self.pipe = WhisperMelPipeline(fe["n_fft"], fe["hop_length"],
                                       fe["n_mels"],
                                       float(fe["sample_rate"]),
                                       fft_impl=config["program"]["fft_impl"],
                                       device=device)
        self.route = {"fft_impl": self.pipe.fft_impl}
        self.fe = fe
        self.params = params

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self.pipe.mel_batch(x)

    def counters(self) -> dict:
        from melspec_tpu_torch.kernels import sig_mel

        return {"K1": sig_mel.launches,
                **{f"sig_mel.{c}": getattr(sig_mel, c) for c in (
                    "pipelined_launches", "factored_launches",
                    "fft_launches")}}

    def kernel_shapes(self) -> dict:
        fe, p = self.fe, self.params
        t = int(round(p["clip_seconds"] * fe["sample_rate"]))
        frames = (t - fe["n_fft"]) // fe["hop_length"] + 1
        nnz = int((features.slaney_filters(
            fe["sample_rate"], fe["n_fft"], fe["n_mels"])[:, :fe["n_fft"] // 2]
            != 0).sum())
        return {"k1": {"batch": p["batch"], "samples": t, "frames": frames,
                       "n_fft": fe["n_fft"], "n_mels": fe["n_mels"],
                       "nnz": nnz}}


def build(config: dict, params: dict, device: torch.device) -> Sut:
    return Sut(config, params, device)


def reference(config: dict, params: dict, inputs: list, precision: str,
              block: int = 16) -> list:
    fe = config["frontend"]
    out = []
    for x in inputs:
        out.append(torch.cat([
            features.whisper_log_mel(x[i : i + block], fe["n_fft"],
                                     fe["hop_length"], fe["n_mels"],
                                     float(fe["sample_rate"]), precision)
            for i in range(0, x.shape[0], block)]))
    return out


def compare(config: dict, params: dict, got: list, truth: list) -> dict:
    return {"mel_gap": worst(*(max_gap(g, t)
                               for g, t in zip(got, truth, strict=True)))}
