"""Entry: ``ops/fbank.py::Fbank.compute`` with the configuration's
``fft_impl`` (``"auto"`` takes K1 on the card where it takes the head: at
n_fft 2048, its float64 FFT path), on ``[B, T]`` clips, giving ``[B, F,
num_mel_bins]`` Kaldi log-fbank with per-clip CMN.

``reference`` is ``portbench/reference/features.py::kaldi_fbank`` on the
same clips, in blocks; ``compare`` gives ``fbank_gap``, the largest
absolute difference over every value of every checked call. ``FAULTS``:
what the call's answer can suffer (``tests/test_portbench_control.py``
plants each): half of the batch left out, the fbank altered where it is
made."""

from __future__ import annotations

import torch

from portbench.lib.gaps import max_gap, worst
from portbench.reference import features

FAULTS = [("half_batch", None), ("altered", None)]

# what the port's Fbank computes, whatever the configuration's file says
PORT_STATES = {"window_type": "povey", "remove_dc_offset": True,
               "round_to_power_of_two": True, "snip_edges": True}


def _impl(fft_impl: str, device: torch.device) -> str:
    """The route to ask ``Fbank`` for: on the card, the configuration's.
    On the CPU, where the benchmark's tests rehearse a cell, ``"auto"``
    would take the float32 rdft route, which the card never runs for a
    head that K1 takes; the CPU runs K1's plain version (``"sig"``), the
    route ``"auto"`` takes on the card, in its place."""
    return "sig" if fft_impl == "auto" and device.type == "cpu" else fft_impl


class Sut:
    def __init__(self, config: dict, params: dict, device: torch.device):
        from melspec_tpu_torch.config import FbankConfig
        from melspec_tpu_torch.ops.fbank import Fbank

        k = config["kaldi"]
        other = {key: k[key] for key in PORT_STATES
                 if k[key] != PORT_STATES[key]}
        if other:
            raise ValueError(f"the port's Fbank computes {PORT_STATES}, "
                             f"not {other}")
        self.fbank = Fbank(FbankConfig(
            sample_rate=float(k["sample_rate"]),
            num_mel_bins=k["num_mel_bins"],
            frame_length_ms=float(k["frame_length_ms"]),
            frame_shift_ms=float(k["frame_shift_ms"]),
            dither=float(k["dither"]),
            energy_floor=float(k["energy_floor"]),
            use_energy=k["use_energy"], use_log_fbank=k["use_log_fbank"],
            use_power=k["use_power"], preemphasis=float(k["preemphasis"]),
            apply_cmn=k["apply_cmn"], low_freq=float(k["low_freq"]),
            high_freq=float(k["high_freq"])),
            fft_impl=_impl(config["program"]["fft_impl"], device),
            device=device)
        self.route = {"fft_impl": self.fbank.fft_impl}
        self.k = k
        self.params = params

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self.fbank.compute(x)

    def counters(self) -> dict:
        from melspec_tpu_torch.kernels import sig_mel

        return {"K1": sig_mel.launches,
                **{f"sig_mel.{c}": getattr(sig_mel, c) for c in (
                    "pipelined_launches", "factored_launches",
                    "fft_launches")}}

    def kernel_shapes(self) -> dict:
        k, p = self.k, self.params
        sr = k["sample_rate"]
        t = int(round(p["clip_seconds"] * sr))
        flen = int(round(k["frame_length_ms"] * sr / 1000))
        shift = int(round(k["frame_shift_ms"] * sr / 1000))
        n_fft = 1 << (flen - 1).bit_length()
        nnz = int((features.kaldi_filters(sr, n_fft, k["num_mel_bins"],
                                          k["low_freq"], k["high_freq"])
                   != 0).sum())
        return {"k1": {"batch": p["batch"], "samples": t,
                       "frames": (t - flen) // shift + 1, "n_fft": n_fft,
                       "n_mels": k["num_mel_bins"], "nnz": nnz}}


def build(config: dict, params: dict, device: torch.device) -> Sut:
    return Sut(config, params, device)


def reference(config: dict, params: dict, inputs: list, precision: str,
              block: int = 16) -> list:
    return [torch.cat([features.kaldi_fbank(x[i : i + block],
                                            config["kaldi"], precision)
                       for i in range(0, x.shape[0], block)])
            for x in inputs]


def compare(config: dict, params: dict, got: list, truth: list) -> dict:
    return {"fbank_gap": worst(*(max_gap(g, t)
                                 for g, t in zip(got, truth, strict=True)))}
