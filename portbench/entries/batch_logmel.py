"""Entry: ``ops/batch_logmel.py::BatchLogMel.compute`` with the
configuration's ``fft_impl`` (``"auto"`` takes K1 on the card where it
takes the head: at NeMo's TTS settings a split magnitude head in 64-frame
blocks), on ``[B, T]`` clips, giving ``[B, n_mels, F]`` log-mel.

``reference`` is ``portbench/reference/nemo_tts.py::tts_log_mel`` on the
same clips, in blocks; ``compare`` gives ``tts_mel_gap``, the largest
absolute difference over every value of every checked call. ``FAULTS``:
what the call's answer can suffer (``tests/test_portbench_control.py``
plants each): half of the batch left out, the log-mel altered where it is
made."""

from __future__ import annotations

import torch

from portbench.lib.gaps import max_gap, worst
from portbench.reference import features, nemo_tts

FAULTS = [("half_batch", None), ("altered", None)]

# what the port's BatchLogMel computes beside the configuration's numbers
PORT_STATES = {"window": "hann", "mel_norm": "slaney", "normalize": None,
               "preemphasis": None, "dither": 0.0, "frame_splicing": 1}


def _impl(fft_impl: str, device: torch.device) -> str:
    """The route to ask ``BatchLogMel`` for: on the card, the
    configuration's. On the CPU, where the benchmark's tests rehearse a
    cell, ``"auto"`` would take the float32 rdft route, which the card
    never runs for a head that K1 takes; the CPU runs K1's plain version
    (``"sig"``), the route ``"auto"`` takes on the card, in its place."""
    return "sig" if fft_impl == "auto" and device.type == "cpu" else fft_impl


def frames(n: dict, samples: int) -> int:
    """Frames of a clip of ``samples`` under the configuration ``n``
    (NeMo's ``exact_pad`` framing: ``T // hop`` where ``n_fft - hop`` is
    even)."""
    pad = (n["n_fft"] - n["hop_length"]) // 2
    return (samples + 2 * pad - n["n_fft"]) // n["hop_length"] + 1


class Sut:
    def __init__(self, config: dict, params: dict, device: torch.device):
        from melspec_tpu_torch.config import BatchLogMelConfig
        from melspec_tpu_torch.kernels import sig_mel
        from melspec_tpu_torch.ops.batch_logmel import BatchLogMel

        n = config["nemo"]
        other = {k: n[k] for k in PORT_STATES if n[k] != PORT_STATES[k]}
        if other:
            raise ValueError(f"the port's BatchLogMel computes "
                             f"{PORT_STATES}, not {other}")
        self.logmel = BatchLogMel(BatchLogMelConfig(
            sample_rate=n["sample_rate"], n_fft=n["n_fft"],
            win_length=n["win_length"], hop_length=n["hop_length"],
            n_mels=n["n_mels"], f_min=float(n["f_min"]),
            f_max=float(n["f_max"]), htk=False, norm=True, preemphasis=0.0,
            center=False, log_zero_guard=float(n["log_zero_guard"]),
            pad_to=n["pad_to"], normalize_per_feature=False,
            mag_power=float(n["mag_power"]),
            log_zero_guard_type=n["log_zero_guard_type"],
            exact_pad=n["exact_pad"]),
            fft_impl=_impl(config["program"]["fft_impl"], device),
            device=device)
        self.route = {"fft_impl": self.logmel.fft_impl}
        if self.logmel.fft_impl == "sig" and device.type == "cuda":
            self.route["k1_block_frames"] = sig_mel.head_layout(
                self.logmel.sig_head, n["hop_length"]).frames
        self.n = n
        self.params = params

    def call(self, x: torch.Tensor) -> torch.Tensor:
        return self.logmel.compute(x)

    def counters(self) -> dict:
        from melspec_tpu_torch.kernels import sig_mel

        return {"K1": sig_mel.launches,
                **{f"sig_mel.{c}": getattr(sig_mel, c) for c in (
                    "magnitude_launches", "pipelined_launches",
                    "factored_launches", "fft_launches")}}

    def kernel_shapes(self) -> dict:
        n, p = self.n, self.params
        t = int(round(p["clip_seconds"] * n["sample_rate"]))
        nnz = int((features.slaney_filters(
            float(n["sample_rate"]), n["n_fft"], n["n_mels"], n["f_min"],
            n["f_max"]) != 0).sum())
        return {"k1": {"batch": p["batch"], "samples": t,
                       "frames": frames(n, t), "n_fft": n["n_fft"],
                       "n_mels": n["n_mels"], "nnz": nnz}}


def build(config: dict, params: dict, device: torch.device) -> Sut:
    return Sut(config, params, device)


def reference(config: dict, params: dict, inputs: list, precision: str,
              block: int = 16) -> list:
    return [torch.cat([nemo_tts.tts_log_mel(x[i : i + block],
                                            config["nemo"], precision)
                       for i in range(0, x.shape[0], block)])
            for x in inputs]


def compare(config: dict, params: dict, got: list, truth: list) -> dict:
    return {"tts_mel_gap": worst(*(max_gap(g, t)
                                   for g, t in zip(got, truth, strict=True)))}
