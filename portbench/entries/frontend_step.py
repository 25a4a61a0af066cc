"""Entry: one ``parallel/sharding.py::sharded_frontend_step`` call on a
one-card mesh: whisper log-mel, Kaldi fbank with per-clip CMN and NeMo
log-mel normalised per feature, the Sobel VAD, its two aggregates and the
u8 quantisation of the whisper mel over the whole block.

``reference`` works every output out again from the clips
(``portbench/reference``); ``compare`` gives ``mel_gap`` (the mel, and the
u8 block with its range, in mel units), ``fbank_gap``, ``nemo_gap`` and
``vad_flips`` (smoothed columns that differ, plus the difference of the
active-column count; infinite where the total column count differs).
``FAULTS``: what the step's answer can suffer
(``tests/test_portbench_control.py`` plants each): half of the batch left
out, and each output altered where it is made."""

from __future__ import annotations

import torch

from portbench.lib.gaps import INF, max_gap, worst
from portbench.reference import features, records, vad

FAULTS = [("half_batch", None)] + [
    ("altered", k) for k in ("mel", "fbank", "nemo", "vad_smoothed",
                             "mel_q8")]


def _configs(config: dict):
    from melspec_tpu_torch.config import (BatchLogMelConfig,
                                          DetectionSettings, FbankConfig,
                                          MelConfig)

    w, k, n = (config["frontends"][f] for f in ("whisper", "kaldi", "nemo"))
    mel = MelConfig(w["n_fft"], w["hop_length"], w["n_mels"],
                    float(w["sample_rate"]))
    fbank = FbankConfig(
        sample_rate=float(k["sample_rate"]), num_mel_bins=k["num_mel_bins"],
        frame_length_ms=float(k["frame_length_ms"]),
        frame_shift_ms=float(k["frame_shift_ms"]), dither=float(k["dither"]),
        energy_floor=float(k["energy_floor"]), use_energy=k["use_energy"],
        use_log_fbank=k["use_log_fbank"], use_power=k["use_power"],
        preemphasis=float(k["preemphasis"]), apply_cmn=k["apply_cmn"],
        low_freq=float(k["low_freq"]), high_freq=float(k["high_freq"]))
    nemo = BatchLogMelConfig(
        sample_rate=n["sample_rate"], n_fft=n["n_fft"],
        win_length=n["win_length"], hop_length=n["hop_length"],
        n_mels=n["n_mels"], f_min=float(n["f_min"]), f_max=n["f_max"],
        htk=False, norm=True, preemphasis=float(n["preemphasis"]),
        center=True, log_zero_guard=float(n["log_zero_guard"]),
        pad_to=n["pad_to"],
        normalize_per_feature=n["normalize"] == "per_feature")
    v = config["vad"]
    settings = DetectionSettings(v["min_energy"], v["min_y"], v["min_x"],
                                 v["min_mel"])
    return mel, fbank, nemo, settings


class Sut:
    def __init__(self, config: dict, params: dict, device: torch.device):
        from melspec_tpu_torch.ops import batch_logmel
        from melspec_tpu_torch.parallel.sharding import (frontend_route,
                                                         make_mesh,
                                                         sharded_frontend_step)

        mel, fbank, nemo, settings = _configs(config)
        self.step = sharded_frontend_step(make_mesh(device=device), settings,
                                          mel_config=mel, nemo_config=nemo,
                                          fbank_config=fbank)
        self.route = {
            "whisper_kaldi": frontend_route(mel, fbank, device),
            "nemo_fft_impl": batch_logmel.auto_fft_impl(nemo, torch.float32,
                                                        device)}
        self.config = config
        self.params = params

    def call(self, x: torch.Tensor) -> dict:
        return self.step(x)

    def counters(self) -> dict:
        from melspec_tpu_torch.kernels import sig_mel, sig_multi

        return {"K1": sig_mel.launches, "K2": sig_multi.launches,
                **{f"sig_mel.{c}": getattr(sig_mel, c) for c in (
                    "pipelined_launches", "factored_launches",
                    "fft_launches")}}

    def kernel_shapes(self) -> dict:
        w, k, n = (self.config["frontends"][f]
                   for f in ("whisper", "kaldi", "nemo"))
        p = self.params
        sr = w["sample_rate"]
        t = int(round(p["clip_seconds"] * sr))
        frames = (t - w["n_fft"]) // w["hop_length"] + 1
        k_fft = 1 << (int(round(k["frame_length_ms"] * sr / 1000)) - 1
                      ).bit_length()

        def nnz(f):
            return int((f != 0).sum())

        return {
            "k1": {"batch": p["batch"], "samples": t + n["n_fft"],
                   "frames": t // n["hop_length"] + 1, "n_fft": n["n_fft"],
                   "n_mels": n["n_mels"],
                   "nnz": nnz(features.slaney_filters(
                       n["sample_rate"], n["n_fft"], n["n_mels"], n["f_min"],
                       n["f_max"]))},
            "k2": {"batch": p["batch"], "samples": t, "frames": frames,
                   "vad_bytes": 4,
                   "heads": [
                       {"n_fft": w["n_fft"], "n_mels": w["n_mels"],
                        "nnz": nnz(features.slaney_filters(
                            sr, w["n_fft"], w["n_mels"])
                            [:, :w["n_fft"] // 2])},
                       {"n_fft": k_fft, "n_mels": k["num_mel_bins"],
                        "nnz": nnz(features.kaldi_filters(
                            sr, k_fft, k["num_mel_bins"], k["low_freq"],
                            k["high_freq"]))}]},
        }


def build(config: dict, params: dict, device: torch.device) -> Sut:
    return Sut(config, params, device)


def _one(config: dict, x: torch.Tensor, precision: str) -> dict:
    w, k, n = (config["frontends"][f] for f in ("whisper", "kaldi", "nemo"))
    v = config["vad"]
    mel = features.whisper_log_mel(x, w["n_fft"], w["hop_length"],
                                   w["n_mels"], float(w["sample_rate"]),
                                   precision)
    smoothed = vad.majority(vad.column_classes(
        mel.transpose(-1, -2), v["min_energy"], v["min_y"], v["min_mel"]))
    return {"mel": mel, "fbank": features.kaldi_fbank(x, k, precision),
            "nemo": features.nemo_log_mel(x, n, precision),
            "vad_smoothed": smoothed}


def reference(config: dict, params: dict, inputs: list, precision: str,
              block: int = 16) -> list:
    out = []
    for x in inputs:
        parts = [_one(config, x[i : i + block], precision)
                 for i in range(0, x.shape[0], block)]
        r = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
        lo, hi = r["mel"].min(), r["mel"].max()
        r["mel_q8"] = records.quantize(r["mel"], lo, hi)
        r["mel_q8_range"] = torch.stack([lo, hi])[None]
        r["q8_positions"] = records.positions(r["mel"], lo, hi)
        r["vad_active_columns"] = r["vad_smoothed"].sum()
        r["vad_total_columns"] = torch.tensor(r["vad_smoothed"].numel())
        out.append(r)
    return out


def compare(config: dict, params: dict, got: list, truth: list) -> dict:
    mel = fbank = nemo = flips = 0.0
    for g, t in zip(got, truth, strict=True):
        lo, hi = (float(v) for v in t["mel_q8_range"][0])
        q = torch.as_tensor(g["mel_q8"], device=t["mel"].device)
        excess = (records.excess_steps(q, t["q8_positions"]).max()
                  if q.shape == t["mel"].shape else INF)
        mel = worst(mel, max_gap(g["mel"], t["mel"]),
                    max_gap(g["mel_q8_range"], t["mel_q8_range"]),
                    float(excess) * (hi - lo) / 255.0)
        fbank = worst(fbank, max_gap(g["fbank"], t["fbank"]))
        nemo = worst(nemo, max_gap(g["nemo"], t["nemo"]))
        sm = torch.as_tensor(g["vad_smoothed"], device=t["mel"].device)
        if (sm.shape != t["vad_smoothed"].shape
                or int(g["vad_total_columns"]) != int(t["vad_total_columns"])):
            flips = INF
            continue
        flips += float((sm != t["vad_smoothed"]).sum()) + abs(
            int(g["vad_active_columns"]) - int(t["vad_active_columns"]))
    return {"mel_gap": mel, "fbank_gap": fbank, "nemo_gap": nemo,
            "vad_flips": flips}
