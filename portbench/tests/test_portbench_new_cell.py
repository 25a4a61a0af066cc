"""A cell added as new files runs without an edit to any file that is
there: in a copy of the benchmark, a new workload file runs through the
harness in a fresh process, once with an existing traffic kind at another
batch and clip length, and once with a new traffic module of its own; and
a new configuration with a new entry and a cell at 48 kHz on up-sampled
speech passes the copy's own per-cell tests (files, generators,
reference, result, control and faults, roofline)."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.lib import registry

SCRIPT = """
import json, sys, time, torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from portbench import run
from portbench.lib import registry
assert str(registry.ROOT).startswith(sys.argv[1]), registry.ROOT
out = run.run_cell(sys.argv[3], 5, 0.5, False, torch.device("cpu"),
                   time.perf_counter())
print(json.dumps(out["result"]))
"""

# a new traffic kind: a fixed number of single-clip requests, one at a time,
# each waited for; written as a later change would add it
ONE_AT_A_TIME = '''
import time

from portbench.lib.device import sync
from portbench.lib.signals import generator, make

TINY = {"requests": 2, "clip_seconds": 0.5, "trace_seconds": 0.2}


def prepare(sut, run):
    p = run.params
    n = int(round(p["clip_seconds"] * p["sample_rate"]))
    x = make(generator(run.seed, run.device), p["signal"], p["requests"], n,
             p["sample_rate"], run.device)
    sut.call(x[:1])
    sync(run.device)
    return {"x": x}


def drive(sut, load, run):
    x, lat, outs = load["x"], [], []
    for i in range(x.shape[0]):
        t = time.perf_counter()
        outs.append(sut.call(x[i : i + 1]))
        sync(run.device)
        lat.append(time.perf_counter() - t)
    return {"attempted": len(outs), "failed": 0,
            "metrics": {"request_max_ms": (1e3 * max(lat), "ms")},
            "inputs": [x[i : i + 1] for i in range(len(outs))],
            "outputs": outs, "notes": {}}
'''


# a new configuration: Kaldi fbank alone at 48 kHz, as Kaldi's
# compute-fbank-feats defaults at --sample-frequency 48000 state it, on
# K1's float64 FFT path ("sig", which "auto" takes there on the card; its
# plain version on the CPU)
KALDI_48K = {
    "name": "harness-proof-kaldi-48k",
    "source": "Kaldi src/feat/feature-fbank.h and feature-window.h defaults "
              "of compute-fbank-feats at --sample-frequency 48000",
    "precision": "float32, TF32 off",
    "kaldi": {"sample_rate": 48000, "num_mel_bins": 80,
              "frame_length_ms": 25.0, "frame_shift_ms": 10.0, "dither": 0.0,
              "preemphasis": 0.97, "low_freq": 20.0, "high_freq": 0.0,
              "energy_floor": 0.0, "use_energy": False,
              "use_log_fbank": True, "use_power": True, "apply_cmn": True},
    "program": {"fft_impl": "sig"},
    "reduced": [],
}

# a new entry: ops/fbank.py::Fbank alone, judged by the reference's
# kaldi_fbank, with the faults its answer can have
FBANK_ALONE = '''
import torch

from portbench.lib.gaps import max_gap, worst
from portbench.reference import features

FAULTS = [("half_batch", None), ("altered", None)]


class Sut:
    def __init__(self, config, params, device):
        from melspec_tpu_torch.config import FbankConfig
        from melspec_tpu_torch.ops.fbank import Fbank

        k = config["kaldi"]
        self.fbank = Fbank(FbankConfig(
            sample_rate=float(k["sample_rate"]),
            num_mel_bins=k["num_mel_bins"],
            frame_length_ms=k["frame_length_ms"],
            frame_shift_ms=k["frame_shift_ms"], dither=k["dither"],
            energy_floor=k["energy_floor"], use_energy=k["use_energy"],
            use_log_fbank=k["use_log_fbank"], use_power=k["use_power"],
            preemphasis=k["preemphasis"], apply_cmn=k["apply_cmn"],
            low_freq=k["low_freq"], high_freq=k["high_freq"]),
            fft_impl=config["program"]["fft_impl"], device=device)
        self.route = {"fft_impl": self.fbank.fft_impl}
        self.k, self.params = k, params

    def call(self, x):
        return self.fbank.compute(x)

    def counters(self):
        from melspec_tpu_torch.kernels import sig_mel

        return {"K1": sig_mel.launches,
                "sig_mel.fft_launches": sig_mel.fft_launches}

    def kernel_shapes(self):
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


def build(config, params, device):
    return Sut(config, params, device)


def reference(config, params, inputs, precision, block=16):
    return [torch.cat([features.kaldi_fbank(x[i : i + block],
                                            config["kaldi"], precision)
                       for i in range(0, x.shape[0], block)])
            for x in inputs]


def compare(config, params, got, truth):
    return {"fbank_gap": worst(*(max_gap(g, t)
                                 for g, t in zip(got, truth, strict=True)))}
'''


def _same_kind(copy):
    cell = registry.load_json("workloads", "whisper-large-v3.offline-b64x30s")
    cell.update(name="whisper-large-v3.offline-b3x1s",
                params=dict(cell["params"], batch=3, clip_seconds=1.0))
    return cell, {}


def _new_kind(copy):
    cell = registry.load_json("workloads", "whisper-large-v3.offline-b64x30s")
    cell.update(name="whisper-large-v3.one-at-a-time", traffic="one_at_a_time",
                end_to_end=["setup_s", "request_max_ms"],
                params={"requests": 3, "batch": 1, "clip_seconds": 1.0,
                        "sample_rate": 16000, "trace_seconds": 0.2,
                        "signal": {"signal": "recorded",
                                   "file": "speech16k.npz",
                                   "gain_db": [-30, 0]}})
    return cell, {"traffic/one_at_a_time.py": ONE_AT_A_TIME}


def _copy_with(tmp_path, cell: dict, files: dict):
    """A copy of the benchmark under ``tmp_path`` with the cell's workload
    file and ``files`` (path under the copy: text) added, none of which
    may be there; returns the copy and its files as they were."""
    copy = tmp_path / "portbench"
    shutil.copytree(registry.ROOT, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes()
              for p in copy.rglob("*") if p.is_file()}
    added = {f"workloads/{cell['name']}.json": json.dumps(cell), **files}
    for rel, text in added.items():
        assert not (copy / rel).exists(), rel
        (copy / rel).write_text(text)
    return copy, before


@pytest.mark.parametrize("make_cell", [_same_kind, _new_kind])
def test_a_new_cell_in_new_files_runs_unedited(make_cell, tmp_path):
    cell, modules = make_cell(tmp_path)
    copy, before = _copy_with(tmp_path, cell, modules)
    p = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path),
                        str(registry.ROOT.parent), cell["name"]],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] >= 1, res
    assert list(res["metrics"]) == cell["end_to_end"]
    for rel, data in before.items():
        assert (copy / rel).read_bytes() == data, rel


def test_a_new_configuration_passes_the_per_cell_tests_unedited(tmp_path):
    """A new configuration, a new entry that declares its ``FAULTS`` and a
    cell at 48 kHz whose ring holds up-sampled speech, as new files only:
    the copy's own tests of that cell and entry pass in a fresh process,
    and no file of the copy changes."""
    cell = registry.load_json("workloads", "asr-trio.offline-b64x30s")
    cell.update(name="harness-proof-kaldi-48k.offline-b64x30s",
                config=KALDI_48K["name"], entry="harness_proof_fbank",
                end_to_end=["setup_s", "audio_x_realtime"],
                per_layer=["k1_roofline_pct", "device_idle_pct.offline"],
                limits={"fbank_gap": 0.06})
    cell["params"] = dict(cell["params"], sample_rate=48000, ring=[
        {"signal": "speechlike"},
        {"signal": "recorded", "file": "speech16k.npz",
         "gain_db": [-30, 0]}])
    copy, before = _copy_with(tmp_path, cell, {
        f"configs/{KALDI_48K['name']}.json": json.dumps(KALDI_48K),
        "entries/harness_proof_fbank.py": FBANK_ALONE})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(registry.ROOT.parent)]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", str(copy / "tests"), "-q",
         "-p", "no:cacheprovider", "-k",
         f"{cell['name']} or harness_proof_fbank"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    tail = p.stdout[-3000:]
    assert p.returncode == 0, tail + p.stderr[-2000:]
    # files, generators, reference, result (twice), control, two faults,
    # roofline, and the entry's FAULTS; the card's test skips here
    summary = tail.strip().splitlines()[-1]
    passed = re.search(r"(\d+) passed", summary)
    assert passed and int(passed.group(1)) >= 10, tail
    assert "failed" not in summary and "error" not in summary, tail
    for rel, data in before.items():
        assert (copy / rel).read_bytes() == data, rel
