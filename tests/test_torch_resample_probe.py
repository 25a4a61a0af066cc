"""K3/K4's probe on the CPU (it runs on the card only): every cut of the
device code matches ``csrc/resample.cu`` exactly once, a cut that no
longer matches raises, ``compare`` holds dumps' hashes equal case by
case, the cases are the ones ``chip_smoke.py`` holds, the command
refuses without a card, and the per-launch timer both use queues its
launches behind a device spin."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from melspec_tpu_torch.kernels import resample_probe

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["full", *resample_probe.CUTS])
def test_cuts_match_the_source_once(name):
    text = resample_probe.SOURCE.read_text()
    got = resample_probe.variant_source(name, text)
    if name == "full":
        assert got == text
    else:
        old, new = resample_probe.CUTS[name]
        assert old not in got and got.count(new) >= 1
        assert len(got) - len(text) == len(new) - len(old)


def test_a_moved_cut_raises():
    text = resample_probe.SOURCE.read_text()
    old, _ = resample_probe.CUTS["no_span_copies"]
    with pytest.raises(ValueError, match="no_span_copies"):
        resample_probe.variant_source("no_span_copies",
                                      text.replace(old, ""))


def _write(d: Path, cases):
    d.mkdir()
    (d / "dump.json").write_text(json.dumps(dict(package=str(d), device="x",
                                                 cases=cases)))


def test_compare_holds_hashes_equal(tmp_path, capsys):
    a = {"bulk_48k/K3/highest": dict(sha256="0f", ms=0.1, call_ms=0.2),
         "vs_plain_1_3_s1_h1/K3/bf3": dict(sha256="aa")}
    b = dict(a, **{"vs_plain_1_3_s1_h1/K3/bf3": dict(sha256="ab")})
    _write(tmp_path / "a", a)
    _write(tmp_path / "a2", a)
    _write(tmp_path / "b", b)
    assert resample_probe.compare([tmp_path / "a", tmp_path / "a2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_equal"] == 2 and out["times_ms_and_call_ms"] == {
        "bulk_48k/K3/highest": [[0.1, 0.2], [0.1, 0.2]]}
    assert resample_probe.compare([tmp_path / "a", tmp_path / "b"]) == 1
    assert json.loads(capsys.readouterr().out)["differ"] == [
        "vs_plain_1_3_s1_h1/K3/bf3"]


def test_timed_cases_are_the_serving_kernels():
    names = ["bulk_48k/K3/bf3", "tick_4hop_48k/K4/highest",
             "tick_4hop_48k/K3/highest", "tick_1hop_48k/K3/highest",
             "tick_4hop_8k/K4/bf3", "vs_plain_1_3_s1_h1/K3/highest"]
    assert [resample_probe.timed(n) for n in names] == [
        True, True, False, True, False, False]


def test_cli_refuses_without_cuda():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from melspec_tpu_torch.kernels import resample_probe\n"
            "sys.exit(resample_probe.main(['cuts']))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "CUDA is not available" in res.stderr
    assert res.stdout == ""


def test_per_launch_ms_queues_the_launches_behind_a_spin(monkeypatch):
    """``utils/timing.py::per_launch_ms``: warm-ups, one host-timed run,
    then each timed run of ``launches`` calls after a device spin longer
    than that run's host time; the result is one run's interval over
    ``launches``."""
    import torch

    from melspec_tpu_torch.utils import timing

    log = []

    class Event:
        def __init__(self, enable_timing):
            self.at = None

        def record(self):
            self.at = len(log)
            log.append("event")

        def elapsed_time(self, other):
            return 2.0  # ms between two events, whatever they enclose

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep",
                        lambda cycles: log.append(("spin", cycles)))
    calls = []
    ms = timing.per_launch_ms(lambda: calls.append(1), launches=10, reps=3,
                              warmup=4)
    assert len(calls) == 4 + 10 + 3 * 10 and ms == 2.0 / 10
    spins = [e[1] for e in log if isinstance(e, tuple)]
    assert spins[0] == 1 << 20 and len(spins) == 4
    assert all(c >= 1 << 20 for c in spins[1:])
    # each timed run: a spin, then its first event
    starts = [i for i, e in enumerate(log) if isinstance(e, tuple)][1:]
    assert all(log[i + 1] == "event" for i in starts)
