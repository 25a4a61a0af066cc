"""K1's time probe on the CPU (it runs on the card only): every cut of
the device code matches ``csrc/sig_common.cuh`` (the pipelined walk's:
``csrc/sig_pipe.cuh``; the factored path's: ``csrc/sig_factored.cuh``;
the float64 FFT path's, both instances: ``csrc/sig_fft.cuh``) exactly
once, a cut that no longer matches raises, the Kaldi and NeMo fronts of
its ``dump`` carry the FFT path at each rate (at n_fft 1024 too),
``compare`` holds the 1024-point cases to their float64 route, and the
command refuses without a card."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from melspec_tpu_torch.kernels import sig_probe

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["full", *sig_probe.CUTS,
                                  *sig_probe.PIPE_CUTS])
def test_cuts_match_the_header_once(name):
    assert not set(sig_probe.CUTS) & set(sig_probe.PIPE_CUTS)
    text = sig_probe.cut_file(name).read_text()
    got = sig_probe.variant_source(name, text)
    if name == "full":
        assert got == text
    else:
        old, new = {**sig_probe.CUTS, **sig_probe.PIPE_CUTS}[name]
        assert old not in got and got.count(new) >= 1
        assert len(got) - len(text) == len(new) - len(old)


def test_a_moved_cut_raises():
    text = sig_probe.HEADER.read_text()
    old, _ = sig_probe.CUTS["no_dft_mma"]
    with pytest.raises(ValueError, match="no_dft_mma"):
        sig_probe.variant_source("no_dft_mma", text.replace(old, ""))
    with pytest.raises(ValueError, match="2 places"):
        sig_probe.variant_source("no_dft_mma", text + old)


def test_cli_refuses_without_cuda():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from melspec_tpu_torch.kernels import sig_probe\n"
            "sys.exit(sig_probe.main())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "CUDA is not available" in res.stderr
    assert res.stdout == ""


@pytest.mark.parametrize("name", ["full", *sig_probe.FACTORED_CUTS])
def test_factored_cuts_match_their_header_once(name):
    """The factored path's cuts each match ``csrc/sig_factored.cuh``
    exactly once."""
    text = sig_probe.FACTORED.read_text()
    got = sig_probe.factored_source(name, text)
    if name == "full":
        assert got == text
    else:
        old, new = sig_probe.FACTORED_CUTS[name]
        assert old not in got
        assert len(got) - len(text) == len(new) - len(old)


@pytest.mark.parametrize("name", ["full", *sig_probe.FFT_CUTS])
def test_fft_cuts_match_their_header_once(name):
    """The float64 FFT path's cuts each match ``csrc/sig_fft.cuh``
    exactly once."""
    text = sig_probe.FFT.read_text()
    got = sig_probe.fft_source(name, text)
    if name == "full":
        assert got == text
    else:
        cuts = sig_probe.FFT_CUTS[name]
        assert all(old not in got for old, _ in cuts)
        assert len(got) - len(text) == sum(len(new) - len(old)
                                           for old, new in cuts)


@pytest.mark.parametrize("name", [*sig_probe.FFT1024_CUTS])
def test_fft1024_cuts_match_their_header_once(name):
    """The 1024-point instance's cuts each match ``csrc/sig_fft.cuh``
    exactly once, and none touches the 2048-point instance's text."""
    text = sig_probe.FFT.read_text()
    got = sig_probe.fft_source(f"w1024_{name}", text)
    cuts = sig_probe.FFT1024_CUTS[name]
    assert all(old not in got for old, _ in cuts)
    assert len(got) - len(text) == sum(len(new) - len(old)
                                       for old, new in cuts)
    start = text.index("__device__ __forceinline__ void fft2048_frames(")
    end = text.index("// the buffer's place of B[t][k1] (the 1024 instance")
    assert text[start:end] in got


def test_fft1024_fronts_carry_the_1024_heads():
    """``dump``'s heads at n_fft 1024 are on the sig route with heads
    that carry the 1024-point description (the TTS head magnitude, its
    372 bins), beside a float64 rdft route."""
    import torch

    fronts = sig_probe.fft1024_fronts(torch.device("cpu"))
    assert [n for n, _, _ in fronts] == [c[0] for c in sig_probe.FFT1024_CASES]
    for name, (front, f64), _ in fronts:
        head = front.sig_head
        assert front.fft_impl == "sig" and f64.fft_impl == "rdft"
        assert head.dft_size == head.fft.size == 1024
        assert head.magnitude == ("tts" in name or "mag" in name)
    assert fronts[0][1][0].sig_head.fft.bins == 372


def _dump_1024(d, gap, fft_path, other="same"):
    d.mkdir()
    ref = np.linspace(-20.0, 2.0, 24).reshape(2, 3, 4)
    np.save(d / "fft1024_nemo_tts.npy", (ref + gap).astype(np.float32))
    np.save(d / "fft1024_nemo_tts.ref.npy", ref)
    cases = {"sig_x": {"sha256": [other]},
             "fft1024_nemo_tts": {"sha256": [str(gap)],
                                  "fft_path": fft_path}}
    (d / "dump.json").write_text(json.dumps({"package": str(d),
                                             "cases": cases}))
    return d


@pytest.mark.parametrize("parent_gap,gap,want", [
    (0.0, 0.0, 0), (5e-4, 1e-5, 0), (0.0, 3e-4, 1)])
def test_compare_holds_fft1024_cases_to_their_float64_route(
        tmp_path, parent_gap, gap, want):
    """An ``fft1024_...`` case is not held to another dump: where the FFT
    path ran it (the second dump) it must lie within ``REF_TOL`` of its
    own float64 route; where a chunk walk ran it (the first, a parent's)
    its distance is reported alone. Every other case stays bit-equal."""
    dirs = [_dump_1024(tmp_path / "parent", parent_gap, False),
            _dump_1024(tmp_path / "change", gap, True)]
    assert sig_probe.compare(dirs) == want
    other = [dirs[0], _dump_1024(tmp_path / "other", gap, True, "other")]
    assert sig_probe.compare(other) == 1
    none = [dirs[0], _dump_1024(tmp_path / "walk", gap, False)]
    assert sig_probe.compare(none) == 1


@pytest.mark.parametrize("rate", sig_probe.LN_RATES)
def test_ln_fronts_carry_the_fft_heads(rate):
    """``dump``'s Kaldi and NeMo fronts at each of ``LN_RATES`` (48, 64,
    80 kHz) are on the sig route with heads that carry the float64 FFT
    path's description, frames of ``rate / 40`` taps."""
    import torch

    fronts = sig_probe.ln_fronts(torch.device("cpu"), rate)
    assert sorted(fronts) == ["kaldi", "nemo"]
    for front in fronts.values():
        assert front.fft_impl == "sig"
        assert front.sig_head.dft_size == 2048
        assert front.sig_head.fft is not None
        assert front.sig_head.pack == rate // 40


@pytest.mark.parametrize("ln_gap,want", [(0.0, 0), (1e-6, 0), (1e-5, 1)])
def test_compare_holds_ln_cases_within_their_bar(tmp_path, ln_gap, want):
    """``compare`` passes bit-equal dumps, lets an ``ln_...`` case of the
    FFT path differ by at most ``LN_TOL`` (its saved outputs), and fails a
    case past it, or any other case that differs."""
    out = np.linspace(-20.0, 2.0, 24, dtype=np.float32).reshape(2, 3, 4)
    dirs = []
    for k, gap in enumerate((0.0, ln_gap)):
        d = tmp_path / f"dump{k}"
        d.mkdir()
        ln = out + np.float32(gap)
        np.save(d / "ln_kaldi_48000.npy", ln)
        cases = {"sig_x": {"sha256": ["same"]},
                 "ln_kaldi_48000": {"sha256": [str(ln.tobytes())]}}
        (d / "dump.json").write_text(json.dumps(
            {"package": str(d), "cases": cases}))
        dirs.append(d)
    assert sig_probe.compare(dirs) == want
    cases = json.loads((dirs[1] / "dump.json").read_text())
    cases["cases"]["sig_x"]["sha256"] = ["other"]
    (dirs[1] / "dump.json").write_text(json.dumps(cases))
    assert sig_probe.compare(dirs) == 1
