"""K5-K8's time probe on the CPU (it runs on the card only): every
edit of the device code matches ``csrc/framed_ozaki.cu`` exactly once, an
edit that no longer matches raises, the probes' shared build and binding
helpers (``kernels/build.py``) do what they say, and the command refuses
without a card."""

import ctypes
import subprocess
import sys
import types
from pathlib import Path

import pytest

from melspec_tpu_torch.kernels import build, ozaki_probe

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["full", *ozaki_probe.EDITS])
def test_edits_match_the_source_once(name):
    text = ozaki_probe.SOURCE.read_text()
    got = ozaki_probe.variant_source(name, text)
    if name == "full":
        assert got == text
        return
    edits = ozaki_probe.EDITS[name]
    for old, new in edits:
        assert text.count(old) == 1 and new in got
    assert len(got) - len(text) == sum(len(n) - len(o) for o, n in edits)


def test_a_moved_edit_raises():
    text = ozaki_probe.SOURCE.read_text()
    old, _ = ozaki_probe.EDITS["no_dft_mma"][0]
    with pytest.raises(ValueError, match="no_dft_mma"):
        ozaki_probe.variant_source("no_dft_mma", text.replace(old, ""))
    with pytest.raises(ValueError, match="2 places"):
        ozaki_probe.variant_source("no_dft_mma", text + old)


def test_cli_refuses_without_cuda():
    code = ("import torch, sys\n"
            "torch.cuda.is_available = lambda: False\n"
            "from melspec_tpu_torch.kernels import ozaki_probe\n"
            "sys.exit(ozaki_probe.main())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "CUDA is not available" in res.stderr
    assert res.stdout == ""


def test_build_variants_edits_a_copy_of_csrc(monkeypatch, tmp_path):
    """Each variant compiles its own copy of csrc/, with its edited files
    and every other file as it is (nvcc stubbed: it only records)."""
    calls = []

    def nvcc(src, out):
        calls.append((src, out))
        return subprocess.Popen([sys.executable, "-c", "pass"],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", nvcc)
    libs = build.build_variants("ozaki_probe", "framed_ozaki", {
        name: {"framed_ozaki.cu": ozaki_probe.variant_source(name)}
        for name in ("full", "no_projection")})
    assert sorted(libs) == ["full", "no_projection"]
    for name, so in libs.items():
        d = tmp_path / "ozaki_probe" / name
        assert so == d / "libframed_ozaki.so"
        assert (d / "framed_ozaki.cu").read_text() == \
            ozaki_probe.variant_source(name)
        assert (d / "sig_common.cuh").read_text() == \
            (build.CSRC_DIR / "sig_common.cuh").read_text()
    assert sorted(c[0].parent.name for c in calls) == ["full",
                                                       "no_projection"]


def test_bound_to_swaps_the_library_for_the_block():
    """Within the block the module's ``_bound()`` is the given library,
    typed as the module's own; afterwards the module's own again (the C
    library stands in for a kernel library)."""
    real = ctypes.CDLL("libc.so.6")
    real.strlen.argtypes = [ctypes.c_char_p]
    real.strlen.restype = ctypes.c_size_t
    mod = types.SimpleNamespace(_bound=lambda: real)
    before = mod._bound
    with build.bound_to(mod, Path("libc.so.6"), ["strlen"]) as lib:
        assert mod._bound() is lib and lib is not real
        assert lib.strlen.argtypes == [ctypes.c_char_p]
        assert lib.strlen(b"probe") == 5
    assert mod._bound is before
