"""README contract of the PyTorch port, as ``tests/test_readme_contract.py``
holds the JAX package's: every Python snippet of README's "PyTorch + CUDA
port" section runs as written, on the CPU, and every ``python -m
melspec_tpu_torch.examples...`` command line there parses with the
program's own flags.

The snippets call the entry points with ``device=None`` (CUDA), as a user
on a card would. Here every port module's ``resolve_device`` maps ``None``
to the CPU; an explicit ``"cuda"`` still raises on a host without CUDA.
The snippets' free inputs (``batch``, ``clip``, ``chunks``, ...) are small
seeded arrays; the scale-out snippet runs as one process without a group.
"""

import argparse
import importlib
import pkgutil
import re
import shlex
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import melspec_tpu_torch
from melspec_tpu_torch import _device

ROOT = Path(__file__).resolve().parents[1]
README = (ROOT / "README.md").read_text()


def _port_section() -> str:
    start = README.index("## PyTorch + CUDA port")
    end = README.index("\n## ", start + 1)
    return README[start:end]


def _blocks(lang: str) -> list:
    return re.findall(rf"```{lang}\n(.*?)```", _port_section(), re.S)


PY_BLOCKS = _blocks("python")


def _commands() -> list:
    """The ``python -m melspec_tpu_torch.examples...`` lines of the
    section's shell blocks, continuation lines joined, redirections and
    comments dropped."""
    cmds = []
    for block in _blocks("bash"):
        for line in block.replace("\\\n", " ").splitlines():
            line = line.split("#", 1)[0].split("<", 1)[0].strip()
            if line.startswith("python -m melspec_tpu_torch.examples."):
                cmds.append(line)
    return cmds


@pytest.fixture
def cpu_default(monkeypatch):
    """``device=None`` means the CPU in every port module for the test."""
    for info in pkgutil.walk_packages(melspec_tpu_torch.__path__,
                                      "melspec_tpu_torch."):
        importlib.import_module(info.name)
    real = _device.resolve_device

    def resolve(device=None):
        return real("cpu" if device is None else device)

    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == "melspec_tpu_torch" \
                and getattr(mod, "resolve_device", None) is real:
            monkeypatch.setattr(mod, "resolve_device", resolve)
    monkeypatch.chdir(ROOT)


def _inputs(block: str) -> dict:
    """The snippet's free inputs: the serving tick's ``chunks`` are one
    48 kHz hop for 256 streams, the live service's 256 hops of 16 kHz."""
    rng = np.random.default_rng(0)
    jfk = melspec_tpu_torch.read_wav_f32le(ROOT / "testdata"
                                           / "jfk_f32le.wav")
    shape = (256, 160) if "StreamingMel" in block else (256, 1, 480)
    return {
        "batch": np.stack([jfk[:16000], jfk[16000:32000]]),
        "clip": jfk[:16000],
        "chunks": (rng.normal(size=shape) * 0.3).astype(np.float32),
        "active": np.ones(256, bool),
        "hop_samples": jfk[:160],
        "pcm_block": jfk[:2048],
        "pcm48k": (rng.normal(size=12000) * 0.3).astype(np.float32),
    }


def test_section_has_the_snippets():
    assert len(PY_BLOCKS) == 6
    assert len(_commands()) >= 10


def _check(ns: dict, block: str) -> None:
    """What each snippet's comments promise."""
    if "mel_batch" in block:
        assert tuple(ns["mel"].shape) == (2, 98, 128)
        assert tuple(ns["out"]["mel"].shape) == (2, 98, 128)
        assert ns["q"].dtype == np.uint8 and ns["q"].shape == (256, 1, 128)
        assert ns["valid"].shape == (256, 1)
    elif "whisper_mel_vad_sig" in block:
        assert ns["q"].dtype == torch.uint8
        assert ns["act"] is not None and ns["blob"]
        mm = ns["vad_eval"].macro_metrics(ns["rows"])
        assert round(mm["precision"], 4) == 0.8751
        assert round(mm["f1"], 4) == 0.8566
    elif "make_mesh" in block:  # one process, no group: the whole batch
        assert ns["mesh"].size == 1 and ns["mesh"].group is None
        assert ns["step"] is not None and ns["n_valid"].shape == (24,)
        assert tuple(ns["out"]["mel"].shape) == (24, 98, 80)
        assert int(ns["out"]["vad_total_columns"]) > 0
        assert ns["q"].shape == (256, 1, 128) and ns["va"].dtype == torch.bool
    elif "profiling.enable()" in block:   # one step, traced
        assert ns["spans"]["frontend_step"]["count"] == 1
        assert [r.name for r in ns["recs"] if r.call == ns["recs"][-1].call
                ] == ["frontend_step", "frontend_step.spectral",
                      "frontend_step.nemo", "frontend_step.vad",
                      "frontend_step.quant"]
        assert ns["launches"]["sig_mel.launches"] >= 0
        assert tuple(ns["mel"].shape) == (2, 98, 80)
        ns["profiling"].clear()
    elif "SpeechToMel" in block:
        assert tuple(ns["mels"].shape) == (256, 128)
        assert ns["ok"].tolist() == [False]  # 160 samples never pushed
        assert ns["rec"]["ok"] is False and "SampleRing" in ns
    else:
        recs = ns["recs"]  # 25 source hops: 23 frames, less the warm-up
        spur = ns["server"].frontend.rs.spurious_out // 160
        assert len(recs) == 25 - 2 - spur
        assert [r[0] for r in recs] == list(range(len(recs)))
        assert recs[0][4].shape == (128,)
        assert ns["stats"]["ring_dropped"] == 0


@pytest.mark.parametrize("i", range(len(PY_BLOCKS)))
def test_python_snippet_runs(cpu_default, i):
    block = PY_BLOCKS[i]
    ns = _inputs(block)
    exec(compile(block, f"README port snippet {i}", "exec"), ns)
    _check(ns, block)


def test_pop_many_snippet_drains_a_hop(cpu_default):
    """The ring snippet's consumer line with a hop in the ring: ``ok`` is
    ``[True]`` and the row holds the samples."""
    block = PY_BLOCKS[2]
    ns = _inputs(block)
    line = "ring = mt.SampleRing(1 << 15)"
    code = block.replace(line, line + "; ring.push(hop_samples)")
    assert code != block
    exec(compile(code, "README ring snippet", "exec"), ns)
    assert ns["ok"].tolist() == [True]
    np.testing.assert_array_equal(ns["rows"][0], ns["hop_samples"])


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("cmd", _commands())
def test_example_command_parses(monkeypatch, cmd):
    """The command's flags are the program's own: its ``main`` is stopped
    right after ``parse_args`` succeeds (an unknown flag or bad value
    exits 2 there)."""
    argv = shlex.split(cmd)
    mod = importlib.import_module(argv[2])
    real = argparse.ArgumentParser.parse_args

    def parse_then_stop(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        parse_then_stop)
    monkeypatch.setattr(sys, "argv", [argv[2]] + argv[3:])
    with pytest.raises(_Parsed) as parsed:
        mod.main()
    args = parsed.value.args[0]
    if "--device" in argv:
        assert args.device == argv[argv.index("--device") + 1]
