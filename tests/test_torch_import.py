"""The PyTorch port stands alone: it imports no JAX and nothing of the JAX
package, and its entry points never fall back to the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import melspec_tpu_torch as mt
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops.mel_kernel import whisper_mel_vad_sig
from melspec_tpu_torch.utils import vad_eval

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "melspec_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "melspec_tpu"


def test_import_and_cpu_call_load_no_jax():
    code = (
        "import sys, numpy as np\n"
        "import melspec_tpu_torch\n"
        "import melspec_tpu_torch.parallel.sharding as sh\n"
        "import melspec_tpu_torch.ops.sig_multihead as mh\n"
        "from melspec_tpu_torch import whisper_mel_sig\n"
        "out = whisper_mel_sig(np.zeros(4000, np.float32), device='cpu')\n"
        "assert tuple(out.shape) == (23, 80), out.shape\n"
        "step = sh.sharded_frontend_step(device='cpu')\n"
        "res = step(np.zeros((1, 4000), np.float32))\n"
        "assert len(res) == 8 and mh.WhisperKaldiNemoFused\n"
        "import melspec_tpu_torch.parallel as par\n"
        "mesh = par.make_mesh(device='cpu')\n"
        "rows, nv = par.chunk_audio([np.zeros(900, np.float32)], 400)\n"
        "out, _ = par.multihost_frontend(mesh, [], 4000, 2)\n"
        "assert len(par.__all__) == 11 and out['mel'].shape[0] == 2\n"
        "import melspec_tpu_torch.utils.vad_eval as ve\n"
        "import melspec_tpu_torch.kernels.load_probe as lp\n"
        "from melspec_tpu_torch.ops.mel_kernel import whisper_mel_vad_sig\n"
        "mel, raw = whisper_mel_vad_sig(np.zeros(4000, np.float32),\n"
        "                               melspec_tpu_torch.DetectionSettings(),\n"
        "                               device='cpu')\n"
        "assert tuple(raw.shape) == (21,) and ve.preset and lp.run\n"
        "assert melspec_tpu_torch.tga_8bit_data(np.ones(160), 80)\n"
        "from melspec_tpu_torch.prelude import *\n"
        "import melspec_tpu_torch.runtime as rt\n"
        "import melspec_tpu_torch.utils.profiling as prof\n"
        "rb = RingBuffer(MelConfig(), 1024, device='cpu')\n"
        "rb.add_frame(np.zeros(800, np.float32))\n"
        "assert len(rb.drain_mels()) == 3\n"
        "assert rt.SampleRing(8).capacity == 8\n"
        "assert not SpeechToMel(device='cpu').get()['ok'] and prof.trace\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0].startswith('jax')\n"
        "             or m.split('.')[0] == 'melspec_tpu')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)], names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda x: mt.whisper_mel_sig(x),
    lambda x: mt.whisper_mel_pallas(x),
    lambda x: mt.WhisperMelPipeline(),
    lambda x: mt.compute_mel_spectrogram(x, 400, 160, 80, 16000.0),
    lambda x: mt.compute_streaming_mel(x, 400, 160, 80, 16000.0),
    lambda x: mt.whisper_mel_sig(x, device="cuda"),
    lambda x: mt.Fbank(),
    lambda x: mt.Mfcc(),
    lambda x: mt.BatchLogMel(),
    lambda x: mt.WhisperKaldiFused(),
    lambda x: mt.WhisperKaldiNemoFused(),
    lambda x: mt.sharded_frontend_step(),
    lambda x: mt.whisper_mel_quantized(x),
    lambda x: whisper_mel_vad_sig(x, mt.DetectionSettings()),
    lambda x: vad_eval.evaluate_testset_batched(
        ROOT / "testdata" / "ten-vad", vad_eval.EvalOptions(),
        mt.DetectionSettings()),
    lambda x: mt.StreamingMel(),
    lambda x: mt.RingBuffer(mt.MelConfig(), 2048),
    lambda x: mt.SpeechToMel(),
], ids=["sig", "pallas", "pipeline", "compute", "streaming", "cuda", "fbank",
        "mfcc", "nemo", "fused", "trihead", "step", "quantized", "vad_sig",
        "vad_eval", "streaming_mel", "ring_buffer", "speech_to_mel"])
def test_default_device_raises_without_cuda(no_cuda, call):
    before = sig_mel.launches
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(np.zeros(4000, np.float32))
    assert sig_mel.launches == before


def test_cpu_tensor_runs_plain_version_without_launch_count():
    x = torch.from_numpy(
        (np.random.default_rng(0).normal(size=(2, 3000)) * 0.2)
        .astype(np.float32))
    before = sig_mel.launches
    out = mt.whisper_mel_sig(x, device="cpu")
    assert out.device.type == "cpu" and tuple(out.shape) == (2, 17, 80)
    assert sig_mel.launches == before


def test_wrapper_rejects_devices_other_than_cuda_and_cpu():
    with pytest.raises(ValueError, match="unsupported device"):
        sig_mel.sig_mel(torch.zeros(1, 400, device="meta"), None, (0,),
                        None, ks=1, n_frames=1, hop=160, offset=0, pack=400,
                        n_bins_pad=256, n_mels=80)


def test_import_builds_nothing():
    """Kernels build at their first launch, never at import."""
    code = ("import melspec_tpu_torch, melspec_tpu_torch.kernels.sig_mel as k\n"
            "import melspec_tpu_torch.kernels.resample as r\n"
            "import melspec_tpu_torch.kernels.sig_multi as m\n"
            "import melspec_tpu_torch.kernels.load_probe as p\n"
            "import sys; sys.exit(0 if not k._bound.cache_info().currsize\n"
            "         and not r._bound.cache_info().currsize\n"
            "         and not m._bound.cache_info().currsize\n"
            "         and not p._bound.cache_info().currsize else 1)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
