"""The port's spans on the card: the frontend step's four stages read
device time from real CUDA events, tile the step, and hand their events
back to the pool. Needs a CUDA device and nvcc; skipped elsewhere. On a
machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_spans.py
"""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import DetectionSettings
from melspec_tpu_torch.ops.spectrogram import WhisperMelPipeline
from melspec_tpu_torch.parallel.sharding import sharded_frontend_step
from melspec_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

STAGES = ("frontend_step.spectral", "frontend_step.nemo",
          "frontend_step.vad", "frontend_step.quant")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and K2 have no CPU mode)")
    profiling.disable()
    profiling.clear()
    yield torch.device("cuda")
    profiling.disable()
    profiling.clear()


def test_step_stages_tile_the_step_on_the_device(dev):
    step = sharded_frontend_step(settings=DetectionSettings(), device=dev)
    x = torch.from_numpy((np.random.default_rng(0).normal(
        size=(8, 160_000)) * 0.1).astype(np.float32)).to(dev)
    step(x)                               # warm: heads, libraries
    torch.cuda.synchronize(dev)
    profiling.enable()
    for _ in range(3):
        step(x)
    profiling.disable()
    torch.cuda.synchronize(dev)
    recs = profiling.records()
    calls = [r for r in recs if r.name == "frontend_step"]
    assert len(calls) == 3
    for call in calls:
        stages = [r for r in recs if r.parent == call.id]
        assert [r.name for r in stages] == list(STAGES)
        assert all(r.device_ms is not None and r.device_ms >= 0
                   for r in stages + [call])
        # the stages share their boundaries: their sum is the stretch
        # from the first stage's start to the last one's end
        assert sum(r.device_ms for r in stages) <= call.device_ms * 1.001
        assert call.attrs["k1_launches"] == 1
        assert call.attrs["k2_launches"] == 1
    s = profiling.summary()
    assert s["frontend_step.spectral"]["count"] == 3
    assert s["frontend_step"]["device_ms"] > 0
    # read with no span open: every event went back to its pool
    assert len(profiling._state.pools[dev.index or 0]) > 0


def test_mel_batch_span_reads_device_time(dev):
    pipe = WhisperMelPipeline(400, 160, 128, 16000.0, device=dev)
    x = torch.zeros(4, 160_000, device=dev)
    pipe.mel_batch(x)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipe.mel_batch(x)
        torch.cuda.synchronize(dev)
    (r,) = [r for r in profiling.records() if r.name == "mel_batch"]
    assert r.device_ms is not None and r.device_ms > 0
    assert r.attrs["k1_launches"] == 1
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "mel_batch" not in names
