"""The span of ``Fbank.compute`` on the card, at the ``kaldi-fbank-48k``
configuration's settings (48 kHz, n_fft 2048: K1's float64 FFT path):
``"auto"`` takes ``"sig"``, each call is one K1 launch on that path, and
the stages ``fbank.spectral`` and ``fbank.cmn`` read device time from
real CUDA events and tile the call. Needs a CUDA device and nvcc; skipped
elsewhere. On a machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_fbank_spans.py
"""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import FbankConfig
from melspec_tpu_torch.ops.fbank import Fbank
from melspec_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

CFG = FbankConfig(sample_rate=48000.0, num_mel_bins=80, dither=0.0,
                  apply_cmn=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU mode)")
    profiling.disable()
    profiling.clear()
    yield torch.device("cuda")
    profiling.disable()
    profiling.clear()


def test_fbank_48k_stages_tile_the_call_on_the_device(dev):
    f = Fbank(CFG, device=dev)
    assert f.fft_impl == "sig" and f.sig_head.fft is not None
    x = torch.from_numpy((np.random.default_rng(0).normal(
        size=(4, 480_000)) * 0.1).astype(np.float32)).to(dev)
    want = f.compute(x)                   # warm: head, library
    torch.cuda.synchronize(dev)
    assert profiling.records() == [r for r in profiling.records()
                                   if r.name.startswith("setup.")]
    profiling.enable()
    for _ in range(3):
        got = f.compute(x)
    profiling.disable()
    torch.cuda.synchronize(dev)
    assert torch.equal(got, want)
    recs = profiling.records()
    calls = [r for r in recs if r.name == "fbank"]
    assert len(calls) == 3
    for call in calls:
        stages = [r for r in recs if r.parent == call.id]
        assert [r.name for r in stages] == ["fbank.spectral", "fbank.cmn"]
        assert all(r.device_ms is not None and r.device_ms >= 0
                   for r in stages + [call])
        assert sum(r.device_ms for r in stages) <= call.device_ms * 1.001
        assert call.attrs["k1_launches"] == call.attrs["fft_launches"] == 1
