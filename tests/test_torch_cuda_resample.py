"""K3 and K4 on the card against their plain PyTorch version, and the
serving tick's launches. Needs a CUDA device and nvcc; skipped elsewhere.
On a machine with the card (no JAX needed):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_resample.py

Bars: highest sums 61 / 21 taps of a 0.3-scale signal in f32, held at
2e-6 against the plain version and the float64 result; bf3 against its
plain version (same bf16 products, another f32 order) at 2e-6 and
against the float64 result of the unsliced filter at 1e-5 x scale.
"""

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.kernels import resample as kres
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops.resample import _phase_matrix, resample_poly
from melspec_tpu_torch.streaming.resample import MultiStreamResampler
from melspec_tpu_torch.streaming.serving import SourceRateFrontend

pytestmark = pytest.mark.cuda

CFG = MelConfig(400, 160, 80, 16000.0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K3/K4 have no CPU mode)")
    return torch.device("cuda")


def _sig(seed, shape, dev):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=shape) * 0.3).astype(np.float32)).to(dev)


def _exact(sig, up, down, q):
    """The float64 result with the unsliced float64 phase matrix."""
    g = torch.as_tensor(_phase_matrix(up, down, 5.0)[0], device=sig.device)
    k = g.shape[0]
    win = sig.double()[:, : (q - 1) * down + k].unfold(-1, k, down)
    return (win @ g).reshape(sig.shape[0], q * up)


@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (1, 2)])
@pytest.mark.parametrize("precision", ["highest", "bf3"])
@pytest.mark.parametrize("s,hops", [(1, 1), (7, 3), (256, 1), (7, 60)])
def test_k3_k4_match_plain_and_exact(dev, up, down, precision, s, hops):
    hop_src = 160 * down // up
    mr = MultiStreamResampler(up, down, s, align=160, impl="kernel",
                              precision=precision, device=dev)
    n = hops * hop_src
    q = n // down
    buf = _sig(up + s, (s, mr._len), dev)
    chunks = _sig(down + hops, (s, n), dev)
    sig = torch.cat([buf, chunks], dim=1)
    before = dict(kres.launches)
    k3 = kres.resample(sig, up, down, q, precision=precision)
    torch.cuda.synchronize()
    assert kres.launches["K3"] == before["K3"] + 1
    g = kres.resample_matrices(up, down, 5.0, precision, dev)
    plain = kres.resample_reference(sig, g, up, down, q, precision)
    exact = _exact(sig, up, down, q)
    assert k3.shape == (s, q * up)
    assert float((k3 - plain).abs().max()) <= 2e-6
    err = float((k3.double() - exact).abs().max())
    scale = float(exact.abs().max())
    assert err <= (2e-6 if precision == "highest" else 1e-5 * scale)
    if n >= mr._len:
        k4 = kres.resample_pair(buf, chunks, up, down, q,
                                precision=precision)
        torch.cuda.synchronize()
        assert kres.launches["K4"] == before["K4"] + 1
        assert torch.equal(k4, k3)


def test_serving_tick_launches(dev):
    """One K4 launch per multi-hop 48 kHz tick, K3 for a 1-hop tick (n =
    480 < L = 510), one K1 launch per tick on the sig route."""
    front = SourceRateFrontend(CFG, 16, input_rate=48000, fft_impl="sig",
                               device=dev)
    st = front.init()
    x = np.random.default_rng(0).normal(size=(16, 4, 480)).astype(
        np.float32) * 0.3
    before = (sig_mel.launches, dict(kres.launches))
    for _ in range(3):
        st, q, lo, hi, va, valid = front.push_many(st, x)
    assert sig_mel.launches == before[0] + 3
    assert kres.launches == {"K3": before[1]["K3"],
                             "K4": before[1]["K4"] + 3}
    st = front.push_many(st, x[:, :1])[0]
    assert kres.launches["K3"] == before[1]["K3"] + 1
    assert valid[:, -1].all() and q.dtype == np.uint8


def test_44k_takes_the_conv_route(dev):
    """auto serves 44.1 kHz on the conv route (no kernel launch);
    impl='kernel' refuses it."""
    before = dict(kres.launches)
    mr = MultiStreamResampler(160, 441, 2, align=160, device=dev)
    mr.push(mr.init(), np.zeros((2, 441 * 4), np.float32))
    assert kres.launches == before
    mr = MultiStreamResampler(160, 441, 2, align=160, impl="kernel",
                              device=dev)
    with pytest.raises(ValueError, match="no Pallas geometry"):
        mr.push(mr.init(), np.zeros((2, 441 * 4), np.float32))


def test_conv_route_is_not_tf32(dev):
    """With TF32 allowed process-wide, the conv route and resample_poly
    still compute in full float32 (TF32 would be ~1e-3 relative)."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = _sig(3, (4, 48000), dev)
        got = resample_poly(x, 1, 3, device=dev)
        want = resample_poly(x.double(), 1, 3, device=dev)
        assert float((got.double() - want).abs().max()) <= 2e-6
        mr = MultiStreamResampler(1, 3, 4, align=160, impl="conv",
                                  device=dev)
        st, y = mr.step(mr.init(), x, torch.ones(4, dtype=torch.bool,
                                                 device=dev))
        sig = torch.cat([torch.zeros(4, mr._len, device=dev), x], dim=1)
        exact = _exact(sig, 1, 3, 16000)
        assert float((y.double() - exact).abs().max()) <= 2e-6
    finally:
        torch.backends.cudnn.allow_tf32 = saved
