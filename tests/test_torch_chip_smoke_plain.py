"""chip_smoke.py's ``plain_kernels``: the stand-ins it patches over the
kernels' launchers take what the launchers take and, on the CPU, give
the same results through the frontends that call them, so a change of a
launcher's signature shows here and not first on the card."""
import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.kernels import resample as kres
from melspec_tpu_torch.kernels import sig_multi
from melspec_tpu_torch.ops import batch_logmel, mel_kernel
from melspec_tpu_torch.ops.batch_logmel import BatchLogMel
from melspec_tpu_torch.ops.sig_multihead import WhisperKaldiFused
from melspec_tpu_torch.streaming import multistream
from melspec_tpu_torch.streaming.multistream import MultiStreamMel

PATCHED = {"batch_logmel.sig_mel": (batch_logmel, "sig_mel"),
           "mel_kernel.sig_mel": (mel_kernel, "sig_mel"),
           "multistream.sig_mel": (multistream, "sig_mel"),
           "sig_multi.sig_multi": (sig_multi, "sig_multi"),
           "resample._launch": (kres, "_launch")}


def signal(b: int, n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(b, n)) * 0.2)
                            .astype(np.float32))


@pytest.mark.parametrize("target", sorted(PATCHED))
def test_plain_stub_takes_the_launchers_arguments(target):
    """Every parameter of the launcher, passed as its callers may pass it
    (positionally where it can be, else by name), binds to the stand-in."""
    mod, name = PATCHED[target]
    real = inspect.signature(getattr(mod, name))
    with chip_smoke.plain_kernels():
        stub = getattr(mod, name)
    assert stub is not getattr(mod, name)
    pos = [p.name for p in real.parameters.values()
           if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    kw = {p.name: None for p in real.parameters.values()
          if p.kind == p.KEYWORD_ONLY}
    inspect.signature(stub).bind(*pos, **kw)


def run_batch_logmel(x):
    return BatchLogMel(fft_impl="sig", device="cpu").compute(x)


def run_whisper_mel_sig(x):
    return mel_kernel.whisper_mel_sig(x, device="cpu")


def run_multistream(x):
    mel = MultiStreamMel(MelConfig(400, 160, 80, 16000.0), x.shape[0],
                         fft_impl="sig", device="cpu")
    chunks = x[:, : 12 * 160].reshape(x.shape[0], 12, 160).numpy()
    return mel.push_many(mel.init(), chunks)[1]


def run_fused(x):
    return WhisperKaldiFused(device="cpu").compute(x)


ROUTES = {"batch_logmel": (run_batch_logmel, "batch_logmel.sig_mel"),
          "whisper_mel_sig": (run_whisper_mel_sig, "mel_kernel.sig_mel"),
          "multistream": (run_multistream, "multistream.sig_mel"),
          "fused": (run_fused, "sig_multi.sig_multi")}


def flat(out) -> list:
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in flat(o)]
    return [torch.as_tensor(np.asarray(out)) if not torch.is_tensor(out)
            else out]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_plain_kernels_run_through_the_frontends(route):
    """Inside ``plain_kernels(torch.float64)`` each frontend calls the
    stand-in (counted) and, on the CPU, whose launchers sum the DFT dot
    in float64 too, gives the same values bit for bit."""
    run, target = ROUTES[route]
    mod, name = PATCHED[target]
    x = signal(2, 4000)
    want = run(x)
    with chip_smoke.plain_kernels(torch.float64):
        stub = getattr(mod, name)
        calls = []

        def spy(*a, **k):
            calls.append(1)
            return stub(*a, **k)

        setattr(mod, name, spy)
        try:
            got = run(x)
        finally:
            setattr(mod, name, stub)
    assert calls
    for g, w in zip(flat(got), flat(want), strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("pair", [False, True])
def test_plain_resample_stub_matches_the_cpu_route(pair):
    """The K3 / K4 stand-in, called as ``resample_routed`` calls
    ``_launch``, gives the CPU route's values (float32 dot)."""
    up, down = 2, 3
    a = signal(3, 120)
    b = signal(3, 40, seed=1) if pair else None
    g = kres.resample_matrices(up, down, 5.0, "highest", a.device)
    q = (120 + (40 if pair else 0) - g.shape[-2]) // down + 1
    want = kres.resample_routed(a, b, up, down, q)
    with chip_smoke.plain_kernels():
        got = kres._launch("K4" if pair else "K3", a, b, g, None, up, down,
                           q, "highest")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
