"""Port vs JAX: framing, the real-DFT matmuls and the accurate float32
logs, on the same numpy inputs."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.ops import dft as jdft
from melspec_tpu.ops import fastmath as jfm
from melspec_tpu.ops import framing as jfr
from melspec_tpu_torch.ops import dft, fastmath, framing

CONFIGS = [(400, 160), (512, 160), (400, 100), (320, 80), (25, 10)]


@pytest.mark.parametrize("fft,hop", CONFIGS)
def test_frame_counts_match_jax(fft, hop):
    for t in [0, 1, fft - 1, fft, fft + 1, fft + hop - 1, fft + hop,
              3 * fft + 7, 16000, 16037]:
        assert framing.num_frames_batch(t, fft, hop) == \
            jfr.num_frames_batch(t, fft, hop)
        assert framing.num_frames_streaming(t, fft, hop) == \
            jfr.num_frames_streaming(t, fft, hop)
        assert framing.num_frames_centered(t, hop) == \
            jfr.num_frames_centered(t, hop)
    assert framing.streaming_frame_offset(fft, hop) == \
        jfr.streaming_frame_offset(fft, hop)


@pytest.mark.parametrize("fft,hop", CONFIGS)
@pytest.mark.parametrize("offset", [0, 80])
def test_frame_signal_matches_jax(fft, hop, offset):
    rng = np.random.default_rng(fft + hop + offset)
    x = rng.normal(size=(2, 3 * fft + offset + 5)).astype(np.float32)
    for nf in [0, (x.shape[-1] - offset - fft) // hop + 1]:
        want = np.asarray(jfr.frame_signal(jnp.asarray(x), fft, hop, nf,
                                           offset=offset))
        got = framing.frame_signal(torch.from_numpy(x), fft, hop, nf,
                                   offset=offset).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_frame_signal_rejects_short_input():
    with pytest.raises(ValueError, match="too short"):
        framing.frame_signal(torch.zeros(500), 400, 160, 3)


@pytest.mark.parametrize("fft,n_bins", [(400, 200), (512, 256), (25, 13)])
def test_rdft_matrices_match_jax(fft, n_bins):
    for a, b in zip(dft.rdft_matrices(fft, n_bins),
                    jdft.rdft_matrices(fft, n_bins)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10),
                                       (np.float32, 2e-3)])
def test_rdft_power_matches_jax(dtype, tol):
    """f64 to roundoff; f32 relative 2e-3 on the smallest bins of the
    random frames (the two sides sum 400 products in different orders)."""
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(5, 400)).astype(dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    got = dft.rdft_power(torch.from_numpy(frames), 400, 200, dtype=tdt)
    want = np.asarray(jdft.rdft_power(jnp.asarray(frames), 400, 200,
                                      dtype=jdt))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol,
                               atol=tol * float(want.max()) * 1e-3)


def test_rdft_against_torch_fft_f64():
    rng = np.random.default_rng(2)
    frames = torch.from_numpy(rng.normal(size=(4, 512)))
    spec = torch.fft.rfft(frames, dim=-1)[..., :256]
    re, im = dft.rfft_via_matmul(frames, 512, 256, dtype=torch.float64)
    np.testing.assert_allclose(re.numpy(), spec.real.numpy(), atol=1e-10)
    np.testing.assert_allclose(im.numpy(), spec.imag.numpy(), atol=1e-10)
    power = dft.rdft_power(frames, 512, 256, dtype=torch.float64)
    np.testing.assert_allclose(power.numpy(), (spec.abs() ** 2).numpy(),
                               rtol=1e-10)


def _sweep():
    return np.logspace(-38, 38, 20001, dtype=np.float64).astype(np.float32)


@pytest.mark.parametrize("name", ["log10_accurate", "ln_accurate"])
def test_accurate_logs_match_jax_within_one_ulp(name):
    x = _sweep()
    got = getattr(fastmath, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jfm, name)(jnp.asarray(x)))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("name,exact", [("log10_best", torch.log10),
                                        ("ln_best", torch.log)])
def test_best_logs_defer_to_torch_beyond_f32(name, exact):
    x = torch.from_numpy(_sweep().astype(np.float64))
    np.testing.assert_array_equal(
        getattr(fastmath, name)(x, torch.float64).numpy(), exact(x).numpy())


def test_kernel_log_constants_match_fastmath():
    """csrc/sig_common.cuh (the device code of K1 and K2) carries
    log10_accurate's and ln_accurate's constants as hex literals; they
    must be the Python float32 values bit for bit."""
    src = (Path(fastmath.__file__).resolve().parents[1] / "csrc"
           / "sig_common.cuh").read_text()
    lit = dict(re.findall(r"constexpr float (k\w+) = (0x[0-9a-fp.+-]+)f;",
                          src))
    c7, c5, c3, c1 = fastmath.series_coefficients(float(fastmath._INV_LN10))
    l7, l5, l3, l1 = fastmath.series_coefficients(1.0)
    want = {"kLog10Of2": fastmath._LOG10_2, "kC7": c7, "kC5": c5,
            "kC3": c3, "kC1": c1, "kLn2": fastmath._LN2, "kLnC7": l7,
            "kLnC5": l5, "kLnC3": l3, "kLnC1": l1}
    for k, v in want.items():
        assert np.float32(float.fromhex(lit[k])) == v, k
    e_round = re.search(r"constexpr int kERound = (0x[0-9A-Fa-f]+);", src)
    assert int(e_round.group(1), 16) == fastmath._E_ROUND == int(jfm._E_ROUND)
