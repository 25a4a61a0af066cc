"""The composite frontend step, port vs the JAX step on a one-device mesh
(tests/test_sharding.py's contract) on the same numpy inputs: the eight
keys with their shapes and dtypes, mel within 2e-5, NeMo and fbank within
2e-4, the smoothed VAD and its aggregates within one column, the u8 block
bit for bit the port's own quantizer and within one step of JAX's, the
``valid`` contract, and the per-frontend route."""

import jax
import numpy as np
import pytest
import torch

from melspec_tpu.config import DetectionSettings as JSettings
from melspec_tpu.config import FbankConfig as JFbankConfig
from melspec_tpu.config import MelConfig as JMelConfig
from melspec_tpu.parallel import make_mesh
from melspec_tpu.parallel import sharded_frontend_step as jax_step
from melspec_tpu_torch.config import DetectionSettings, FbankConfig, MelConfig
from melspec_tpu_torch.kernels import sig_mel, sig_multi
from melspec_tpu_torch.ops import sig_multihead
from melspec_tpu_torch.ops.quant import quantize_tensor
from melspec_tpu_torch.parallel import sharding

SETTINGS = dict(min_energy=0.5, min_y=2, min_x=5, min_mel=0)
KEYS = ("mel", "nemo", "fbank", "vad_smoothed", "vad_active_columns",
        "vad_total_columns", "mel_q8", "mel_q8_range")
BARS = {"mel": 2e-5, "nemo": 2e-4, "fbank": 2e-4, "mel_q8_range": 2e-5}
UNFUSED = dict(mel_config=(512, 160, 128),
               fbank_config=dict(frame_length_ms=20.0, frame_shift_ms=10.0,
                                 apply_cmn=False))


def _batch(seed, b=3, t=16000 + 37):
    return (np.random.default_rng(seed).normal(size=(b, t)) * 0.3).astype(
        np.float32)


def _steps(route):
    kw = {}
    jkw = {}
    if route == "unfused":
        kw = dict(mel_config=MelConfig(*UNFUSED["mel_config"]),
                  fbank_config=FbankConfig(**UNFUSED["fbank_config"]))
        jkw = dict(mel_config=JMelConfig(*UNFUSED["mel_config"]),
                   fbank_config=JFbankConfig(**UNFUSED["fbank_config"]))
    port = sharding.sharded_frontend_step(
        settings=DetectionSettings(**SETTINGS), device="cpu", **kw)
    ref = jax_step(make_mesh(jax.devices()[:1]), JSettings(**SETTINGS),
                   **jkw)
    return port, ref


@pytest.fixture(scope="module")
def runs():
    out = {}
    for route in ("fused", "unfused"):
        port, ref = _steps(route)
        x = _batch(1)
        got = port(x)
        want = {k: np.asarray(v) for k, v in ref(x).items()}
        out[route] = (got, want, port, ref)
    return out


@pytest.mark.parametrize("route", ["fused", "unfused"])
@pytest.mark.parametrize("key", KEYS)
def test_outputs_match_jax(runs, route, key):
    got, want, _, _ = runs[route]
    assert set(got) == set(KEYS) == set(want)
    g, w = got[key].numpy(), want[key]
    assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
    if key in BARS:
        assert np.abs(g - w).max() <= BARS[key]
    elif key == "vad_smoothed":
        assert int((g != w).sum()) <= 1
    elif key in ("vad_active_columns", "vad_total_columns"):
        assert abs(int(g) - int(w)) <= 1
    else:  # mel_q8: the port's quantizer on the port's mel, bit for bit
        q, lo, hi = quantize_tensor(got["mel"])
        assert torch.equal(got["mel_q8"], q)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        assert torch.equal(got["mel_q8_range"][0],
                           torch.stack([lo, hi]))


def test_fused_route_taken_where_jax_takes_it(runs):
    assert runs["fused"][0]["mel"].shape[1] == (16037 - 400) // 160 + 1
    assert runs["unfused"][0]["mel"].shape == (3, (16037 - 512) // 160 + 1,
                                               128)
    total = int(runs["fused"][0]["vad_total_columns"])
    assert total == 3 * (runs["fused"][0]["mel"].shape[1] - 2)


def test_cpu_step_launches_no_kernel(runs):
    port = runs["fused"][2]
    before = (sig_mel.launches, sig_multi.launches)
    port(_batch(2, b=1, t=4000))
    assert (sig_mel.launches, sig_multi.launches) == before


@pytest.mark.parametrize("valid", [
    np.asarray([16037, 8000, 0], np.int32),
    np.asarray([True, False, True]),
    np.asarray([0, 0, 0], np.int32),
    np.asarray([400, 401, 16037], np.int64),
], ids=["counts", "bool", "all_zero", "edge_counts"])
def test_valid_contract_matches_jax(runs, valid):
    _, _, port, ref = runs["fused"]
    x = _batch(3)
    got = port(x, valid)
    want = ref(x, valid)
    for key in ("vad_active_columns", "vad_total_columns"):
        assert abs(int(got[key]) - int(want[key])) <= 1
    assert int(got["vad_total_columns"]) == int(want["vad_total_columns"])


def test_valid_rejects_01_integer_mask_but_not_tensors(runs):
    _, _, port, _ = runs["fused"]
    x = np.zeros((2, 8000), np.float32)
    with pytest.raises(ValueError, match="bool"):
        port(x, np.asarray([1, 0], np.int32))
    assert int(port(x, np.asarray([0, 0], np.int32))
               ["vad_total_columns"]) == 0
    # tensors skip the host-side check, as JAX's device arrays do
    out = port(x, torch.tensor([1, 0], dtype=torch.int32))
    assert int(out["vad_total_columns"]) == 0
    assert int(port(x, torch.tensor([True, False]))
               ["vad_total_columns"]) == (8000 - 400) // 160 + 1 - 2


def test_constant_input_quantizes_to_zero(runs):
    _, _, port, _ = runs["fused"]
    out = port(np.zeros((2, 8000), np.float32))
    assert int(out["mel_q8"].max()) == 0


K8 = dict(mel_config=MelConfig(200, 80, 80, 8000.0),
          fbank_config=FbankConfig(sample_rate=8000.0))


@pytest.mark.parametrize("configs", [{}, K8], ids=["16k", "8k"])
@pytest.mark.parametrize("fits", [True, False])
def test_cuda_route_follows_k2_accepts(monkeypatch, configs, fits):
    """On CUDA the step takes the fused route (one K2 launch) only where
    K2 takes the whisper and Kaldi heads (``sig_multi.k2_accepts``: their
    widths, here 512 at 16 kHz and 256 at 8 kHz, and K2's shared-memory
    figure, stubbed: it comes from the built kernel); elsewhere the
    per-frontend routes, with no exception, as JAX falls back. The fused
    constructors raise ``ValueError`` there. On the CPU the plain version
    takes any heads."""
    smem = 100_000 if fits else sig_mel.MAX_SMEM_BYTES + 1
    calls = []

    def stub(*args):
        calls.append(args)
        return smem, 11_000

    monkeypatch.setattr(sig_multi, "_smem_bytes", stub)
    mc = configs.get("mel_config", MelConfig())
    fc = configs.get("fbank_config", FbankConfig())
    cuda = torch.device("cuda")  # passed as a value: nothing runs on it
    assert sharding.frontend_route(mc, fc, cuda) == \
        ("fused" if fits else "per_frontend")
    assert calls
    assert sharding.frontend_route(mc, fc, torch.device("cpu")) == "fused"
    monkeypatch.setattr(sig_multihead, "resolve_device", lambda d=None: cuda)
    if not fits:
        for cls in (sig_multihead.WhisperKaldiFused,
                    sig_multihead.WhisperKaldiNemoFused):
            with pytest.raises(ValueError, match="K2"):
                cls(mc, fc)


def test_more_than_one_rank_raises(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="item 20"):
        sharding.sharded_frontend_step(device="cpu")
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    assert callable(sharding.sharded_frontend_step(device="cpu"))
