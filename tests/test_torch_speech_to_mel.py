"""The port's ``SpeechToMel`` service object on the CPU: every case of
``tests/test_speech_to_mel.py``, and its records over JFK against the JAX
package's.

Bars. At float64 the records equal JAX's (measured: min / max identical,
0 u8 entries apart). At float32 (the default) the record's ``max`` lies
within 1e-5 of JAX's (measured 9.5e-7), the u8 entries at most one step
apart on at most 0.1% of entries (measured 43 of 87,840), the VAD
decisions equal. The record's ``min`` is the quietest mel bin of a frame
(log10 energy near -10), where float32 rounding of the DFT dominates the
energy: there each package is held to its float64 run (port measured
1.25e-3, JAX 3.80e-3 on JFK), the port at 2e-3, and the two packages to
each other within the sum of their floors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.streaming.speech_to_mel import SpeechToMel as JaxSpeechToMel
from melspec_tpu_torch.ops.quant import QuantizationRange, dequantize
from melspec_tpu_torch.streaming.speech_to_mel import SpeechToMel

CPU = "cpu"


def test_result_shape_and_cadence():
    stm = SpeechToMel(fft_size=400, hop_size=160, sampling_rate=16000.0,
                      n_mels=80, device=CPU)
    rng = np.random.default_rng(0)
    assert stm.add(rng.normal(size=100).astype(np.float32) * 0.3) == \
        {"ok": False}
    emitted = []
    for _ in range(40):
        out = stm.add(rng.normal(size=160).astype(np.float32) * 0.3)
        if out["ok"]:
            emitted.append(out)
    assert emitted, "window never filled"
    first = emitted[0]
    assert first["frame"].dtype == np.uint8 and first["frame"].shape == (80,)
    assert first["min"] < first["max"]
    assert isinstance(first["ms"], int)
    idxs = [e["idx"] for e in emitted]
    assert idxs == list(range(idxs[0], idxs[0] + len(idxs)))
    assert any("va" in e for e in emitted)


def test_quantized_frame_is_unnormalized_log_mel(jfk_samples):
    """The emitted frame quantizes the raw log10 mel (values in [-10, ~2];
    the normalized mel would lie in [-1.5, ~1.5])."""
    stm = SpeechToMel(device=CPU)
    outs = [o for o in (stm.add(jfk_samples[off : off + 160])
                        for off in range(0, 16000, 160)) if o["ok"]]
    frame = outs[0]
    log_mel = dequantize(frame["frame"],
                         QuantizationRange(frame["min"], frame["max"]))
    assert log_mel.min() <= -4.0


def test_get_flush():
    assert SpeechToMel(device=CPU).get() == {"ok": False}


def test_pending_backlog_drains_with_vad_continuity():
    """A large push buffers beyond one hop; ``pending`` exposes the backlog
    and ``get()`` drains it while still feeding the VAD."""
    s = SpeechToMel(device=CPU)
    rng = np.random.default_rng(0)
    s.add(rng.normal(size=4096).astype(np.float32) * 0.3)
    assert s.pending == 4096 // 160 - 1
    emitted = 1
    while s.pending:
        s.get()
        emitted += 1
    assert s.pending == 0
    assert emitted == 4096 // 160
    assert s._vad._frame_index == max(0, s._idx - 400 // 160)


def test_vad_false_skips_the_vad():
    """``vad=False`` returns the same frame and no decision, and feeds the
    detector nothing."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=160 * 8).astype(np.float32) * 0.3
    a, b = SpeechToMel(device=CPU), SpeechToMel(device=CPU)
    for off in range(0, x.size, 160):
        ra = a.add(x[off : off + 160], vad=False)
        rb = b.add(x[off : off + 160])
        assert "va" not in ra
        if ra["ok"]:
            np.testing.assert_array_equal(ra["frame"], rb["frame"])
    assert a._vad._frame_index == 0 and b._vad._frame_index > 0


def _records(stm, samples):
    return [stm.add(samples[off : off + 160])
            for off in range(0, len(samples), 160)]


def _held(port, ref):
    """Equal cadence and VAD; returns (max |min|, max |max|, u8 entries
    apart, largest u8 step, entries)."""
    assert len(port) == len(ref)
    d_min = d_max = 0.0
    apart = step = total = 0
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        assert a["ok"] == b["ok"]
        if not a["ok"]:
            continue
        assert (a["idx"], a["ms"], a["len"]) == (b["idx"], b["ms"], b["len"])
        assert a.get("va") == b.get("va")
        d_min = max(d_min, abs(a["min"] - b["min"]))
        d_max = max(d_max, abs(a["max"] - b["max"]))
        d = np.abs(a["frame"].astype(int) - b["frame"].astype(int))
        apart += int((d > 0).sum())
        step = max(step, int(d.max()))
        total += d.size
    return d_min, d_max, apart, step, total


@pytest.mark.parametrize("n_mels", [80, 128])
def test_records_match_jax_float64(jfk_samples, n_mels):
    port = _records(SpeechToMel(n_mels=n_mels, dtype=torch.float64,
                                device=CPU), jfk_samples)
    ref = _records(JaxSpeechToMel(n_mels=n_mels, dtype=jnp.float64),
                   jfk_samples)
    d_min, d_max, apart, step, total = _held(port, ref)
    assert sum(r["ok"] for r in port) == 1098
    assert d_min <= 1e-5 and d_max <= 1e-5
    assert step <= 1 and apart <= total // 10000


def test_records_match_jax_float32(jfk_samples):
    port = _records(SpeechToMel(device=CPU), jfk_samples)
    ref = _records(JaxSpeechToMel(), jfk_samples)
    d_min, d_max, apart, step, total = _held(port, ref)
    assert d_max <= 1e-5
    assert step <= 1 and apart <= total // 1000
    port64 = _records(SpeechToMel(dtype=torch.float64, device=CPU),
                      jfk_samples)
    ref64 = _records(JaxSpeechToMel(dtype=jnp.float64), jfk_samples)
    port_floor = _held(port, port64)[0]
    jax_floor = _held(ref, ref64)[0]
    assert port_floor <= 2e-3, port_floor
    assert d_min <= port_floor + jax_floor + 1e-5
