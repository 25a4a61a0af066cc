"""The port's serving tick against the JAX package: ``MultiStreamMel`` on
rdft and sig, ``MultiStreamFrontend`` and ``SourceRateFrontend`` at 48 kHz
and 8 kHz, each ticked from the same state (the JAX fleet's, carried over
through ``convert``) on the same numpy chunks.

Bars: valid flags exact; mels, lo and hi <= 2e-5 (the f32 floor of two
summation orders, PERF.md); q within one quantization step; at most one
VAD decision flip per test (JAX's own budget for two separately computed
mels, ``tests/test_serving.py``). At 8 kHz a frame's minimum (lo) lies in
the anti-alias filter's stopband, above 4 kHz, where the two packages'
float32 resamplers differ by more than that floor: there each package is
held against a float64 witness (float64 ``resample_poly`` into a float64
rdft frontend) at ``STOPBAND_BAR``, and the two against each other at
twice that bar, the distance the triangle inequality allows.
"""

import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu.streaming import multistream as jms
from melspec_tpu.streaming import serving as jserving
import melspec_tpu_torch as mt
from melspec_tpu_torch.config import DetectionSettings, MelConfig
from melspec_tpu_torch.convert import (from_jax_frontend_state,
                                       from_jax_source_rate_state)
from melspec_tpu_torch.kernels import resample as kres
from melspec_tpu_torch.kernels import sig_mel
from melspec_tpu_torch.ops.resample import resample_poly
from melspec_tpu_torch.streaming.multistream import (MultiStreamMel,
                                                     MultiStreamState)
from melspec_tpu_torch.streaming.state_io import load_stream_state
from melspec_tpu_torch.streaming.serving import (MultiStreamFrontend,
                                                 SourceRateFrontend,
                                                 calibrate_fft_impl,
                                                 shared_frontend)
from melspec_tpu_torch.utils.instances import shared_instance_count

CPU = "cpu"
CFG = MelConfig(400, 160, 80, 16000.0)
JCFG = jconfig.MelConfig(400, 160, 80, 16000.0)
SET = DetectionSettings(min_energy=0.5, min_y=3, min_x=5)
JSET = jconfig.DetectionSettings(min_energy=0.5, min_y=3, min_x=5)


def _chunks(rng, s, h, width):
    return (rng.normal(size=(s, h, width)) * 0.3).astype(np.float32)


# lo at 8 kHz against the float64 witness, per resample precision
# (test_8k_stopband_minimum_against_float64). Measured on the CPU over four
# seeds: "highest" within 4.3e-5 for both packages, "bf3" within 1.35e-3.
STOPBAND_BAR = {"highest": 6e-5, "bf3": 2e-3}
# Port against JAX at 8 kHz in "highest": each package lies within
# STOPBAND_F64 of the float64 witness (4.3e-5 measured, above), so the two
# lie within twice that of each other. Measured over eight seeds of
# test_source_rate_frontend_matches_jax's ticks: lo up to 2.73e-5 (kernel
# route) and 1.93e-5 (auto), hi up to 2.4e-7; at 48 kHz lo up to 2.3e-6.
STOPBAND_F64 = 4.5e-5


class _Records:
    """Compares tick outputs against JAX's and counts VAD flips. ``lo_bar``
    bounds the frame minima: the f32 floor where they lie in the passband,
    twice ``STOPBAND_F64`` where they lie in the resampler's stopband."""

    def __init__(self, lo_bar: float = 2e-5):
        self.checked = 0
        self.flips = 0
        self.lo_bar = lo_bar

    def check(self, got, want):
        q, lo, hi, va, valid = got
        jq, jlo, jhi, jva, jvalid = (np.asarray(a) for a in want)
        assert q.dtype == np.uint8 and q.shape == jq.shape
        np.testing.assert_array_equal(valid, jvalid)
        v = valid
        assert np.abs(lo[v] - jlo[v]).max(initial=0) <= self.lo_bar
        assert np.abs(hi[v] - jhi[v]).max(initial=0) <= 2e-5
        assert np.abs(q[v].astype(int) - jq[v].astype(int)).max(
            initial=0) <= 1
        assert not va[~v].any()
        self.checked += int(v.sum())
        self.flips += int((va[v] != jva[v]).sum())

    def done(self, min_checked):
        assert self.checked >= min_checked, self.checked
        assert self.flips <= 1, (self.flips, self.checked)


@pytest.mark.parametrize("fft_impl", ["rdft", "sig"])
def test_multistream_mel_matches_jax(fft_impl):
    s = 3
    port = MultiStreamMel(CFG, s, fft_impl=fft_impl, device=CPU)
    ref = jms.MultiStreamMel(JCFG, s, fft_impl=fft_impl)
    rng = np.random.default_rng(1)
    jst = ref.push_many(ref.init(), _chunks(rng, s, 2, 160))[0]
    pst = MultiStreamState(torch.tensor(np.asarray(jst.hop_buf)),
                           torch.tensor(np.asarray(jst.idx)))
    checked = 0
    for t, h in enumerate([3, 1, 5]):
        x = _chunks(rng, s, h, 160)
        if t == 2:
            x = x.reshape(s, h * 160)  # the flat layout
        active = np.asarray([True, t != 1, True])
        pst, mels, valid = port.push_many(pst, x, active)
        jst, jmels, jvalid = ref.push_many(jst, x, active)
        np.testing.assert_array_equal(valid, jvalid)
        assert mels.shape == (s, h, 80)
        assert np.abs(mels[valid] - jmels[valid]).max() <= 2e-5
        np.testing.assert_array_equal(pst.hop_buf.numpy(),
                                      np.asarray(jst.hop_buf))
        np.testing.assert_array_equal(pst.idx.numpy(), np.asarray(jst.idx))
        checked += int(valid.sum())
    assert checked >= 20 and pst.idx.dtype == torch.int32


def test_multistream_mel_step_scan_and_bulk_agree():
    """push (one hop) matches JAX; bulk and per-hop scan agree to 1e-12
    in float64; reset re-zeroes the masked stream."""
    s = 2
    rng = np.random.default_rng(2)
    port = MultiStreamMel(CFG, s, device=CPU)
    ref = jms.MultiStreamMel(JCFG, s)
    pst, jst = port.init(), ref.init()
    for _ in range(4):
        x = _chunks(rng, s, 1, 160)[:, 0]
        pst, mels, valid = port.push(pst, x)
        jst, jmels, jvalid = ref.push(jst, x)
        np.testing.assert_array_equal(valid, jvalid)
        assert np.abs(mels[valid] - jmels[valid]).max(initial=0) <= 2e-5
    f64 = MultiStreamMel(CFG, s, dtype=torch.float64, device=CPU)
    x = _chunks(rng, s, 7, 160).astype(np.float64)
    a = f64.push_many(f64.init(), x)
    b = f64.push_many(f64.init(), x, scan=True)
    np.testing.assert_array_equal(a[2], b[2])
    assert np.abs(a[1] - b[1]).max() <= 1e-12
    st = f64.reset(a[0], np.asarray([True, False]))
    assert st.idx.tolist() == [0, 400] and not st.hop_buf[0].any()
    empty = port.push_many(pst, np.zeros((s, 0, 160), np.float32))
    assert empty[1].shape == (s, 0, 80) and empty[2].shape == (s, 0)


def test_multistream_mel_refusals():
    sig = MultiStreamMel(CFG, 2, fft_impl="sig", device=CPU)
    with pytest.raises(NotImplementedError, match="bulk path"):
        sig.push(sig.init(), np.zeros((2, 160), np.float32))
    with pytest.raises(NotImplementedError, match="bulk path"):
        sig.push_many(sig.init(), np.zeros((2, 3, 160), np.float32),
                      scan=True)
    bf3 = MultiStreamMel(CFG, 2, fft_impl="bf3", device=CPU)
    ref = jms.MultiStreamMel(JCFG, 2, fft_impl="bf3")
    x = np.random.default_rng(24).normal(size=(2, 5, 160)).astype(
        np.float32) * 0.2
    got, want = (m.push_many(m.init(), x) for m in (bf3, ref))
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    assert np.abs(got[1] - np.asarray(want[1])).max() <= 2e-5
    with pytest.raises(ValueError, match="fft_impl must be"):
        MultiStreamMel(CFG, 2, fft_impl="fft", device=CPU)
    with pytest.raises(ValueError, match="float32-only"):
        MultiStreamMel(CFG, 2, fft_impl="sig", dtype=torch.float64,
                       device=CPU)
    port = MultiStreamMel(CFG, 2, device=CPU)
    with pytest.raises(ValueError, match="chunks must be"):
        port.push_many(port.init(), np.zeros((2, 2, 100), np.float32))
    with pytest.raises(ValueError, match=r"chunks must be \[n_streams, hop"):
        port.push(port.init(), np.zeros((2, 100), np.float32))


@pytest.mark.parametrize("fft_impl,record_norm", [
    ("rdft", "whisper"), ("rdft", "log10"), ("sig", "whisper"),
    ("bf3", "log10"), ("bf3", "whisper")])
def test_frontend_matches_jax(fft_impl, record_norm):
    s = 4
    port = MultiStreamFrontend(CFG, s, settings=SET, fft_impl=fft_impl,
                               record_norm=record_norm, device=CPU)
    ref = jserving.MultiStreamFrontend(JCFG, s, settings=JSET,
                                       fft_impl=fft_impl,
                                       record_norm=record_norm)
    rng = np.random.default_rng(3)
    jst = ref.push_many(ref.init(), _chunks(rng, s, 3, 160))[0]
    pst = from_jax_frontend_state(jst, device=CPU)
    rec = _Records()
    for t, h in enumerate([4, 2, 6, 3]):
        x = _chunks(rng, s, h, 160)
        active = np.ones(s, bool)
        active[t % s] = t % 2 == 0
        pst, *got = port.push_many(pst, x, active)
        jst, *want = ref.push_many(jst, x, active)
        rec.check(got, want)
        np.testing.assert_array_equal(pst.vad.count.numpy(),
                                      np.asarray(jst.vad.count))
        if t == 1:
            mask = np.asarray([False, True, False, False])
            pst, jst = port.reset(pst, mask), ref.reset(jst, mask)
            assert pst.mel.idx[1] == 0 and pst.vad.count[1] == 0
    rec.done(40)


@pytest.mark.parametrize("rate,impl,s,hops", [
    (48000, "auto", 3, 4), (8000, "auto", 2, 4),
    (48000, "kernel", 8, 4), (8000, "kernel", 8, 8)])
def test_source_rate_frontend_matches_jax(rate, impl, s, hops):
    """On the CPU 'auto' is the conv route in both packages; 'kernel' is
    JAX's Pallas kernels (interpret mode, which needs S % 8 == 0 and a
    128-multiple window count) against the port's plain K3/K4, both at
    the port's default resample precision, "highest"."""
    port = SourceRateFrontend(CFG, s, input_rate=rate, settings=SET,
                              resample_impl=impl, device=CPU)
    assert port.rs.precision == "highest"
    ref = jserving.SourceRateFrontend(JCFG, s, input_rate=rate,
                                      settings=JSET, resample_impl=impl,
                                      resample_precision="highest")
    assert port.hop_src == ref.hop_src
    assert (port.rs._len, port.rs.spurious_out) == (ref.rs._len,
                                                    ref.rs.spurious_out)
    rng = np.random.default_rng(rate // 1000 + s)
    jst = ref.init()
    for _ in range(2):
        jst = ref.push_many(jst, _chunks(rng, s, hops, ref.hop_src))[0]
    pst = from_jax_source_rate_state(jst, device=CPU)
    rec = _Records(2 * STOPBAND_F64 if rate == 8000 else 2e-5)
    for t in range(3):
        x = _chunks(rng, s, hops, ref.hop_src)
        active = np.ones(s, bool)
        active[0] = t != 1
        pst, *got = port.push_many(pst, x, active)
        jst, *want = ref.push_many(jst, x, active)
        rec.check(got, want)
        np.testing.assert_array_equal(pst.fe.mel.idx.numpy(),
                                      np.asarray(jst.fe.mel.idx))
        np.testing.assert_array_equal(pst.rs.buf.numpy(),
                                      np.asarray(jst.rs.buf))
    rec.done(3 * s * hops - hops - 2)


@pytest.mark.parametrize("precision", ["highest", "bf3"])
def test_8k_stopband_minimum_against_float64(precision):
    """lo at 8 kHz (a stopband bin) from the port's plain K4 and from
    JAX's kernel (interpret mode), each against a float64 witness:
    float64 ``resample_poly`` of the same stream into a float64 rdft
    frontend, ``spurious_out / hop`` hops earlier. Measured (CPU, four
    seeds): "highest" within 4.3e-5 for both packages, "bf3" within
    1.35e-3 for both; the port and JAX agree to 1.9e-5 and 7.6e-5."""
    s, hops = 8, 8
    port = SourceRateFrontend(CFG, s, input_rate=8000, settings=SET,
                              resample_impl="kernel",
                              resample_precision=precision, device=CPU)
    ref = jserving.SourceRateFrontend(JCFG, s, input_rate=8000,
                                      settings=JSET, resample_impl="kernel",
                                      resample_precision=precision)
    rng = np.random.default_rng(11)
    xs = [_chunks(rng, s, hops, 80) for _ in range(5)]
    jst = ref.init()
    for x in xs[:2]:
        jst = ref.push_many(jst, x)[0]
    pst = from_jax_source_rate_state(jst, device=CPU)
    lo, jlo, valid = [], [], []
    for x in xs[2:]:
        pst, _, plo, _, _, v = port.push_many(pst, x)
        jst, _, l, _, _, _ = ref.push_many(jst, x)
        lo.append(plo), jlo.append(np.asarray(l)), valid.append(v)
    lo, jlo, valid = (np.concatenate(a, axis=1) for a in (lo, jlo, valid))
    wit = MultiStreamFrontend(CFG, s, settings=SET, dtype=torch.float64,
                              device=CPU)
    y = resample_poly(np.concatenate([x.reshape(s, -1) for x in xs], axis=1
                                     ).astype(np.float64), 2, 1, device=CPU)
    wlo = wit.push_many(wit.init(), y.numpy())[2]
    spur = port.rs.spurious_out // CFG.hop_size
    wlo = wlo[:, 2 * hops - spur: 5 * hops - spur]
    assert valid.all() and lo.shape == wlo.shape
    assert np.abs(lo - wlo).max() <= STOPBAND_BAR[precision]
    assert np.abs(jlo - wlo).max() <= STOPBAND_BAR[precision]


@pytest.mark.parametrize("rate,n_streams", [(48000, 3), (8000, 2)])
def test_source_rate_frame_grid_matches_host_resampled(rate, n_streams):
    """Every VALID frame of the source-rate tick is the frame a plain
    frontend fed ``resample_poly`` audio gives ``spurious_out / hop``
    hops earlier: exact validity, q within one step, at most one VAD
    flip; a reset slot restarts its full warm-up."""
    s, hops, ticks = n_streams, 4, 6
    src = SourceRateFrontend(CFG, s, input_rate=rate, settings=SET,
                             device=CPU)
    plain = MultiStreamFrontend(CFG, s, settings=SET, device=CPU)
    spur = src.rs.spurious_out // CFG.hop_size
    assert spur >= 1
    up, down = 16000 // np.gcd(16000, rate), rate // np.gcd(16000, rate)
    rng = np.random.default_rng(rate)
    xs = (rng.normal(size=(s, ticks * hops * src.hop_src)) * 0.3).astype(
        np.float32)
    y16 = resample_poly(xs.astype(np.float64), up, down,
                        device=CPU).numpy().astype(np.float32)
    sst, pst = src.init(), plain.init()
    got, want = [], []
    for t in range(ticks):
        sst, *o = src.push_many(sst, xs[:, t * hops * src.hop_src:
                                        (t + 1) * hops * src.hop_src])
        got.append(o)
        pst, *o = plain.push_many(pst, y16[:, t * hops * 160:
                                           (t + 1) * hops * 160])
        want.append(o)
    gq, _, _, gva, gvalid = (np.concatenate(a, axis=1) for a in zip(*got))
    pq, _, _, pva, pvalid = (np.concatenate(a, axis=1) for a in zip(*want))
    n = ticks * hops
    assert not gvalid[:, :spur].any()
    np.testing.assert_array_equal(gvalid[:, spur:], pvalid[:, :n - spur])
    v = gvalid[:, spur:]
    assert np.abs(gq[:, spur:][v].astype(int)
                  - pq[:, :n - spur][v].astype(int)).max() <= 1
    assert (gva[:, spur:][v] != pva[:, :n - spur][v]).sum() <= 1
    assert v.sum() >= 20
    sst = src.reset(sst, np.asarray([True] + [False] * (s - 1)))
    sst, *o = src.push_many(sst, xs[:, :hops * src.hop_src])
    assert not o[-1][0, :spur + 1].any() and o[-1][1].all()


def test_validation_messages_match_jax():
    def msg(fn):
        with pytest.raises(ValueError) as e:
            fn()
        return str(e.value)

    port = MultiStreamFrontend(CFG, 4, device=CPU)
    ref = jserving.MultiStreamFrontend(JCFG, 4)
    for bad in (np.zeros((3, 2, 160), np.float32),
                np.zeros((4, 2, 100), np.float32)):
        assert (msg(lambda: port.push_many(port.init(), bad))
                == msg(lambda: ref.push_many(ref.init(), bad)))
    for kw in (dict(record_norm="nope"),
               dict(fft_impl="sig", record_norm="log10")):
        assert (msg(lambda: MultiStreamFrontend(CFG, 2, device=CPU, **kw))
                == msg(lambda: jserving.MultiStreamFrontend(JCFG, 2, **kw)))
    for rate in (22050, 16000):
        assert (msg(lambda: SourceRateFrontend(CFG, 2, input_rate=rate,
                                               device=CPU))
                == msg(lambda: jserving.SourceRateFrontend(
                    JCFG, 2, input_rate=rate)))
    src = SourceRateFrontend(CFG, 2, device=CPU)
    jsrc = jserving.SourceRateFrontend(JCFG, 2)
    bad = np.zeros((2, 2, 160), np.float32)
    assert (msg(lambda: src.push_many(src.init(), bad))
            == msg(lambda: jsrc.push_many(jsrc.init(), bad)))
    empty = src.push_many(src.init(), np.zeros((2, 0, 480), np.float32))
    assert empty[1].shape == (2, 0, 80) and empty[4].shape == (2, 0)


def test_state_io_round_trip(tmp_path):
    """A checkpointed fleet resumes bit-identically; wrong fleet size,
    structure and config are refused."""
    rng = np.random.default_rng(5)
    src = SourceRateFrontend(CFG, 3, settings=SET, device=CPU)
    st = src.push_many(src.init(), _chunks(rng, 3, 4, 480))[0]
    src.save_state(tmp_path / "fleet", st)
    back = src.load_state(tmp_path / "fleet")
    assert all(torch.equal(a, b) for a, b in zip(
        [back.rs.buf, back.fe.mel.hop_buf, back.fe.mel.idx,
         back.fe.vad.hist, back.fe.vad.count],
        [st.rs.buf, st.fe.mel.hop_buf, st.fe.mel.idx, st.fe.vad.hist,
         st.fe.vad.count]))
    x = _chunks(rng, 3, 4, 480)
    a, b = src.push_many(st, x)[1:], src.push_many(back, x)[1:]
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    front = MultiStreamFrontend(CFG, 3, settings=SET, device=CPU)
    fst = front.push_many(front.init(), _chunks(rng, 3, 4, 160))[0]
    front.save_state(tmp_path / "plain.npz", fst)
    with pytest.raises(ValueError, match="structure mismatch"):
        src.load_state(tmp_path / "plain.npz")
    with pytest.raises(ValueError, match="leaf 0"):
        load_stream_state(tmp_path / "plain.npz", like=MultiStreamFrontend(
            CFG, 4, settings=SET, device=CPU).init())
    with pytest.raises(ValueError, match="config mismatch"):
        MultiStreamFrontend(CFG, 3, device=CPU).load_state(
            tmp_path / "plain.npz")
    (tmp_path / "junk.npz").write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="corrupt"):
        front.load_state(tmp_path / "junk.npz")


def test_convert_carries_jax_state():
    ref = jserving.SourceRateFrontend(JCFG, 2, input_rate=8000,
                                      settings=JSET)
    rng = np.random.default_rng(6)
    jst = ref.push_many(ref.init(), _chunks(rng, 2, 4, 80))[0]
    st = from_jax_source_rate_state(jst, device=CPU)
    pairs = [(st.rs.buf, jst.rs.buf), (st.fe.mel.hop_buf, jst.fe.mel.hop_buf),
             (st.fe.mel.idx, jst.fe.mel.idx), (st.fe.vad.hist, jst.fe.vad.hist),
             (st.fe.vad.count, jst.fe.vad.count)]
    for a, b in pairs:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.fe.mel.idx.dtype == st.fe.vad.count.dtype == torch.int32


def test_shared_frontend_and_calibration_on_cpu():
    a = shared_frontend(CFG, 4, SET, device=CPU)
    assert a is shared_frontend(CFG, 4, SET, device=torch.device(CPU))
    assert isinstance(a, MultiStreamFrontend)
    n = shared_instance_count()
    b = shared_frontend(CFG, 4, SET, input_rate=48000, device=CPU)
    assert isinstance(b, SourceRateFrontend)
    assert shared_instance_count() == n + 1
    assert shared_frontend(CFG, 4, SET, input_rate=16000, device=CPU) is a
    assert calibrate_fft_impl(CFG, 4, settings=SET, device=CPU) == "rdft"
    assert calibrate_fft_impl(CFG, 4, record_norm="log10",
                              device=CPU) == "rdft"


@pytest.mark.parametrize("cfg,fits,timed", [
    (MelConfig(), False, False),
    (MelConfig(600, 240, 80, 24000.0), True, False),
    (MelConfig(), True, True),
    (MelConfig(200, 80, 80, 8000.0), True, True)],
    ids=["smem", "width768", "16k", "8k"])
def test_calibrate_skips_sig_where_k1_refuses(monkeypatch, cfg, fits, timed):
    """On CUDA ``calibrate_fft_impl`` returns "rdft" before any timing
    where K1 refuses the config's head (``k1_accepts``: its shared-memory
    figure, stubbed here as it comes from the built kernel, or a width K1
    does not take), and times both routes where K1 takes it. The device
    and the timing are stand-ins: nothing runs on a card."""
    import melspec_tpu_torch.streaming.serving as serving

    class Timed(Exception):
        pass

    def timing(*args, **kw):
        raise Timed

    monkeypatch.setattr(serving, "resolve_device",
                        lambda d=None: torch.device("cuda"))
    monkeypatch.setattr(serving, "shared_frontend", timing)
    monkeypatch.setattr(sig_mel, "_smem_bytes", lambda *a: (
        100_000 if fits else sig_mel.MAX_SMEM_BYTES + 1))
    if timed:
        with pytest.raises(Timed):
            calibrate_fft_impl(cfg, 4, settings=SET, verbose=False)
    else:
        assert calibrate_fft_impl(cfg, 4, settings=SET,
                                  verbose=False) == "rdft"


def test_chunk_buffer_reuse_after_push_is_safe():
    """A serving loop refills its host buffer as soon as push_many
    returns; the pushed samples must already be on the device."""
    rng = np.random.default_rng(8)
    front = SourceRateFrontend(CFG, 2, settings=SET, device=CPU)
    buf = _chunks(rng, 2, 4, 480)
    keep = buf.copy()
    st = front.push_many(front.init(), buf)[0]
    buf[:] = 7.0
    want = front.push_many(front.init(), keep)[0]
    assert torch.equal(st.rs.buf, want.rs.buf)
    assert torch.equal(st.fe.mel.hop_buf, want.fe.mel.hop_buf)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [
    lambda: mt.MultiStreamMel(CFG, 2),
    lambda: mt.MultiStreamVad(SET, 2),
    lambda: mt.MultiStreamFrontend(CFG, 2),
    lambda: mt.SourceRateFrontend(CFG, 2),
    lambda: mt.MultiStreamResampler(1, 3, 2),
    lambda: mt.shared_frontend(CFG, 2, input_rate=48000),
    lambda: mt.resample_poly(np.zeros(300), 1, 3),
    lambda: mt.calibrate_fft_impl(CFG, 2),
], ids=["mel", "vad", "frontend", "source-rate", "resampler", "shared",
        "resample_poly", "calibrate"])
def test_default_device_raises_without_cuda(no_cuda, make):
    before = (sig_mel.launches, dict(kres.launches))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    assert (sig_mel.launches, dict(kres.launches)) == before


def test_cpu_serving_counts_no_launches():
    before = (sig_mel.launches, dict(kres.launches))
    front = SourceRateFrontend(CFG, 2, fft_impl="sig", resample_impl="kernel",
                               device=CPU)
    front.push_many(front.init(), np.zeros((2, 4, 480), np.float32))
    assert (sig_mel.launches, dict(kres.launches)) == before
