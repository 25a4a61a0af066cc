"""The port's example programs (``melspec_tpu_torch/examples/``) on the
CPU: every case of ``tests/test_examples.py`` on the port (the CLIs by
subprocess with ``--device cpu``, the TCP ``StreamServer`` in-process with
``device="cpu"``), each at the JAX test's bars; the port's server against
the JAX package's on the same PCM; the wire helpers byte-equal to JAX's;
and no program falling back to the CPU where CUDA is asked for and
absent.

Cross-package bars (``tests/test_torch_serving.py``'s): the record count
per client and every ``frame_idx`` exact; the record minima and maxima
within 2e-5; the u8 payload within one quantization step; at most one
VAD flip per test.
"""

import importlib.util
import re
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.config import MelConfig
from melspec_tpu_torch.examples import (live_pipeline, mel_tga,
                                        serve_streams as serve,
                                        stream_asr_segments, tga_to_asr,
                                        vad_ten_eval, waterfall)
from melspec_tpu_torch.examples.browser import server as bridge_server
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops import framing
from melspec_tpu_torch.ops.quant import QuantizationRange, dequantize
from melspec_tpu_torch.ops.resample import (resample_output_len,
                                            resample_poly)
from melspec_tpu_torch.ops.spectrogram import compute_streaming_mel
from melspec_tpu_torch.streaming.serving import calibrate_fft_impl

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "testdata"
CPU = "cpu"
NO_CUDA = "CUDA is not available"


def run(args, timeout=600, **kw):
    return subprocess.run(
        [sys.executable, "-m"] + args, cwd=REPO, capture_output=True,
        text=True, timeout=timeout, **kw)


def jfk():
    return read_wav_f32le(REF / "jfk_f32le.wav")


def rs(x, up, down):
    """Offline float32 resample on the CPU, as numpy."""
    return resample_poly(np.asarray(x, np.float32), up, down,
                         device=CPU).numpy().astype(np.float32)


def dequant(recs):
    return np.stack([dequantize(r[4], QuantizationRange(r[2], r[3]))
                     for r in recs])


@pytest.fixture(scope="module")
def pcm_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("pcm") / "jfk.f32le"
    path.write_bytes(jfk()[:64000].tobytes())
    return path


# ---------------- the CLIs (subprocess, --device cpu) ----------------


def test_mel_tga_and_tga_to_asr(pcm_file, tmp_path):
    out_dir = tmp_path / "mels"
    with open(pcm_file, "rb") as fh:
        proc = run(["melspec_tpu_torch.examples.mel_tga", "--device", "cpu",
                    "--out-dir", str(out_dir)], stdin=fh)
    assert proc.returncode == 0, proc.stderr[-500:]
    tgas = sorted(out_dir.glob("*.tga"))
    assert tgas

    proc = run(["melspec_tpu_torch.examples.tga_to_asr", str(tgas[0]),
                "--out", str(tmp_path / "feats.npz"), "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-500:]
    z = np.load(tmp_path / "feats.npz")
    assert z["input_features"].shape[1] == 80


def test_waterfall(tmp_path):
    pytest.importorskip("PIL")
    out = tmp_path / "wf.png"
    proc = run(["melspec_tpu_torch.examples.waterfall",
                str(REF / "jfk_f32le.wav"), "--out", str(out),
                "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-500:]
    assert out.stat().st_size > 1000


def test_vad_ten_eval_cli():
    if not (REF / "ten-vad").is_dir():
        pytest.skip("ten-vad testset unavailable")
    proc = run(["melspec_tpu_torch.examples.vad_ten_eval", "--device",
                "cpu", "--max-files", "2"])
    assert proc.returncode == 0, proc.stderr[-500:]
    assert "macro:" in proc.stdout and "rtfx" in proc.stdout


def test_vad_ten_eval_output_equals_jax_cli():
    """The port's ``vad_ten_eval`` prints JAX's report: the settings,
    ``all:`` and ``macro:`` lines equal digit for digit on the same two
    files, and the ``speed:`` line and per-file rows in JAX's format."""
    if not (REF / "ten-vad").is_dir():
        pytest.skip("ten-vad testset unavailable")
    port = run(["melspec_tpu_torch.examples.vad_ten_eval", "--device",
                "cpu", "--max-files", "2"])
    jax = subprocess.run(
        [sys.executable, "examples/vad_ten_eval.py", "--platform", "cpu",
         "--max-files", "2"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert port.returncode == 0 and jax.returncode == 0, \
        port.stderr[-500:] + jax.stderr[-500:]
    a, b = port.stdout.splitlines(), jax.stdout.splitlines()
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        if la.startswith(("speed:", "testset-")):
            num = r"[0-9.]+"
            assert re.sub(num, "#", la) == re.sub(num, "#", lb)
        else:
            assert la == lb


def test_stream_asr_segments(pcm_file, tmp_path):
    with open(pcm_file, "rb") as fh:
        proc = run(["melspec_tpu_torch.examples.stream_asr_segments",
                    "--device", "cpu", "--out-dir", str(tmp_path)],
                   stdin=fh)
    assert proc.returncode == 0, proc.stderr[-500:]


# ---------------- the TCP server (device="cpu") ----------------


def test_serve_streams_16_concurrent():
    """>= 16 concurrent PCM streams through the socket serving loop, each
    stream's dequantized mel matching the single-stream reference."""
    pcm = jfk()
    n_streams = 16
    server = serve.StreamServer(port=0, n_streams=n_streams,
                                config=MelConfig(400, 160, 80, 16000.0),
                                device=CPU)
    server.start()
    try:
        clips = [pcm[i * 2000 : i * 2000 + 48000] for i in range(n_streams)]
        results = [None] * n_streams

        def go(i):
            results[i] = serve.stream_client(server.port, clips[i])

        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        for i in range(n_streams):
            recs = results[i]
            assert recs is not None and len(recs) > 0, f"stream {i} empty"
            assert len(recs) == framing.num_frames_streaming(48000, 400, 160)
            assert [r[0] for r in recs] == list(range(len(recs)))
            want = compute_streaming_mel(clips[i], 400, 160, 80, 16000.0,
                                         device=CPU)
            got = dequant(recs).T
            assert got.shape == want.shape
            step = (want.max() - want.min()) / 255.0
            assert np.abs(got - want).max() <= step * 1.5 + 1e-4
        assert any(any(r[1] for r in results[i]) for i in range(n_streams))
    finally:
        server.stop()


def test_serve_streams_input_rate_resampling():
    """``input_rate``: a 48 kHz client is resampled at ingest (polyphase,
    zero-extended tail flushed before EOF) and served like a 16 kHz
    client sending the resampled audio."""
    pcm16 = jfk()[:32000]
    pcm48 = rs(pcm16, 3, 1)
    back16 = rs(pcm48, 1, 3)
    server = serve.StreamServer(port=0, n_streams=2,
                                config=MelConfig(400, 160, 80, 16000.0),
                                input_rate=48000, device=CPU)
    server.start()
    try:
        recs = serve.stream_client(server.port, pcm48)
    finally:
        server.stop()
    n16 = resample_output_len(len(pcm48), 1, 3)
    assert n16 == len(back16)
    assert len(recs) == framing.num_frames_streaming(n16, 400, 160)
    assert [r[0] for r in recs] == list(range(len(recs)))
    want = compute_streaming_mel(back16, 400, 160, 80, 16000.0, device=CPU)
    got = dequant(recs).T
    assert got.shape == want.shape
    step = (want.max() - want.min()) / 255.0
    assert np.abs(got - want).max() <= step * 1.5 + 1e-3
    assert any(r[1] for r in recs)


def test_serve_streams_device_resample():
    """``--device-resample``: the tick is a SourceRateFrontend (rings hold
    48 kHz samples). Record j equals the host-resampled reference frame j
    (the resampler's hop-aligned warm-up shifts the grid by exactly
    spurious_out/hop hops); the device path stops spur_hops frames
    earlier."""
    pcm16 = jfk()[:32000]
    pcm48 = rs(pcm16, 3, 1)
    back16 = rs(pcm48, 1, 3)
    server = serve.StreamServer(port=0, n_streams=2,
                                config=MelConfig(400, 160, 80, 16000.0),
                                input_rate=48000, device_resample=True,
                                device=CPU)
    assert server.ingest_hop == 480
    server.start()
    try:
        recs = serve.stream_client(server.port, pcm48)
    finally:
        server.stop()
    k = len(pcm48) // 480
    spur_hops = server.frontend.rs.spurious_out // 160
    assert len(recs) == (k - 2) - spur_hops
    assert [r[0] for r in recs] == list(range(len(recs)))
    want = compute_streaming_mel(back16[: k * 160], 400, 160, 80, 16000.0,
                                 device=CPU)
    got = dequant(recs).T
    assert got.shape == (80, want.shape[1] - spur_hops)
    step = (want.max() - want.min()) / 255.0
    assert np.abs(got - want[:, : got.shape[1]]).max() <= step * 1.5 + 1e-3
    assert any(r[1] for r in recs)


def test_serve_streams_s16le_ingest():
    """``--pcm-format s16le``: an int16 client's records are byte-identical
    to an f32 client sending the decoded samples."""
    pcm = jfk()[:32000]
    s16 = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype(np.int16)
    dec = s16.astype(np.float32) / 32768.0

    srv16 = serve.StreamServer(port=0, n_streams=2,
                               config=MelConfig(400, 160, 80, 16000.0),
                               pcm_format="s16le", device=CPU)
    srv16.start()
    try:
        # odd chunk size: int16 samples split across TCP sends must be
        # reassembled by the recv loop's leftover handling
        recs16 = serve.stream_client(srv16.port, pcm, chunk=4093,
                                     pcm_format="s16le")
    finally:
        srv16.stop()
    srv32 = serve.StreamServer(port=0, n_streams=2,
                               config=MelConfig(400, 160, 80, 16000.0),
                               device=CPU)
    srv32.start()
    try:
        recs32 = serve.stream_client(srv32.port, dec)
    finally:
        srv32.stop()
    assert len(recs16) == len(recs32) > 0
    for a, b in zip(recs16, recs32):
        assert a[:4] == b[:4]
        assert np.array_equal(a[4], b[4])
    with pytest.raises(ValueError, match="pcm_format"):
        serve.StreamServer(port=0, n_streams=2, pcm_format="u8", device=CPU)


def test_serve_streams_slot_churn_resets_state():
    """Churn one slot with sequential clients: every client gets exactly
    the fresh-stream frame count, with record indices restarting at 0
    and the same records as the first client (no warm-up counter or VAD
    history inherited through the reset)."""
    pcm = jfk()[:24000]
    n = framing.num_frames_streaming(24000, 400, 160)
    server = serve.StreamServer(port=0, n_streams=1, device=CPU)
    server.start()
    try:
        first = None
        for k in range(6):
            recs = serve.stream_client(server.port, pcm)
            assert len(recs) == n, f"client {k}: {len(recs)} != {n}"
            assert [r[0] for r in recs] == list(range(n))
            got = [(r[1], r[2], r[3], r[4].tobytes()) for r in recs]
            if first is None:
                first = got
            else:
                assert got == first, f"client {k} diverged from client 0"
    finally:
        server.stop()


def test_serve_streams_s16_8k_telephony_combo():
    """``--pcm-format s16le --input-rate 8000`` together: the recv loop
    decodes int16 THEN feeds the host resampler. Records match a plain
    16 kHz f32 server fed the resampled decoded audio, within one
    quantization step, with rare VAD flips."""
    x16 = jfk()[:32000]
    x8 = rs(x16, 1, 2)
    s16 = np.clip(np.round(x8 * 32768.0), -32768, 32767).astype(np.int16)
    dec8 = s16.astype(np.float32) / 32768.0
    back16 = rs(dec8, 2, 1)

    srv = serve.StreamServer(port=0, n_streams=2,
                             config=MelConfig(400, 160, 80, 16000.0),
                             pcm_format="s16le", input_rate=8000, device=CPU)
    srv.start()
    try:
        recs = serve.stream_client(srv.port, dec8, chunk=4093,
                                   pcm_format="s16le")
    finally:
        srv.stop()
    ref_srv = serve.StreamServer(port=0, n_streams=2,
                                 config=MelConfig(400, 160, 80, 16000.0),
                                 device=CPU)
    ref_srv.start()
    try:
        want = serve.stream_client(ref_srv.port, back16)
    finally:
        ref_srv.stop()
    assert len(recs) == len(want) > 0
    assert [r[0] for r in recs] == [r[0] for r in want]
    va_flips = sum(a[1] != b[1] for a, b in zip(recs, want))
    assert va_flips <= max(2, len(recs) // 50)
    mel_a, mel_b = dequant(recs), dequant(want)
    step = (mel_b.max() - mel_b.min()) / 255.0
    assert np.abs(mel_a - mel_b).max() <= 2 * step + 1e-3


def test_pack_records_batch_matches_struct_loop():
    """The vectorized whole-tick record packer is byte-identical to the
    per-record struct.pack formulation."""
    rng = np.random.default_rng(5)
    for s, h, n_mels in [(1, 1, 80), (3, 4, 80), (16, 7, 128), (5, 1, 3)]:
        q = rng.integers(0, 256, (s, h, n_mels)).astype(np.uint8)
        lo = rng.normal(size=(s, h)).astype(np.float32)
        hi = (lo + 1).astype(np.float32)
        va = rng.integers(0, 2, (s, h)).astype(bool)
        mask = rng.integers(0, 2, (s, h)).astype(bool)
        fidx0 = rng.integers(0, 1 << 20, s).astype(np.int64)

        want = bytearray()
        want_counts = []
        for i in range(s):
            fidx, m = int(fidx0[i]), 0
            for j in range(h):
                if not mask[i, j]:
                    continue
                want += struct.pack("<IBff", fidx, int(va[i, j]),
                                    float(lo[i, j]), float(hi[i, j]))
                want += q[i, j].tobytes()
                fidx += 1
                m += 1
            want_counts.append(m)
        got, counts = serve.pack_records_batch(fidx0, q, lo, hi, va, mask)
        assert got == bytes(want), (s, h, n_mels)
        assert counts.tolist() == want_counts
    got, counts = serve.pack_records_batch(
        np.zeros(2, np.int64), q[:2], lo[:2], hi[:2], va[:2],
        np.zeros((2, h), bool))
    assert got == b"" and counts.tolist() == [0, 0]


def test_serve_streams_idle_timeout_frees_slot():
    """A connected-but-silent client does not hold its slot forever: after
    ``idle_timeout_s`` the server closes it (counted in stats) and the
    freed slot serves the next client normally."""
    pcm = jfk()[:24000]
    server = serve.StreamServer(port=0, n_streams=1, idle_timeout_s=0.4,
                                device=CPU)
    server.start()
    try:
        silent = socket.create_connection(("127.0.0.1", server.port),
                                          timeout=30)
        silent.sendall(pcm[:800].tobytes())  # 5 hops, then go silent
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            s = server.stats()
            if s["idle_timeouts"] == 1 and s["in_use"] == 0:
                break
            time.sleep(0.02)
        assert s["idle_timeouts"] == 1 and s["in_use"] == 0, s
        silent.close()
        recs = serve.stream_client(server.port, pcm)
        assert len(recs) == framing.num_frames_streaming(24000, 400, 160)
        assert [r[0] for r in recs] == list(range(len(recs)))
    finally:
        server.stop()


def test_serve_streams_stalled_reader_cannot_freeze_fleet():
    """A client that streams PCM but never reads its replies is killed by
    the per-socket send timeout, and other clients keep being served."""
    pcm = jfk()
    long_pcm = np.tile(pcm, 3)  # ~33 s -> ~3300 records = ~300 KB
    server = serve.StreamServer(port=0, n_streams=2, send_timeout_s=0.5,
                                send_buffer_bytes=8192, device=CPU)
    server.start()
    try:
        stalled = socket.socket()
        stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
        stalled.connect(("127.0.0.1", server.port))
        stalled.sendall(long_pcm.tobytes())  # stream, never read replies
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if server.stats()["clients_served"] >= 1 \
                    and server.stats()["in_use"] == 0:
                break
            time.sleep(0.05)
        assert server.stats()["in_use"] == 0, server.stats()
        stalled.close()
        recs = serve.stream_client(server.port, pcm[:32000])
        assert len(recs) == framing.num_frames_streaming(32000, 400, 160)
    finally:
        server.stop()


def test_serve_streams_stop_closes_live_connections():
    """stop() sends a FIN to surviving clients."""
    server = serve.StreamServer(port=0, n_streams=2, device=CPU)
    server.start()
    c = socket.create_connection(("127.0.0.1", server.port), timeout=30)
    c.sendall(np.zeros(1600, np.float32).tobytes())  # mid-stream, no EOF
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not server.stats()["in_use"]:
        time.sleep(0.01)
    server.stop()
    c.settimeout(10)
    try:
        while c.recv(65536):
            pass
        eof = True
    except TimeoutError:
        eof = False
    c.close()
    assert eof, "server.stop() left the client connection open"


def test_serve_streams_device_resample_requires_input_rate():
    with pytest.raises(ValueError, match="requires --input-rate"):
        serve.StreamServer(port=0, n_streams=2, device_resample=True,
                           device=CPU)
    # 16 kHz input explicitly declared: no resampler needed, plain tick
    srv = serve.StreamServer(port=0, n_streams=2, device_resample=True,
                             input_rate=16000, device=CPU)
    srv.stop()


def test_serve_streams_graceful_drain():
    """``stop(drain=True)``: an in-flight half-closed stream finishes (the
    client receives every record) before the server halts."""
    pcm = jfk()[:48000]
    server = serve.StreamServer(port=0, n_streams=2, device=CPU)
    server.start()
    result = {}

    def go():
        result["recs"] = serve.stream_client(server.port, pcm)

    t = threading.Thread(target=go)
    t.start()
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if server.stats()["in_use"] or "recs" in result:
            break
        time.sleep(0.005)
    server.stop(drain=True, timeout=120)
    t.join(timeout=120)
    assert not t.is_alive()
    n = framing.num_frames_streaming(48000, 400, 160)
    assert len(result["recs"]) == n, len(result["recs"])


def test_serve_streams_stats():
    """``stats()``: the counters reflect the streams actually served. The
    port's snapshot carries JAX's keys and the fleet totals
    ``backpressure_waits`` and ``ring_dropped``."""
    pcm = jfk()[:32000]
    server = serve.StreamServer(port=0, n_streams=4, device=CPU)
    server.start()
    try:
        s0 = server.stats()
        assert s0 == {"n_streams": 4, "in_use": 0, "ticks": 0,
                      "frames_sent": 0, "clients_served": 0,
                      "idle_timeouts": 0, "backpressure_waits": 0,
                      "ring_dropped": 0, "slots": []}
        live = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=30)
        live.sendall(pcm[:8000].tobytes())
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            s_live = server.stats()
            if s_live["in_use"] == 1 and s_live["slots"]:
                break
            time.sleep(0.01)
        assert s_live["in_use"] == 1
        (slot,) = s_live["slots"]
        assert slot["ring_dropped"] == 0 and not slot["eof"]
        live.shutdown(socket.SHUT_WR)
        while live.recv(65536):
            pass
        live.close()

        recs1 = serve.stream_client(server.port, pcm)
        recs2 = serve.stream_client(server.port, pcm)
        s = server.stats()
    finally:
        server.stop()
    n = framing.num_frames_streaming(32000, 400, 160)
    n_live = framing.num_frames_streaming(8000, 400, 160)
    assert len(recs1) == len(recs2) == n
    assert s["frames_sent"] == 2 * n + n_live
    assert s["clients_served"] == 3
    assert s["in_use"] == 0 and s["slots"] == []
    assert s["ticks"] >= 3
    assert s["backpressure_waits"] == 0 and s["ring_dropped"] == 0


def test_asr_handoff_from_tga(tmp_path):
    """The ASR handoff: TGA features in, Whisper decode out, through a
    SEEDED tiny ``WhisperForConditionalGeneration`` (no checkpoint is
    downloaded): the TGA-stored, whisper-normalized mel is consumed as
    ``input_features``, generation runs and is deterministic, and the
    logits depend on the audio."""
    pytest.importorskip("transformers")
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    from melspec_tpu_torch.io.tga import (interleave_frames, load_tga_8bit,
                                          save_tga_8bit, to_array2)

    pcm = jfk()
    mels = {}
    for name, clip in (("a", pcm[:48000]), ("b", pcm[48000:96000])):
        mel = compute_streaming_mel(clip, 400, 160, 80, 16000.0, device=CPU)
        path = tmp_path / f"{name}.tga"
        save_tga_8bit(interleave_frames([mel]), 80, path)
        mels[name] = to_array2(load_tga_8bit(path), 80).astype(np.float32)

    torch.manual_seed(0)
    config = WhisperConfig(
        vocab_size=64, num_mel_bins=80, d_model=64,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=64,
        decoder_start_token_id=1, pad_token_id=0, bos_token_id=1,
        eos_token_id=2,
    )
    model = WhisperForConditionalGeneration(config).eval()

    feats_a = tga_to_asr.whisper_features(mels["a"])
    assert feats_a.shape == (1, 80, 3000)

    ids_a = tga_to_asr.transcribe(mels["a"], model, max_new_tokens=12)
    ids_a2 = tga_to_asr.transcribe(mels["a"], model, max_new_tokens=12)
    assert ids_a.shape[1] > 1
    np.testing.assert_array_equal(ids_a, ids_a2)

    dec = torch.tensor([[1]])
    with torch.no_grad():
        la = model(input_features=torch.from_numpy(
            tga_to_asr.whisper_features(mels["a"])),
            decoder_input_ids=dec).logits
        lb = model(input_features=torch.from_numpy(
            tga_to_asr.whisper_features(mels["b"])),
            decoder_input_ids=dec).logits
    assert torch.isfinite(la).all() and torch.isfinite(lb).all()
    assert not torch.allclose(la, lb), "logits must depend on the mel"


def test_idle_evicted_client_still_receives_buffered_records():
    """Idle eviction half-closes only the READ side: records for audio
    already buffered in the slot's ring at timeout still drain and are
    DELIVERED, ending in a clean FIN."""
    n_samples = 16000  # 100 hops in one burst
    pcm = jfk()[:n_samples]
    server = serve.StreamServer(port=0, n_streams=1, hops_per_tick=1,
                                idle_timeout_s=0.05, device=CPU)
    server.start()
    try:
        conn = socket.create_connection(("127.0.0.1", server.port),
                                        timeout=120)
        conn.sendall(pcm.astype("<f4").tobytes())
        buf = b""
        while True:
            try:
                data = conn.recv(65536)
            except OSError:
                break
            if not data:
                break
            buf += data
        conn.close()
        assert server.stats()["idle_timeouts"] == 1
        rec_size = serve.HEADER.size + 80
        assert len(buf) % rec_size == 0
        got = len(buf) // rec_size
        assert got == framing.num_frames_streaming(n_samples, 400, 160)
        idx0 = serve.HEADER.unpack(buf[: serve.HEADER.size])[0]
        assert idx0 == 0
    finally:
        server.stop()


def test_serve_streams_fft_impl_auto_and_validation():
    """--fft-impl auto: on the CPU the calibration falls back to 'rdft'
    without timing, equal-config servers share ONE canonical frontend,
    and the served records match the streaming frame count."""
    with pytest.raises(ValueError, match="fft_impl"):
        serve.StreamServer(port=0, n_streams=2, fft_impl="nope", device=CPU)

    srv = serve.StreamServer(port=0, n_streams=2, fft_impl="auto",
                             device=CPU)
    try:
        assert srv.fft_impl == "rdft"
        srv2 = serve.StreamServer(port=0, n_streams=2, fft_impl="rdft",
                                  device=CPU)
        try:
            assert srv2.frontend is srv.frontend
        finally:
            srv2.stop()
        srv.start()
        pcm = jfk()[:16000]
        recs = serve.stream_client(srv.port, pcm)
        assert len(recs) == framing.num_frames_streaming(16000, 400, 160)
    finally:
        srv.stop()


def test_calibrate_fft_impl_fallbacks(monkeypatch):
    """calibrate_fft_impl resolves WITHOUT timing wherever the sig route
    cannot serve the config: on the CPU, and (CUDA reported present, no
    CUDA call made) for log10 records and a hop with no geometry."""
    assert calibrate_fft_impl(n_streams=2, hops=2, device=CPU) == "rdft"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_timing(*a, **k):
        raise AssertionError("calibrate_fft_impl timed a route")

    monkeypatch.setattr(torch.cuda, "Event", no_timing)
    assert calibrate_fft_impl(record_norm="log10", device="cuda") == "rdft"
    assert calibrate_fft_impl(MelConfig(16, 4, 8, 16000.0),
                              device="cuda") == "rdft"


# ---------------- the port's server against the JAX package's ----------------


def _jax_serve():
    spec = importlib.util.spec_from_file_location(
        "serve_streams_jax_ref", REPO / "examples" / "serve_streams.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def speechlike(rng, s: int, n: int, rate: int) -> np.ndarray:
    """White noise switched between 0.3 and 0.003 every 0.25 s (a random
    phase per stream): edges and quiet stretches for the VAD."""
    t = np.arange(n) / rate
    on = ((t[None, :] + rng.random((s, 1)) * 0.5) % 0.5) < 0.25
    return (rng.normal(size=(s, n)) * np.where(on, 0.3, 0.003)
            ).astype(np.float32)


def _serve_fleet(mod, clips, fmt, **kw):
    server = mod.StreamServer(port=0, n_streams=4, hops_per_tick=4,
                              config=kw.pop("config"), **kw)
    server.start()
    out = [None] * len(clips)

    def go(i):
        out[i] = mod.stream_client(server.port, clips[i], chunk=4093,
                                   pcm_format=fmt)

    try:
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(clips))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        server.stop()
    return out


@pytest.mark.parametrize("case", [
    ("16k_f32_rdft", 16000, "f32le", "rdft", False),
    ("48k_device_resample_rdft", 48000, "f32le", "rdft", True),
    ("48k_device_resample_sig", 48000, "f32le", "sig", True),
    ("8k_s16le_host_resample", 8000, "s16le", "rdft", False),
], ids=lambda c: c[0])
def test_records_equal_jax_server(case):
    """The same seeded PCM through JAX's StreamServer and the port's (both
    on the CPU; the port's sig route runs K1's plain version), three
    clients at once: per client the same record count and frame indices,
    minima and maxima within 2e-5, u8 within one step, at most one VAD
    flip over the test."""
    from melspec_tpu import config as jconfig

    _, rate, fmt, fft_impl, dev_rs = case
    jserve = _jax_serve()
    rng = np.random.default_rng(41)
    clips = list(speechlike(rng, 3, int(2.5 * rate), rate))
    common = dict(fft_impl=fft_impl, pcm_format=fmt,
                  input_rate=None if rate == 16000 else rate,
                  device_resample=dev_rs, record_norm="whisper")
    got = _serve_fleet(serve, clips, fmt, device=CPU,
                       config=MelConfig(400, 160, 80, 16000.0), **common)
    want = _serve_fleet(jserve, clips, fmt,
                        config=jconfig.MelConfig(400, 160, 80, 16000.0),
                        **common)
    flips = checked = 0
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert [r[0] for r in g] == [r[0] for r in w] == list(range(len(g)))
        lo = np.asarray([r[2] for r in g]) - np.asarray([r[2] for r in w])
        hi = np.asarray([r[3] for r in g]) - np.asarray([r[3] for r in w])
        assert np.abs(lo).max() <= 2e-5 and np.abs(hi).max() <= 2e-5
        q = np.stack([r[4] for r in g]).astype(int) \
            - np.stack([r[4] for r in w]).astype(int)
        assert np.abs(q).max() <= 1
        flips += sum(a[1] != b[1] for a, b in zip(g, w))
        checked += len(g)
    assert flips <= 1, (flips, checked)
    assert any(r[1] for c in got for r in c)


def test_wire_helpers_byte_equal_to_jax():
    """``pack_records_batch`` and ``decode_pcm`` give JAX's bytes on the
    same inputs, and ``HEADER`` is JAX's record header."""
    jserve = _jax_serve()
    assert serve.HEADER.format == jserve.HEADER.format
    rng = np.random.default_rng(9)
    for s, h, n_mels in [(4, 4, 80), (256, 1, 128), (3, 7, 5)]:
        args = (rng.integers(0, 1 << 31, s).astype(np.int64),
                rng.integers(0, 256, (s, h, n_mels)).astype(np.uint8),
                rng.normal(size=(s, h)).astype(np.float32),
                rng.normal(size=(s, h)).astype(np.float32),
                rng.integers(0, 2, (s, h)).astype(bool),
                rng.integers(0, 2, (s, h)).astype(bool))
        a, ca = serve.pack_records_batch(*args)
        b, cb = jserve.pack_records_batch(*args)
        assert a == b and ca.tolist() == cb.tolist()
    raw = rng.bytes(4 * 1001)
    for fmt in ("f32le", "s16le"):
        a = serve.decode_pcm(raw, fmt)
        b = jserve.decode_pcm(raw, fmt)
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes()


# ---------------- no silent CPU fallback ----------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_stream_server_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match=NO_CUDA):
        serve.StreamServer(port=0, n_streams=2)


@pytest.mark.parametrize("mod, argv", [
    (serve, []),
    (bridge_server, []),
    (live_pipeline, []),
    (mel_tga, []),
    (tga_to_asr, ["missing.tga"]),
    (stream_asr_segments, []),
    (waterfall, [str(REF / "jfk_f32le.wav")]),
    (vad_ten_eval, ["--max-files", "1"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__")
    else None)
def test_cli_without_device_exits_nonzero_without_cuda(no_cuda, monkeypatch,
                                                        capsys, mod, argv):
    """Each program run without ``--device`` asks for CUDA and, where it
    is absent, exits non-zero with ``resolve_device``'s message before
    any work (no output file, no socket, no CPU fallback)."""
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    with pytest.raises(SystemExit) as exc:
        mod.main()
    assert exc.value.code not in (0, None)
    assert NO_CUDA in str(exc.value.code)
    assert capsys.readouterr().out == ""


def test_cli_exit_code_without_cuda(pcm_file, tmp_path):
    """The same in a process of its own (this host's CUDA, or none):
    ``mel_tga`` without ``--device`` exits 1 with the message where CUDA
    is absent, and writes its TGA where it is present."""
    with open(pcm_file, "rb") as fh:
        proc = run(["melspec_tpu_torch.examples.mel_tga", "--out-dir",
                    str(tmp_path / "mels")], stdin=fh)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr[-500:]
        assert sorted((tmp_path / "mels").glob("*.tga"))
    else:
        assert proc.returncode == 1
        assert NO_CUDA in proc.stderr
        assert not (tmp_path / "mels").exists()
