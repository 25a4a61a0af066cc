"""The port's browser bridge (``melspec_tpu_torch/examples/browser/
server.py``) on the CPU: every case of ``tests/test_browser_bridge.py`` on
the port's ``BrowserBridge`` over the port's ``StreamServer``
(``device="cpu"``), the WebSocket helpers byte-equal to the JAX
package's, the page's golden (``examples/browser/test/dsp_golden.json``,
which the bridge serves) reproduced by the port's float64
``SpeechToMel``, and no CUDA fallback."""

import json
import socket
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from melspec_tpu_torch.examples.browser import server as bridge_mod
from melspec_tpu_torch.examples.browser.server import (BrowserBridge,
                                                       ws_accept_key,
                                                       ws_encode_frame,
                                                       ws_read_frame)
from melspec_tpu_torch.examples.serve_streams import HEADER
from melspec_tpu_torch.examples.serve_streams import \
    StreamServer as _StreamServer
from melspec_tpu_torch.io.wav import read_wav_f32le
from melspec_tpu_torch.ops.quant import QuantizationRange, dequantize
from melspec_tpu_torch.ops.resample import resample_poly as _resample_poly

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "examples" / "browser" / "test" / "dsp_golden.json"


def StreamServer(**kw):
    """The port's server on the CPU (its default device is CUDA)."""
    return _StreamServer(device="cpu", **kw)


def resample_poly(x, up, down):
    return _resample_poly(np.asarray(x, np.float32), up, down,
                          device="cpu").numpy()


@pytest.fixture(scope="module")
def jfk_samples():
    return read_wav_f32le(ROOT / "testdata" / "jfk_f32le.wav")


def _ws_connect(port: int, path: str = "/ws") -> socket.socket:
    sock = socket.create_connection(("127.0.0.1", port), timeout=30)
    key = "dGhlIHNhbXBsZSBub25jZQ=="
    sock.sendall(
        (f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
         "Upgrade: websocket\r\nConnection: Upgrade\r\n"
         f"Sec-WebSocket-Key: {key}\r\n"
         "Sec-WebSocket-Version: 13\r\n\r\n").encode()
    )
    resp = b""
    while b"\r\n\r\n" not in resp:
        chunk = sock.recv(4096)
        assert chunk, "handshake EOF"
        resp += chunk
    head = resp.split(b"\r\n\r\n")[0].decode()
    assert "101" in head.splitlines()[0]
    assert ws_accept_key(key) in head
    return sock


def _drain_records(sock: socket.socket, n_mels: int) -> bytes:
    buf = b""
    while True:
        try:
            opcode, payload = ws_read_frame(sock)
        except ConnectionError:
            break
        if opcode == 0x8:
            break
        if opcode == 0x2:
            buf += payload
    return buf


@pytest.fixture(scope="module")
def pcm(jfk_samples):
    return np.asarray(jfk_samples[: 16000 * 3], np.float32).tobytes()


def test_ws_client_matches_tcp_client(pcm):
    streams = StreamServer(n_streams=4, hops_per_tick=4)
    streams.start()
    bridge = BrowserBridge(stream_server=streams).start()
    try:
        # plain TCP reference pass
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=30)
        tcp.sendall(pcm)
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()

        # websocket pass: masked binary frames in odd chunk sizes
        ws = _ws_connect(bridge.port)
        for off in range(0, len(pcm), 31997):
            ws.sendall(ws_encode_frame(pcm[off : off + 31997], mask=True))
        ws.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        got = _drain_records(ws, streams.config.n_mels)
        ws.close()
    finally:
        bridge.stop()
        streams.stop()

    rec = HEADER.size + streams.config.n_mels
    assert len(want) > 0 and len(want) % rec == 0
    assert got == want, (len(got), len(want))
    idx0, va0, lo, hi = HEADER.unpack(want[:HEADER.size])
    assert lo <= hi


def test_ws_client_reported_rate_resampled(jfk_samples):
    """`/ws?rate=48000` (the page reporting an AudioContext whose 16 kHz
    hint was ignored): the bridge resamples that client at ingest, so its
    records match a TCP client sending the offline-resampled audio."""
    x16 = np.asarray(jfk_samples[: 16000 * 2], np.float32)
    x48 = np.asarray(resample_poly(x16, 3, 1)).astype(np.float32)
    back16 = np.asarray(resample_poly(x48, 1, 3)).astype(np.float32)

    streams = StreamServer(n_streams=4, hops_per_tick=4)
    streams.start()
    bridge = BrowserBridge(stream_server=streams).start()
    try:
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=30)
        tcp.sendall(back16.tobytes())
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()

        ws = _ws_connect(bridge.port, path="/ws?rate=48000")
        raw = x48.tobytes()
        for off in range(0, len(raw), 31997):  # splits floats across frames
            ws.sendall(ws_encode_frame(raw[off : off + 31997], mask=True))
        ws.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        got = _drain_records(ws, streams.config.n_mels)
        ws.close()
    finally:
        bridge.stop()
        streams.stop()

    rec = HEADER.size + streams.config.n_mels

    def parse(buf):
        out = []
        for off in range(0, len(buf), rec):
            idx, va, lo, hi = HEADER.unpack(buf[off : off + HEADER.size])
            q = np.frombuffer(buf[off + HEADER.size : off + rec], np.uint8)
            out.append((idx, va, dequantize(q, QuantizationRange(lo, hi))))
        return out

    assert len(got) % rec == 0 and len(want) % rec == 0
    a, b = parse(got), parse(want)
    assert len(a) == len(b) and len(a) > 0
    assert [r[0] for r in a] == [r[0] for r in b]
    # the bridge's streaming f32 resampler vs the offline op differ by
    # ulps, so bytes may move one quantization step and a borderline VAD
    # frame may flip — bound both instead of requiring identity
    va_flips = sum(ra[1] != rb[1] for ra, rb in zip(a, b))
    assert va_flips <= max(2, len(a) // 50)
    mel_a = np.stack([r[2] for r in a])
    mel_b = np.stack([r[2] for r in b])
    step = (mel_b.max() - mel_b.min()) / 255.0
    assert np.abs(mel_a - mel_b).max() <= 2 * step + 1e-3


def test_ws_s16_matches_f32(jfk_samples):
    """``/ws?fmt=s16`` (telephony-gateway clients): int16 PCM is decoded
    at the ws edge (x / 32768 — exact in f32), so the records are
    BYTE-IDENTICAL to an f32 client sending the decoded samples."""
    x = np.asarray(jfk_samples[: 16000 * 2], np.float32)
    s16 = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    dec = s16.astype(np.float32) / 32768.0

    streams = StreamServer(n_streams=4, hops_per_tick=4)
    streams.start()
    bridge = BrowserBridge(stream_server=streams).start()
    try:
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=30)
        tcp.sendall(dec.tobytes())
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()

        ws = _ws_connect(bridge.port, path="/ws?fmt=s16")
        raw = s16.tobytes()
        for off in range(0, len(raw), 31997):  # splits int16s across frames
            ws.sendall(ws_encode_frame(raw[off : off + 31997], mask=True))
        ws.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        got = _drain_records(ws, streams.config.n_mels)
        ws.close()
    finally:
        bridge.stop()
        streams.stop()

    rec = HEADER.size + streams.config.n_mels
    assert len(want) > 0 and len(want) % rec == 0
    assert got == want, (len(got), len(want))


def test_ws_s16_8k_telephony_combo(jfk_samples):
    """``/ws?rate=8000&fmt=s16`` — the telephony staple: int16 at 8 kHz
    is decoded AND resampled at the ws edge. Records must match a TCP
    client sending the host-resampled decoded audio (same tolerance as
    the rate-only test: the streaming-vs-offline resampler differs by
    ulps, so allow one quantization step and rare VAD flips)."""
    x16 = np.asarray(jfk_samples[: 16000 * 2], np.float32)
    x8 = np.asarray(resample_poly(x16, 1, 2)).astype(np.float32)
    s16 = np.clip(np.round(x8 * 32768.0), -32768, 32767).astype("<i2")
    dec8 = s16.astype(np.float32) / 32768.0
    back16 = np.asarray(resample_poly(dec8, 2, 1)).astype(np.float32)

    streams = StreamServer(n_streams=4, hops_per_tick=4)
    streams.start()
    bridge = BrowserBridge(stream_server=streams).start()
    try:
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=30)
        tcp.sendall(back16.tobytes())
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()

        ws = _ws_connect(bridge.port, path="/ws?rate=8000&fmt=s16")
        raw = s16.tobytes()
        for off in range(0, len(raw), 9973):
            ws.sendall(ws_encode_frame(raw[off : off + 9973], mask=True))
        ws.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        got = _drain_records(ws, streams.config.n_mels)
        ws.close()
    finally:
        bridge.stop()
        streams.stop()

    rec = HEADER.size + streams.config.n_mels

    def parse(buf):
        out = []
        for off in range(0, len(buf), rec):
            idx, va, lo, hi = HEADER.unpack(buf[off : off + HEADER.size])
            q = np.frombuffer(buf[off + HEADER.size : off + rec], np.uint8)
            out.append((idx, va, dequantize(q, QuantizationRange(lo, hi))))
        return out

    assert len(got) % rec == 0 and len(want) % rec == 0
    a, b = parse(got), parse(want)
    assert len(a) == len(b) > 0
    assert [r[0] for r in a] == [r[0] for r in b]
    va_flips = sum(ra[1] != rb[1] for ra, rb in zip(a, b))
    assert va_flips <= max(2, len(a) // 50)
    mel_a = np.stack([r[2] for r in a])
    mel_b = np.stack([r[2] for r in b])
    step = (mel_b.max() - mel_b.min()) / 255.0
    assert np.abs(mel_a - mel_b).max() <= 2 * step + 1e-3


def test_bad_ws_fmt_rejected_with_400():
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        sock = socket.create_connection(("127.0.0.1", bridge.port),
                                        timeout=30)
        sock.sendall(
            (f"GET /ws?fmt=u8 HTTP/1.1\r\n"
             f"Host: 127.0.0.1:{bridge.port}\r\n"
             "Upgrade: websocket\r\nConnection: Upgrade\r\n"
             "Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
             "Sec-WebSocket-Version: 13\r\n\r\n").encode()
        )
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = sock.recv(4096)
            if not chunk:
                break
            resp += chunk
        sock.close()
        status = resp.split(b"\r\n", 1)[0].decode(errors="replace")
        assert " 400 " in status, status
        # still serving afterwards (s16le alias accepted too)
        ws = _ws_connect(bridge.port, path="/ws?fmt=s16le")
        ws.close()
    finally:
        bridge.stop()


def test_bridge_requires_f32_stream_server():
    """The bridge forwards config-rate f32le to its stream server;
    wiring it to an s16le-ingest or resampling server would corrupt
    every stream (double-resampled or misdecoded PCM, no error)."""
    streams = StreamServer(n_streams=2, pcm_format="s16le")
    try:
        with pytest.raises(ValueError, match="f32le"):
            BrowserBridge(stream_server=streams)
    finally:
        streams.stop()
    streams = StreamServer(n_streams=2, input_rate=8000)
    try:
        with pytest.raises(ValueError, match="input_rate"):
            BrowserBridge(stream_server=streams)
    finally:
        streams.stop()


def test_ws_coalesced_handshake_and_frames(pcm):
    """A client that writes the upgrade request AND its first frames in
    one send (gateways do; they need not wait for the 101) must not
    lose those frames to the HTTP handler's read buffering."""
    streams = StreamServer(n_streams=4, hops_per_tick=4)
    streams.start()
    bridge = BrowserBridge(stream_server=streams).start()
    try:
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=30)
        tcp.sendall(pcm)
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()

        sock = socket.create_connection(("127.0.0.1", bridge.port),
                                        timeout=30)
        key = "dGhlIHNhbXBsZSBub25jZQ=="
        upgrade = (f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{bridge.port}\r\n"
                   "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\n"
                   "Sec-WebSocket-Version: 13\r\n\r\n").encode()
        first = ws_encode_frame(pcm[:31997], mask=True)
        sock.sendall(upgrade + first)  # ONE write: handshake + PCM
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += sock.recv(4096)
        assert b" 101 " in resp.split(b"\r\n", 1)[0]
        for off in range(31997, len(pcm), 31997):
            sock.sendall(ws_encode_frame(pcm[off : off + 31997],
                                         mask=True))
        sock.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        # the 101 response read above may have swallowed early record
        # frames; reassemble from whatever followed the header
        buf = resp.split(b"\r\n\r\n", 1)[1]
        got = b""

        class _Pre:
            def __init__(self, s, pre):
                self.s, self.pre = s, pre

            def recv(self, n):
                if self.pre:
                    out, self.pre = self.pre[:n], self.pre[n:]
                    return out
                return self.s.recv(n)

        src = _Pre(sock, buf)
        while True:
            try:
                opcode, payload = ws_read_frame(src)
            except (ConnectionError, OSError):
                break
            if opcode == 0x8:
                break
            if opcode == 0x2:
                got += payload
        sock.close()
    finally:
        bridge.stop()
        streams.stop()
    assert got == want, (len(got), len(want))


def test_ws_fragmented_message_with_interleaved_pong(pcm):
    """RFC 6455 §5.5: control frames may be interleaved between the
    fragments of a message and must not reset the fragmentation state —
    an unsolicited pong mid-message used to discard the continuation."""
    streams = StreamServer(n_streams=4, hops_per_tick=4)
    streams.start()
    bridge = BrowserBridge(stream_server=streams).start()
    try:
        tcp = socket.create_connection(("127.0.0.1", streams.port),
                                       timeout=30)
        tcp.sendall(pcm)
        tcp.shutdown(socket.SHUT_WR)
        want = b""
        while True:
            d = tcp.recv(65536)
            if not d:
                break
            want += d
        tcp.close()

        ws = _ws_connect(bridge.port)
        half = (len(pcm) // 2) // 4 * 4
        ws.sendall(ws_encode_frame(pcm[:half], mask=True, fin=False))
        ws.sendall(ws_encode_frame(b"keepalive", opcode=0xA, mask=True))
        ws.sendall(ws_encode_frame(pcm[half:], opcode=0x0, mask=True))
        ws.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        got = _drain_records(ws, streams.config.n_mels)
        ws.close()
    finally:
        bridge.stop()
        streams.stop()
    assert got == want, (len(got), len(want))


def test_ws_origin_validation():
    """A hostile page's Origin is rejected (WebSockets bypass CORS); a
    matching Origin and no Origin (non-browser gateways) pass."""
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        def upgrade(origin):
            sock = socket.create_connection(("127.0.0.1", bridge.port),
                                            timeout=30)
            extra = f"Origin: {origin}\r\n" if origin else ""
            sock.sendall(
                (f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{bridge.port}\r\n"
                 "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                 "Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                 f"{extra}Sec-WebSocket-Version: 13\r\n\r\n").encode()
            )
            resp = b""
            while b"\r\n\r\n" not in resp:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                resp += chunk
            sock.close()
            return resp.split(b"\r\n", 1)[0].decode(errors="replace")

        assert " 403 " in upgrade("http://evil.example")
        assert " 101 " in upgrade(f"http://127.0.0.1:{bridge.port}")
        assert " 101 " in upgrade(None)
    finally:
        bridge.stop()


def test_static_pages_with_query_strings():
    """Cache-busting query strings must not 404 the static routes."""
    import urllib.request

    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        for url in ("/?ts=123", "/app.js?v=2"):
            with urllib.request.urlopen(
                f"http://127.0.0.1:{bridge.port}{url}"
            ) as r:
                assert r.status == 200
    finally:
        bridge.stop()


def test_bad_ws_rate_rejected_with_400():
    """Client-controlled ``?rate=`` must be bounded BEFORE a resampler is
    constructed: a coprime pair would build (and cache) a multi-gigabyte
    polyphase matrix, and 0/inf/garbage used to escape the handler as an
    uncaught exception instead of a 400."""
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        for rate in ["0", "-8000", "inf", "nan", "abc", "44101", "1e99"]:
            sock = socket.create_connection(("127.0.0.1", bridge.port),
                                            timeout=30)
            sock.sendall(
                (f"GET /ws?rate={rate} HTTP/1.1\r\n"
                 f"Host: 127.0.0.1:{bridge.port}\r\n"
                 "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                 "Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                 "Sec-WebSocket-Version: 13\r\n\r\n").encode()
            )
            resp = b""
            while b"\r\n\r\n" not in resp:
                chunk = sock.recv(4096)
                if not chunk:
                    break
                resp += chunk
            sock.close()
            status = resp.split(b"\r\n", 1)[0].decode(errors="replace")
            assert " 400 " in status, (rate, status)
        # the server must still accept a good client afterwards
        ws = _ws_connect(bridge.port, path="/ws?rate=48000")
        ws.close()
    finally:
        bridge.stop()


def test_oversized_ws_frame_disconnects_without_buffering():
    """The frame-length field is client-controlled (up to 2**64); a
    declared terabyte frame must drop the connection instead of growing
    an unbounded host buffer."""
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        ws = _ws_connect(bridge.port)
        # header only: FIN+binary, masked, 64-bit length = 1 TiB
        ws.sendall(bytes([0x82, 0x80 | 127]) + struct.pack(">Q", 1 << 40)
                   + b"\x00\x01\x02\x03")
        ws.settimeout(30)
        # server must close (ws close frame then EOF) without waiting for
        # the payload
        saw_close_or_eof = False
        try:
            while True:
                opcode, _ = ws_read_frame(ws)
                if opcode == 0x8:
                    saw_close_or_eof = True
                    break
        except (ConnectionError, OSError):
            saw_close_or_eof = True
        assert saw_close_or_eof
        ws.close()
        # and keep serving others
        ws2 = _ws_connect(bridge.port)
        ws2.close()
    finally:
        bridge.stop()


def test_ws_garbage_bytes_survive():
    """Random post-handshake garbage (misparsed opcodes, bogus lengths,
    truncated frames) must never wedge or crash the bridge — each
    connection ends, and the server keeps serving."""
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    rng = np.random.default_rng(3)
    try:
        for trial in range(4):
            ws = _ws_connect(bridge.port)
            ws.settimeout(30)
            ws.sendall(rng.bytes(257 + 97 * trial))
            ws.close()  # abrupt close mid-frame
        # still serving
        ws = _ws_connect(bridge.port)
        ws.sendall(ws_encode_frame(b"", opcode=0x8, mask=True))
        ws.close()
    finally:
        bridge.stop()


def test_bad_input_rate_fails_at_startup():
    """An invalid --input-rate must raise at construction, not kill the
    accept thread on the first connection."""
    with pytest.raises(ValueError):
        StreamServer(n_streams=2, input_rate=0)
    with pytest.raises(ValueError):
        StreamServer(n_streams=2, input_rate=44101)  # coprime with 16000


def test_static_pages_served():
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        import urllib.request

        for name, marker in [("", b"melspec_tpu live pipeline"),
                             ("app.js", b"drawColumn"),
                             ("worklet.js", b"pcm-capture")]:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{bridge.port}/{name}"
            ) as r:
                body = r.read()
                assert r.status == 200
                assert marker in body
                if name == "":
                    assert r.headers["Cross-Origin-Embedder-Policy"] \
                        == "require-corp"
        with pytest.raises(Exception):
            urllib.request.urlopen(
                f"http://127.0.0.1:{bridge.port}/../secret"
            )
        # /stats: the serving counters as JSON (deployment scrape point)
        import json

        with urllib.request.urlopen(
            f"http://127.0.0.1:{bridge.port}/stats"
        ) as r:
            assert r.status == 200
            stats = json.loads(r.read())
        assert stats["n_streams"] == 2
        assert {"in_use", "ticks", "frames_sent", "clients_served",
                "slots"} <= stats.keys()
    finally:
        bridge.stop()


# ---------------- port-only checks ----------------


def test_ws_helpers_byte_equal_to_jax():
    """``ws_accept_key`` and ``ws_encode_frame`` (every length class,
    masked or not, fragment flags) give the JAX bridge's bytes."""
    sys.path.insert(0, str(ROOT))
    from examples.browser import server as jbridge

    for key in ("dGhlIHNhbXBsZSBub25jZQ==", "x3JJHMbDL1EzLkh9GBhXDw=="):
        assert ws_accept_key(key) == jbridge.ws_accept_key(key)
    rng = np.random.default_rng(13)
    for n in (0, 1, 125, 126, 4093, 65535, 65536, 70001):
        payload = rng.bytes(n)
        for kw in ({}, {"mask": True}, {"opcode": 0x0, "fin": False},
                   {"opcode": 0x9, "mask": True}):
            assert ws_encode_frame(payload, **kw) == \
                jbridge.ws_encode_frame(payload, **kw), (n, kw)


@pytest.mark.parametrize("mode", ["log10", "whisper"])
def test_speech_to_mel_reproduces_page_golden(mode):
    """The page's golden records (regenerated from the JAX package's
    float64 ``SpeechToMel``) from the port's float64 ``SpeechToMel`` on
    the CPU, pushed in the golden's chunks and drained like a service, at
    the page test's tolerances (``tests/test_browser_dsp.py``): idx and
    va equal, lo / hi within 1e-6, u8 within one step on at most 0.5% of
    entries, the whisper-mode mel within 1e-9."""
    from melspec_tpu_torch.ops.quant import quantize
    from melspec_tpu_torch.streaming.speech_to_mel import SpeechToMel

    g = json.loads(GOLDEN.read_text())
    x = np.asarray(g["samples"], np.float32)
    stm = SpeechToMel(g["fft_size"], g["hop_size"], float(g["sample_rate"]),
                      g["n_mels"], dtype=torch.float64, device="cpu")
    recs = []

    def collect(r):
        if not r.get("ok"):
            return
        va = bool(r.get("va", False))
        if mode == "log10":
            recs.append((r["idx"], va, float(r["min"]), float(r["max"]),
                         np.asarray(r["frame"]).reshape(-1), None))
            return
        # the whisper record: this frame's log10 column (the window is
        # still in _hop_buf), normalized, then quantized
        log_mel = np.asarray(stm._step(stm._hop_buf, False)[0], np.float64)
        norm = (np.maximum(log_mel, log_mel.max() - 8.0) + 4.0) / 4.0
        q, qr = quantize(norm)
        recs.append((r["idx"], va, float(qr.min), float(qr.max),
                     q.reshape(-1), norm))

    for off in range(0, len(x), g["chunk"]):
        collect(stm.add(x[off : off + g["chunk"]]))
        while stm.pending:
            collect(stm.get())

    want = g[mode]
    assert len(recs) == len(want) > 0
    q_diff = 0
    for (idx, va, lo, hi, q, mel), w in zip(recs, want):
        assert idx == w["idx"] and va == w["va"]
        assert abs(lo - w["lo"]) <= 1e-6 and abs(hi - w["hi"]) <= 1e-6
        d = np.abs(q.astype(int) - np.asarray(w["q"]))
        assert d.max() <= 1
        q_diff += int((d > 0).sum())
        if mel is not None:
            assert np.abs(mel - np.asarray(w["mel"])).max() <= 1e-9
    assert q_diff <= len(recs) * g["n_mels"] * 0.005


def test_golden_served_by_the_bridge():
    """The bridge serves the page's files read-only from the repository's
    ``examples/browser/``: the golden's bytes come back unchanged."""
    import urllib.request

    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{bridge.port}/test/dsp_golden.json"
        ) as r:
            assert r.status == 200
            assert r.headers["Content-Type"] == "application/json"
            assert r.read() == GOLDEN.read_bytes()
    finally:
        bridge.stop()


def test_static_routes_404_where_the_page_is_absent(monkeypatch, tmp_path):
    """Without the page's files the static routes answer 404 and the rest
    (``/stats``, ``/ws``) still serves."""
    import urllib.error
    import urllib.request

    monkeypatch.setattr(bridge_mod, "_STATIC", tmp_path / "absent")
    bridge = BrowserBridge(n_streams=2, device="cpu").start()
    try:
        for name in ("", "app.js", "test/dsp_golden.json"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{bridge.port}/{name}")
            assert err.value.code == 404
        with urllib.request.urlopen(
                f"http://127.0.0.1:{bridge.port}/stats") as r:
            assert json.loads(r.read())["n_streams"] == 2
        ws = _ws_connect(bridge.port)
        ws.close()
    finally:
        bridge.stop()


def test_bridge_default_device_raises_without_cuda(monkeypatch):
    """``BrowserBridge()`` builds its stream server on CUDA and raises on a
    host without it; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BrowserBridge(n_streams=2)
