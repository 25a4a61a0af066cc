"""Browser front-end for the port's streaming mel/VAD service (port of the
JAX package's ``examples/browser/server.py``).

The page only captures PCM and draws; compute lives in the batched
``StreamServer`` (``melspec_tpu_torch.examples.serve_streams``: one tick
advances every connected stream on the device). This module is the
bridge:

    mic -> AudioWorklet -> WebSocket (binary f32le PCM)
        -> [this bridge] -> StreamServer TCP slot
        -> wire records back -> WebSocket -> canvas waterfall + VAD dot

Non-browser clients (telephony/media gateways) can declare their stream's
shape per connection: ``/ws?rate=8000&fmt=s16`` ingests int16 PCM at
8 kHz, decoded and resampled at this edge, so the stream server always
sees config-rate f32.

It is a dependency-free stdlib implementation: a tiny HTTP static server
(COOP/COEP headers like the reference's ``server.js:5-10``) serving the
page's files read-only from ``examples/browser/`` at the repository root
(where they are absent, those routes answer 404), plus an RFC 6455
WebSocket endpoint at ``/ws``. Each WebSocket client gets its own TCP
connection to the StreamServer; mel records stream back verbatim
(``<u32 frame_idx | u8 va | f32 min | f32 max | u8[n_mels]>``).

Usage:
    python -m melspec_tpu_torch.examples.browser.server  # localhost:8137
    python -m melspec_tpu_torch.examples.browser.server --n-streams 32 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.examples.serve_streams import (HEADER, StreamServer,
                                                      decode_pcm)
from melspec_tpu_torch.ops.resample import StreamingResampler, validate_ratio

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
# the page's static files (index.html, app.js, worklet.js, dsp.js, test/)
_STATIC = _cli.REPO / "examples" / "browser"
_MIME = {".html": "text/html", ".js": "text/javascript",
         ".css": "text/css", ".png": "image/png",
         ".json": "application/json"}


def ws_accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _xor_mask(payload: bytes, mk: bytes) -> bytes:
    """Vectorized RFC 6455 masking: every client frame is masked, so the
    unmask runs on the hot PCM ingest path."""
    if not payload:
        return payload
    reps = -(-len(payload) // 4)
    key = np.frombuffer(mk * reps, np.uint8)[: len(payload)]
    return (np.frombuffer(payload, np.uint8) ^ key).tobytes()


def ws_encode_frame(payload: bytes, opcode: int = 0x2,
                    mask: bool = False, fin: bool = True) -> bytes:
    """Encode one WebSocket frame. Servers send unmasked; clients (the
    tests' synthetic mic) must mask (RFC 6455 §5.3). ``fin=False`` starts
    a fragmented message (continue with opcode 0x0)."""
    head = bytes([(0x80 if fin else 0x00) | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head += bytes([mbit | n])
    elif n < 1 << 16:
        head += bytes([mbit | 126]) + struct.pack(">H", n)
    else:
        head += bytes([mbit | 127]) + struct.pack(">Q", n)
    if mask:
        mk = b"\x00\x01\x02\x03"  # deterministic mask is RFC-legal
        head += mk
        payload = _xor_mask(payload, mk)
    return head + payload


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("websocket peer closed")
        buf += chunk
    return buf


def ws_read_frame(sock: socket.socket, max_payload: int = 1 << 24):
    """Read one frame -> (opcode, payload). Raises on close/EOF.

    ``max_payload`` bounds the declared frame length BEFORE buffering:
    the length field is client-controlled (up to 2**64), and accepting it
    verbatim would let one hostile frame grow an unbounded host buffer.
    16 MiB is ~260 s of f32 mono PCM, far above any sane capture chunk.
    """
    b0, b1 = _read_exact(sock, 2)
    opcode = b0 & 0x0F
    masked = b1 & 0x80
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", _read_exact(sock, 2))
    elif n == 127:
        (n,) = struct.unpack(">Q", _read_exact(sock, 8))
    if n > max_payload:
        raise ConnectionError(f"websocket frame of {n} bytes exceeds the"
                              f" {max_payload}-byte bound")
    mk = _read_exact(sock, 4) if masked else None
    payload = _read_exact(sock, n)
    if mk:
        payload = _xor_mask(payload, mk)
    return opcode, payload


class BrowserBridge:
    """HTTP static server + ``/ws`` WebSocket endpoint bridging to the
    port's ``StreamServer``. One WebSocket client == one stream slot.
    Without ``stream_server`` the bridge builds and owns one of
    ``n_streams`` slots on ``device`` (``None``: CUDA, raising on a host
    without it)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 stream_server=None, n_streams: int = 16, device=None):
        if stream_server is None:
            stream_server = StreamServer(host=host, n_streams=n_streams,
                                         device=device)
            stream_server.start()
            self._owned = stream_server
        else:
            self._owned = None
        if getattr(stream_server, "pcm_format", "f32le") != "f32le":
            raise ValueError(
                "BrowserBridge forwards f32le PCM to the stream server; "
                "per-client formats are handled at the ws edge (?fmt=s16)"
            )
        if getattr(stream_server, "input_rate", None) is not None:
            raise ValueError(
                "BrowserBridge forwards config-rate PCM; wire it to a "
                "stream server without input_rate — per-client rates are "
                "handled at the ws edge (?rate=...)"
            )
        self.streams = stream_server
        # dial the stream server on the interface it actually bound (a
        # hardcoded loopback dial breaks silently for --host <LAN addr>)
        addr = stream_server.sock.getsockname()[0]
        self._tcp_addr = (
            "127.0.0.1" if addr in ("0.0.0.0", "::") else addr,
            stream_server.port,
        )
        bridge = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # UNBUFFERED request reading: with the default buffered rfile,
            # a client that sends the upgrade request and its first ws
            # frames in one write would get those frame bytes swallowed
            # into the buffer; _serve_ws reads the raw socket and would
            # start mid-stream
            rbufsize = 0

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self) -> None:
                route = self.path.split("?", 1)[0]
                if route == "/ws":
                    try:
                        bridge._serve_ws(self)
                    except OSError:
                        pass  # peer vanished mid-upgrade; thread exits
                    return
                if route == "/stats":
                    body = json.dumps(bridge.streams.stats()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                name = route.lstrip("/") or "index.html"
                target = (_STATIC / name).resolve()
                # containment: target must be _STATIC itself or under
                # _STATIC + separator (a bare prefix check would also
                # admit siblings like .../browser-other/)
                static = _STATIC.resolve()
                if not (target == static
                        or str(target).startswith(str(static) + os.sep)) \
                        or not target.is_file():
                    self.send_error(404)
                    return
                body = target.read_bytes()
                self.send_response(200)
                self.send_header("Content-Type",
                                 _MIME.get(target.suffix,
                                           "application/octet-stream"))
                self.send_header("Content-Length", str(len(body)))
                # the reference's server.js isolation headers: harmless
                # here (no SharedArrayBuffer) and they let the page be
                # compared side by side with the reference's
                self.send_header("Cross-Origin-Opener-Policy",
                                 "same-origin")
                self.send_header("Cross-Origin-Embedder-Policy",
                                 "require-corp")
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "BrowserBridge":
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._owned is not None:
            self._owned.stop()

    # ---------------- websocket side ----------------

    def _serve_ws(self, handler: BaseHTTPRequestHandler) -> None:
        key = handler.headers.get("Sec-WebSocket-Key")
        if handler.headers.get("Upgrade", "").lower() != "websocket" \
                or not key:
            handler.send_error(400, "not a websocket upgrade")
            return
        # WebSockets are not subject to CORS: without this, any page the
        # user has open could dial ws://localhost:<port>/ws and occupy
        # every stream slot. Browsers always send Origin; it must match
        # the host this page was served from. Non-browser clients
        # (gateways, tests) send no Origin and pass.
        origin = handler.headers.get("Origin")
        if origin:
            if urlsplit(origin).netloc != handler.headers.get("Host", ""):
                handler.send_error(403, "origin not allowed")
                return
        # the page reports its ACTUAL AudioContext rate (`/ws?rate=48000`;
        # engines may ignore the 16 kHz hint) and this bridge resamples
        # that client's PCM at ingest so the stream server always sees
        # config-rate audio
        resampler = None
        query = parse_qs(urlsplit(handler.path).query)
        # per-client sample format (`/ws?fmt=s16`): non-browser clients
        # (telephony gateways) send int16 PCM; it is decoded to f32 here
        # so the stream server always sees its own configured format
        fmt = query.get("fmt", ["f32"])[0].lower().removesuffix("le")
        if fmt not in ("f32", "s16"):
            handler.send_error(400, "bad fmt (f32 or s16)")
            return
        cfg_rate = int(self.streams.config.sampling_rate)
        try:
            # client-controlled: parse AND bound before construction (a
            # rate coprime with cfg_rate, e.g. ?rate=44101, would build a
            # huge polyphase matrix; validate_ratio's docstring)
            client_rate = int(float(query.get("rate", [cfg_rate])[0]))
            validate_ratio(cfg_rate, client_rate)
        except (ValueError, OverflowError):
            handler.send_error(400, "bad rate")
            return
        if client_rate != cfg_rate:
            resampler = StreamingResampler(cfg_rate, client_rate)
        sock = handler.connection
        sock.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\n"
            b"Connection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: " + ws_accept_key(key).encode()
            + b"\r\n\r\n"
        )
        handler.close_connection = True

        # one TCP slot in the stream server per websocket client
        tcp = socket.create_connection(self._tcp_addr)
        send_lock = threading.Lock()
        done = threading.Event()

        def tcp_to_ws() -> None:
            """Forward complete wire records back as binary ws frames."""
            rec = HEADER.size + self.streams.config.n_mels
            buf = b""
            try:
                while not done.is_set():
                    data = tcp.recv(65536)
                    if not data:
                        break
                    buf += data
                    if len(buf) >= rec:
                        # ship ALL complete records as ONE ws frame: the
                        # page reassembles across frame boundaries anyway
                        # (app.js), and per-record frames cost a syscall
                        # + 2-8 header bytes each at frame rate
                        n = len(buf) // rec * rec
                        with send_lock:
                            sock.sendall(ws_encode_frame(buf[:n]))
                        buf = buf[n:]
            except OSError:
                pass
            try:
                with send_lock:
                    sock.sendall(ws_encode_frame(b"", opcode=0x8))
            except OSError:
                pass
            done.set()

        reply = threading.Thread(target=tcp_to_ws, daemon=True)
        reply.start()
        # decode path: needed when samples must be touched (s16 -> f32,
        # and/or resampling); pure f32 pass-through forwards bytes as-is.
        # One decoder (serve_streams.decode_pcm) serves both ingest edges,
        # so the s16 scaling convention cannot diverge
        itemsize = 2 if fmt == "s16" else 4
        decode = fmt == "s16" or resampler is not None
        pcm_tail = b""  # sample alignment across ws frames (decode only)
        try:
            in_binary = False
            while True:
                opcode, payload = ws_read_frame(sock)
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping
                    with send_lock:
                        sock.sendall(ws_encode_frame(payload, opcode=0xA))
                    continue
                if opcode >= 0x8:  # pong/reserved control frames: RFC
                    continue       # 6455 §5.5: control frames may be
                    # interleaved in a fragmented message and MUST NOT
                    # affect its state
                # 0x0 continues a fragmented message; the only stream a
                # client sends here is binary PCM, so continuations of a
                # binary message are PCM too
                if opcode == 0x2:
                    in_binary = True
                elif opcode != 0x0:
                    in_binary = False
                if in_binary and payload:
                    if not decode:
                        tcp.sendall(payload)
                        continue
                    data = pcm_tail + payload
                    n = len(data) // itemsize * itemsize
                    pcm_tail = data[n:]
                    out = decode_pcm(data[:n], fmt + "le")
                    if resampler is not None:
                        out = resampler.push(out)
                    if out.size:
                        tcp.sendall(out.astype("<f4", copy=False).tobytes())
        except (ConnectionError, OSError):
            pass
        if resampler is not None:
            # ship the zero-extended tail before the EOF half-close
            tail = resampler.flush()
            if tail.size:
                try:
                    tcp.sendall(tail.astype("<f4", copy=False).tobytes())
                except OSError:
                    pass
        # half-close signals EOF to the stream server, which then drains
        # the slot and closes the TCP side, letting tcp_to_ws flush the
        # remaining records before the ws close frame
        try:
            tcp.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        reply.join(timeout=30)
        done.set()
        try:
            tcp.close()
        except OSError:
            pass


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8137)
    ap.add_argument("--n-streams", type=int, default=16)
    _cli.add_device_flag(ap)
    args = ap.parse_args()
    dev = _cli.device(args)

    bridge = BrowserBridge(args.host, args.port, n_streams=args.n_streams,
                           device=dev).start()
    print(f"serving http://{args.host}:{bridge.port}/ "
          f"(mel stream server on tcp:{bridge.streams.port}, {dev})",
          flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        bridge.stop()


if __name__ == "__main__":
    main()
