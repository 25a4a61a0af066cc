"""Socket serving loop: many concurrent PCM streams -> quantized mel + VAD
(port of the JAX package's ``examples/serve_streams.py``).

N concurrent TCP clients are served by one batched serving tick on the
device:

    client PCM -> per-stream native SPSC ring -> one ``pop_many`` drain
    -> [S, H, hop] bulk push (``MultiStreamFrontend.push_many``: mel +
    streaming VAD decisions (reference protocol, src/vad.rs:156-205) +
    8-bit per-frame quantization (src/quant.rs:140-152, bit-exact) for
    every hop of every stream in one tick) -> framed reply. With
    ``--device-resample`` the rings hold source-rate PCM and the tick is
    a ``SourceRateFrontend`` (kernel K4, or K3 on a tick shorter than
    the carried tail, then the mel; with ``--fft-impl sig`` the mel is
    kernel K1 at offset = hop). The host never touches the float mel: it
    packs the fetched u8 bytes, ranges and VAD bits straight into
    records.

Wire protocol (little-endian), shaped like the browser worker's mel-ring
record (n_mels quantized bytes + min/max f32 + VAD bit). The default
payload is the whisper-NORMALIZED per-frame mel; pass ``--record-norm
log10`` for the reference's unnormalized log10 column:
  client -> server: raw PCM bytes (f32le by default; --pcm-format s16le
      for int16 telephony/gateway fleets), then TCP half-close (shutdown).
  server -> client: per emitted mel frame
      u32 frame_idx | u8 va | f32 min | f32 max | u8[n_mels] quantized

Usage:
    python -m melspec_tpu_torch.examples.serve_streams --port 9377 \\
        --device-resample --input-rate 48000 --fft-impl sig &
    python -m melspec_tpu_torch.examples.serve_streams --port 9377 \\
        --input-rate 48000 --client talk.wav
Pass ``--device cpu`` on a host without CUDA.
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys
import threading
import time
from pathlib import Path

import numpy as np

from melspec_tpu_torch._device import resolve_device
from melspec_tpu_torch.config import DetectionSettings, MelConfig
from melspec_tpu_torch.examples import _cli
from melspec_tpu_torch.ops.resample import StreamingResampler, validate_ratio
from melspec_tpu_torch.runtime.ringbuffer import SampleRing, pop_many
from melspec_tpu_torch.streaming.serving import (calibrate_fft_impl,
                                                 shared_frontend)

HEADER = struct.Struct("<IBff")  # frame_idx, va, min, max


def pack_records_batch(frame_idx0: np.ndarray, q: np.ndarray,
                       lo: np.ndarray, hi: np.ndarray, va: np.ndarray,
                       mask: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Vectorized wire-record packing for a WHOLE tick (all streams).

    Assembles ``<u32 idx | u8 va | f32 min | f32 max | u8[n_mels]>`` for
    every masked ``(stream, hop)`` as one ``[m, 13 + n_mels]`` u8 matrix,
    byte for byte what a per-record ``struct.pack`` loop produces, in one
    numpy pass over the fleet. Records are ordered stream-major,
    hop-ascending, as iterating slots then hops would give.

    ``frame_idx0 [S]`` is each stream's next frame index; per-record
    indices continue it. Returns ``(bytes, counts [S])`` where stream
    ``i``'s records occupy ``sum(counts[:i]) .. sum(counts[:i+1])`` of
    the record matrix.
    """
    counts = mask.sum(axis=1)
    rows, cols = np.nonzero(mask)
    m = rows.size
    if m == 0:
        return b"", counts
    n_mels = q.shape[-1]
    rec = np.empty((m, HEADER.size + n_mels), np.uint8)
    within = (np.cumsum(mask, axis=1) - 1)[rows, cols]
    idxs = (frame_idx0[rows] + within).astype("<u4")
    rec[:, 0:4] = idxs.view(np.uint8).reshape(m, 4)
    rec[:, 4] = va[rows, cols].astype(np.uint8)
    rec[:, 5:9] = np.ascontiguousarray(
        lo[rows, cols].astype("<f4")).view(np.uint8).reshape(m, 4)
    rec[:, 9:13] = np.ascontiguousarray(
        hi[rows, cols].astype("<f4")).view(np.uint8).reshape(m, 4)
    rec[:, 13:] = q[rows, cols]
    return rec.tobytes(), counts


def decode_pcm(data: bytes, pcm_format: str) -> np.ndarray:
    """Whole-sample PCM bytes -> f32 samples. ``s16le`` scales by 1/32768
    (the usual symmetric convention: -32768 -> -1.0, 32767 -> ~0.99997)."""
    if pcm_format == "s16le":
        return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    return np.frombuffer(data, dtype="<f4").astype(np.float32, copy=False)


class _Slot:
    """One client stream: PCM ring in, framed mel records out."""

    def __init__(self, conn: socket.socket, capacity: int,
                 resampler=None):
        self.conn = conn
        self.ring = SampleRing(capacity)
        self.resampler = resampler  # owned by the recv thread only
        self.frame_idx = 0
        self.eof = False      # client finished sending
        self.closed = False   # slot fully drained and replied
        self.last_rx = time.monotonic()  # recv-thread progress marker
        self.timed_out = False
        self.backpressure_waits = 0  # recv-thread stalls on a full ring


class StreamServer:
    """Batched mel/VAD/quant serving over TCP.

    ``n_streams`` slots are advanced together by one ``push_many`` per
    tick; slots without a full ``hops_per_tick`` of audio sit out that
    tick via the active mask (the reference's drop-free ring semantics:
    nothing is consumed until a full hop exists, ``src/rb.rs:86-110``).
    ``device=None`` means CUDA and raises on a host without it; pass
    ``device="cpu"`` for the plain PyTorch tick."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 config: MelConfig = MelConfig(), n_streams: int = 16,
                 hops_per_tick: int = 4,
                 settings: DetectionSettings = DetectionSettings(),
                 record_norm: str = "whisper",
                 fft_impl: str = "rdft",
                 input_rate: int | None = None,
                 device_resample: bool = False,
                 pcm_format: str = "f32le",
                 idle_timeout_s: float | None = None,
                 send_timeout_s: float = 30.0,
                 send_buffer_bytes: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.config = config
        self.n_streams = n_streams
        # ingest sample format. "s16le" is the telephony/gateway staple
        # (pairs with --input-rate 8000): samples are decoded to f32 in
        # [-1, 1) at the recv boundary (x / 32768), so everything past
        # the ring is format-agnostic.
        if pcm_format not in ("f32le", "s16le"):
            raise ValueError("pcm_format must be 'f32le' or 's16le'")
        if device_resample and input_rate is None:
            raise ValueError(
                "--device-resample requires --input-rate (a 16 kHz fleet "
                "needs no resampler; silently ignoring the flag would "
                "process source-rate PCM on the wrong grid)")
        self.pcm_format = pcm_format
        self._itemsize = 2 if pcm_format == "s16le" else 4
        # clients may send PCM at another rate (8 k telephony, 44.1/48 k
        # sources). Two ingest modes:
        # - host (default): each slot's recv thread runs a
        #   StreamingResampler, so the tick sees config-rate audio (any
        #   valid ratio);
        # - device (--device-resample): rings hold SOURCE-rate samples and
        #   the tick is a SourceRateFrontend, resample + mel + VAD + quant
        #   on the device, no host FIR work (needs an integral source hop,
        #   which every standard rate with hop=160 has)
        self.input_rate = (None if input_rate is None
                           or input_rate == int(config.sampling_rate)
                           else int(input_rate))
        self._host_resample = self.input_rate is not None \
            and not device_resample
        if self._host_resample:
            # fail fast on a bad --input-rate (a ValueError raised later
            # in _accept_loop would silently kill the accept thread) and
            # build the polyphase matrix off the accept path
            validate_ratio(int(config.sampling_rate), self.input_rate)
            StreamingResampler(int(config.sampling_rate), self.input_rate)
        self.hops = hops_per_tick
        self.settings = settings
        # the tick's bulk route: "rdft" (float32 matmuls, the default),
        # "bf3" / "sig" (explicit picks; sig is kernel K1), or "auto": a
        # one-shot startup A/B at THIS server's tick shape on the card
        # (calibrate_fft_impl; "rdft" without timing on the CPU)
        if fft_impl not in ("rdft", "bf3", "sig", "auto"):
            raise ValueError(
                "fft_impl must be 'rdft', 'bf3', 'sig' or 'auto'")
        tick_rate = (self.input_rate
                     if self.input_rate is not None and device_resample
                     else None)
        if fft_impl == "auto":
            fft_impl = calibrate_fft_impl(
                config, n_streams, hops_per_tick, settings, record_norm,
                input_rate=tick_rate, device=self.device)
        self.fft_impl = fft_impl
        # shared_frontend: equal-config servers (and the calibration's
        # probe instances) reuse one canonical frontend
        self.frontend = shared_frontend(config, n_streams, settings,
                                        fft_impl, record_norm,
                                        input_rate=tick_rate,
                                        device=self.device)
        self.ingest_hop = (self.frontend.hop_src
                           if tick_rate is not None else config.hop_size)
        self.state = self.frontend.init()
        self.slots: list[_Slot | None] = [None] * n_streams
        # serving counters (compute thread writes, any thread reads:
        # whole-int writes under the GIL; stats() snapshots under the lock)
        self._ticks = 0
        self._frames_sent = 0
        self._clients_served = 0
        # ring counters of the slots already freed, so stats() reports
        # fleet totals over every client served
        self._retired_waits = 0
        self._retired_dropped = 0
        # a connected-but-silent client would otherwise hold its slot
        # forever (capacity denial): after idle_timeout_s without any
        # received bytes the connection is closed, which rides the normal
        # teardown (recv loop exits -> eof -> ring drains -> slot freed)
        if idle_timeout_s is not None and idle_timeout_s <= 0:
            raise ValueError("idle_timeout_s must be positive")
        self.idle_timeout_s = idle_timeout_s
        self._idle_timeouts = 0
        # sockets get a timeout so ONE client that stops reading its
        # replies cannot block sendall forever and freeze the whole
        # fleet's tick thread; a timed-out send kills that client via
        # the dead-client path. The recv side tolerates the timeout
        # (an idle-but-alive client is not EOF: idle_timeout_s governs
        # that separately).
        if send_timeout_s <= 0:
            raise ValueError("send_timeout_s must be positive")
        self.send_timeout_s = float(send_timeout_s)
        # optional SO_SNDBUF bound per connection: kernel autotuning can
        # buffer megabytes toward a stalled reader, which delays the
        # send-timeout detection by however long those megabytes take to
        # produce; a bounded buffer trades peak burst throughput for
        # prompt detection
        self.send_buffer_bytes = send_buffer_bytes
        self._pending_reset = np.zeros(n_streams, dtype=bool)
        self._slots_lock = threading.Lock()
        self._stop = threading.Event()
        self.sock = socket.create_server((host, port))
        self.port = self.sock.getsockname()[1]
        self._threads: list[threading.Thread] = []

    # ---------------- client side ----------------

    def _push_ring(self, slot: _Slot, samples: np.ndarray) -> None:
        # the slot.closed check ends the loop when the compute thread
        # frees the slot (dead client mid-reply): nothing will ever drain
        # this ring again, and the backpressure retry would spin forever
        while samples.size and not self._stop.is_set() and not slot.closed:
            pushed = slot.ring.push(samples)
            samples = samples[pushed:]
            if samples.size:
                slot.backpressure_waits += 1
                time.sleep(0.001)  # ring full: apply backpressure

    def _recv_loop(self, slot: _Slot) -> None:
        """Reader thread: client PCM (resampled at ingest if the server
        was configured with a different ``input_rate``) -> the slot's ring."""
        leftover = b""
        eof_sent = False

        def _eof():
            nonlocal eof_sent
            if not eof_sent:
                eof_sent = True
                if slot.resampler is not None:
                    # the resampler's zero-extended tail must land in the
                    # ring BEFORE eof becomes visible (same ordering rule
                    # as _tick's eof-before-length read)
                    self._push_ring(slot, slot.resampler.flush())
                slot.eof = True

        while not self._stop.is_set() and not slot.closed:
            try:
                data = slot.conn.recv(65536)
            except TimeoutError:
                continue  # idle-but-alive: the socket timeout protects
                # SENDS; idle_timeout_s (the tick) owns idle eviction
            except OSError:
                break
            if not data:
                if not slot.timed_out:
                    break  # client FIN
                # idle-evicted (SHUT_RD): signal eof once so the tick
                # thread drains the ring, then KEEP polling until the
                # slot closes: a client that resumes sending after
                # eviction queues unread bytes in the receive buffer,
                # and close() on a socket with unread data sends RST,
                # which can discard the queued reply records the
                # half-close was meant to deliver. recv keeps draining
                # that queue; the sleep avoids a hot spin on the empty-
                # queue b'' that SHUT_RD returns immediately.
                _eof()
                time.sleep(0.02)
                continue
            if slot.timed_out:
                continue  # evicted: drain-and-discard (see above)
            slot.last_rx = time.monotonic()
            data = leftover + data
            n = len(data) // self._itemsize * self._itemsize
            samples = decode_pcm(data[:n], self.pcm_format)
            leftover = data[n:]
            if slot.resampler is not None:
                samples = slot.resampler.push(samples)
            self._push_ring(slot, samples)
        _eof()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                break
            conn.settimeout(self.send_timeout_s)
            if self.send_buffer_bytes:
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                self.send_buffer_bytes)
            resampler = None
            if self._host_resample:
                resampler = StreamingResampler(
                    int(self.config.sampling_rate), self.input_rate)
            slot = _Slot(conn, capacity=self.ingest_hop * 1024,
                         resampler=resampler)
            placed = False
            with self._slots_lock:
                for i in range(self.n_streams):
                    if self.slots[i] is None:
                        self.slots[i] = slot
                        # the state reset happens on the compute thread
                        # (see _tick): only it touches self.state
                        self._pending_reset[i] = True
                        placed = True
                        break
            if not placed:
                conn.close()  # at capacity
                continue
            threading.Thread(target=self._recv_loop, args=(slot,),
                             daemon=True).start()

    # ---------------- compute side ----------------

    def _free(self, i: int, slot: _Slot) -> None:
        """Release slot ``i`` (caller holds the lock), keeping its ring
        counters in the fleet totals."""
        self._retired_waits += slot.backpressure_waits
        self._retired_dropped += slot.ring.dropped
        self.slots[i] = None
        self._clients_served += 1

    def _tick(self) -> int:
        """One serving tick: drain ready slots, bulk-push, reply."""
        hop, hops = self.ingest_hop, self.hops
        need = hop * hops
        # flat [S, hops*hop] chunk layout (push_many accepts it and the
        # [S, hops, hop] one)
        chunks = np.zeros((self.n_streams, need), dtype=np.float32)
        active = np.zeros(self.n_streams, dtype=bool)
        ticked: list[tuple[int, _Slot, int]] = []  # (slot idx, slot, hops)
        rings: list[SampleRing | None] = [None] * self.n_streams
        with self._slots_lock:
            if self._pending_reset.any():
                # hand the reset a PRIVATE copy of the flags. The JAX
                # server needs it because its reset is dispatched
                # asynchronously on a zero-copy view of the numpy buffer,
                # which the clear below rewrites before the reset runs.
                # The port's reset runs eagerly under this lock, so the
                # shared flags cannot change during it; the copy (n_streams
                # bytes) is still right: on the CPU stream_mask's
                # torch.as_tensor shares the numpy buffer's memory, so any
                # tensor the frontend kept of the mask would change with
                # the next clear.
                mask = self._pending_reset.copy()
                self._pending_reset[:] = False
                self.state = self.frontend.reset(self.state, mask)
            for i, slot in enumerate(self.slots):
                if slot is None or slot.closed:
                    continue
                # read eof BEFORE the ring length: the recv thread sets it
                # only after its final push, so this order can never see
                # eof without the tail audio (the reverse order could
                # close the slot while >= 1 hop sits in the ring)
                eof = slot.eof
                avail = len(slot.ring)
                if self.idle_timeout_s is not None and not eof \
                        and not slot.timed_out \
                        and time.monotonic() - slot.last_rx \
                        > self.idle_timeout_s:
                    # silent client: half-close the READ side only.
                    # SHUT_RD wakes the recv thread (recv returns b'') ->
                    # eof -> remaining full hops drain on later ticks and
                    # their records still go out on the intact write
                    # side -> slot freed by the eof path below. SHUT_RDWR
                    # here would discard everything still in the ring.
                    slot.timed_out = True
                    self._idle_timeouts += 1
                    try:
                        slot.conn.shutdown(socket.SHUT_RD)
                    except OSError:
                        pass
                if avail >= need:
                    rings[i] = slot.ring
                    active[i] = True
                    ticked.append((i, slot, hops))
                elif eof:
                    if avail >= hop:
                        # drain remaining full hops; the < hop leftover is
                        # never processed (reference src/rb.rs:108-110)
                        k = min(hops, avail // hop)
                        got = slot.ring.pop(k * hop)
                        chunks[i, : k * hop] = got
                        active[i] = True
                        ticked.append((i, slot, k))
                    else:
                        slot.closed = True
                        try:
                            slot.conn.shutdown(socket.SHUT_WR)
                        except OSError:
                            pass
                        try:
                            # all records for this slot were sent on prior
                            # ticks; close() still delivers queued bytes
                            slot.conn.close()
                        except OSError:
                            pass
                        self._free(i, slot)
            if any(r is not None for r in rings):
                # all full-tick slots drain in ONE native call (avail was
                # checked under this lock and only the recv thread adds,
                # so the exact pops cannot fail)
                ok = pop_many(rings, need, chunks)
                for i, r in enumerate(rings):
                    if r is None or ok[i]:
                        continue
                    # exact-pop invariant broken (a second consumer or an
                    # overwrite-mode ring got mixed in): fail CLOSED for
                    # this slot: never tick its zeroed chunk as audio,
                    # and never let the exception kill the tick thread
                    print(f"slot {i}: exact-pop invariant broken; "
                          "evicting", file=sys.stderr)
                    active[i] = False
                    ticked = [t for t in ticked if t[0] != i]
                    bad = self.slots[i]
                    if bad is not None:
                        bad.closed = True
                        try:
                            bad.conn.shutdown(socket.SHUT_RDWR)
                        except OSError:
                            pass
                        try:
                            bad.conn.close()
                        except OSError:
                            pass
                        self._free(i, bad)
        if not ticked:
            return 0
        self._ticks += 1

        # ONE push computes mel + VAD decisions + per-frame u8
        # quantization for every ticked stream and returns host numpy in
        # one device-to-host transfer; the loop below only packs bytes
        self.state, q, lo, hi, va, valid = self.frontend.push_many(
            self.state, chunks, active
        )
        sent = 0
        # pack EVERY ticked stream's records in one vectorized pass, then
        # hand each slot its byte range
        mask = np.zeros_like(valid)
        fidx0 = np.zeros(self.n_streams, np.int64)
        for i, slot, k in ticked:
            mask[i, :k] = valid[i, :k]
            fidx0[i] = slot.frame_idx
        blob, counts = pack_records_batch(fidx0, q, lo, hi, va, mask)
        rec_size = HEADER.size + self.config.n_mels
        offsets = np.concatenate([[0], np.cumsum(counts)]) * rec_size
        for i, slot, k in ticked:
            m = int(counts[i])
            slot.frame_idx += m
            sent += m
            out = blob[offsets[i] : offsets[i + 1]]
            if out:
                try:
                    slot.conn.sendall(out)
                except OSError:
                    # client died or stopped reading (the socket timeout
                    # turns a stalled sendall into TimeoutError here, so
                    # one stuck client cannot freeze the fleet's tick
                    # thread): free the slot so the index is reusable.
                    # closed=True ends the recv thread's _push_ring
                    # backpressure loop; shutdown-before-close wakes a
                    # thread blocked in recv() (close alone does not)
                    slot.closed = True
                    try:
                        slot.conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        slot.conn.close()
                    except OSError:
                        pass
                    with self._slots_lock:
                        self._free(i, slot)
        self._frames_sent += sent
        return sent

    def stats(self) -> dict:
        """Serving counters + a per-slot snapshot: the observability
        surface a deployment scrapes. Beside the JAX server's keys it
        carries ``backpressure_waits`` and ``ring_dropped`` summed over
        every slot served so far and the live ones."""
        with self._slots_lock:
            slots = [
                {"slot": i, "frames": s.frame_idx, "ring": len(s.ring),
                 "ring_dropped": s.ring.dropped,
                 # the REAL ingest-overload signal: the server's push()
                 # path never drops (backpressure retries instead), so
                 # ring_dropped stays 0 by design; stalls show up here
                 "backpressure_waits": s.backpressure_waits,
                 "eof": s.eof}
                for i, s in enumerate(self.slots) if s is not None
            ]
            return {
                "n_streams": self.n_streams,
                "in_use": len(slots),
                "ticks": self._ticks,
                "frames_sent": self._frames_sent,
                "clients_served": self._clients_served,
                "idle_timeouts": self._idle_timeouts,
                "backpressure_waits": self._retired_waits + sum(
                    s["backpressure_waits"] for s in slots),
                "ring_dropped": self._retired_dropped + sum(
                    s["ring_dropped"] for s in slots),
                "slots": slots,
            }

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            if self._tick() == 0:
                time.sleep(0.002)

    # ---------------- lifecycle ----------------

    def start(self) -> None:
        # run the tick once before accepting clients: on the card its
        # first push builds the kernels of the route (K1, K3/K4) with
        # nvcc, and the first client would otherwise wait behind it. An
        # all-inactive zero push advances no stream state.
        zeros = np.zeros((self.n_streams, self.hops, self.ingest_hop),
                         np.float32)
        self.frontend.push_many(self.state, zeros,
                                np.zeros(self.n_streams, dtype=bool))
        for target in (self._accept_loop, self._serve_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        """Stop serving. ``drain=True`` performs a graceful shutdown:
        stop accepting, keep ticking until every in-flight stream has
        been fully drained and replied (bounded by ``timeout`` seconds),
        then halt; clients that already half-closed receive every
        remaining record instead of being cut mid-stream."""
        self.sock.close()  # no new clients in either mode
        if drain:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                with self._slots_lock:
                    busy = any(s is not None for s in self.slots)
                if not busy:
                    break
                time.sleep(0.01)
        self._stop.set()
        # actively close the surviving connections: without a FIN the
        # clients would sit in recv() until their own timeouts
        with self._slots_lock:
            live = [s for s in self.slots if s is not None]
        for slot in live:
            slot.closed = True
            try:
                slot.conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                slot.conn.close()
            except OSError:
                pass


def stream_client(port: int, pcm: np.ndarray, chunk: int = 4096,
                  host: str = "127.0.0.1", timeout: float = 600.0,
                  n_mels: int = 80, pcm_format: str = "f32le"):
    """Send PCM to the server; return the parsed framed records
    ``(frame_idx, va, min, max, q u8[n_mels])``. ``n_mels`` must match
    the server's MelConfig: the record payload is that many quantized
    bytes. ``pcm_format`` must match the server's: ``s16le`` sends the
    f32 input re-quantized to int16."""
    conn = socket.create_connection((host, port))
    recs = []
    buf = b""

    def reader():
        nonlocal buf
        while True:
            try:
                data = conn.recv(65536)
            except OSError:
                return
            if not data:
                return
            buf += data

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    pcm = np.asarray(pcm, np.float32)
    if pcm_format == "s16le":
        wire = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")
    else:
        wire = pcm.astype("<f4", copy=False)
    for i in range(0, len(wire), chunk):
        conn.sendall(wire[i : i + chunk].tobytes())
    conn.shutdown(socket.SHUT_WR)
    t.join(timeout=timeout)
    if t.is_alive():
        # the reader is still appending: a silent truncated return would
        # be indistinguishable from a completed stream, and the daemon
        # thread would keep mutating buf while we slice it
        conn.close()
        raise TimeoutError(
            f"server did not finish within {timeout} s; partial "
            f"{len(buf)} bytes discarded"
        )
    conn.close()
    rec_size = HEADER.size + n_mels
    for off in range(0, len(buf) - rec_size + 1, rec_size):
        idx, va, lo, hi = HEADER.unpack(buf[off : off + HEADER.size])
        q = np.frombuffer(buf[off + HEADER.size : off + rec_size],
                          dtype=np.uint8)
        recs.append((idx, bool(va), lo, hi, q))
    return recs


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--port", type=int, default=9377)
    ap.add_argument("--n-streams", type=int, default=16)
    _cli.add_device_flag(ap)
    ap.add_argument("--client", type=Path, default=None,
                    help="act as a client: stream this wav, print stats")
    ap.add_argument("--record-norm", choices=("whisper", "log10"),
                    default="whisper",
                    help="units of the quantized record payload: "
                    "'whisper' (normalized; feeds set_mel-style "
                    "consumers) or 'log10' (the reference wasm wire "
                    "record, src/wasm.rs:110-114)")
    ap.add_argument("--fft-impl", choices=("rdft", "bf3", "sig", "auto"),
                    default="rdft",
                    help="bulk route of the serving tick: 'sig' is kernel "
                    "K1; 'auto' times one push per route at this "
                    "server's tick shape on the card and serves the "
                    "faster")
    ap.add_argument("--input-rate", type=int, default=None,
                    help="sample rate of the clients' PCM (e.g. 48000); "
                    "each stream is resampled to the mel config's rate "
                    "at ingest (polyphase, scipy-parity)")
    ap.add_argument("--send-timeout", type=float, default=30.0,
                    help="kill a client whose reply socket stays "
                    "unwritable for N seconds (a client that stops "
                    "reading would otherwise block the tick thread)")
    ap.add_argument("--idle-timeout", type=float, default=None,
                    help="free a slot whose client has sent nothing for "
                    "N seconds (a silent connection otherwise holds its "
                    "slot forever)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print a serving-stats line every N seconds "
                    "(streams in use, frames sent, ticks, clients)")
    ap.add_argument("--pcm-format", choices=("f32le", "s16le"),
                    default="f32le",
                    help="sample format of the clients' PCM bytes; "
                    "'s16le' is the telephony/gateway staple (pairs "
                    "with --input-rate 8000). Applies to client mode "
                    "too (the wav is converted before sending).")
    ap.add_argument("--device-resample", action="store_true",
                    help="resample ON THE DEVICE inside the serving tick "
                    "(SourceRateFrontend: kernel K4, then mel + VAD + "
                    "quant) instead of per-stream host FIRs; requires "
                    "--input-rate with an integral source hop")
    args = ap.parse_args()
    dev = _cli.device(args)
    if args.client is not None:
        from melspec_tpu_torch.io.wav import load_audio

        # send PCM at the rate the server ingests: --input-rate if the
        # server resamples, else the mel config rate. load_audio accepts
        # any mono/stereo 16-bit or f32 wav at any rate.
        pcm = load_audio(args.client,
                         target_rate=args.input_rate or 16000, device=dev)
        recs = stream_client(args.port, pcm, pcm_format=args.pcm_format)
        va = sum(1 for r in recs if r[1])
        print(f"{len(recs)} frames, {va} voice-active")
        return
    server = StreamServer(port=args.port, n_streams=args.n_streams,
                          record_norm=args.record_norm,
                          fft_impl=args.fft_impl,
                          input_rate=args.input_rate,
                          device_resample=args.device_resample,
                          pcm_format=args.pcm_format,
                          idle_timeout_s=args.idle_timeout,
                          send_timeout_s=args.send_timeout,
                          device=dev)
    server.start()
    print(f"serving on port {server.port} ({args.n_streams} streams, "
          f"{server.fft_impl} on {dev})", flush=True)
    try:
        last = time.monotonic()
        while True:
            time.sleep(min(1.0, args.stats_interval or 1.0))
            if args.stats_interval \
                    and time.monotonic() - last >= args.stats_interval:
                s = server.stats()
                print(f"stats: {s['in_use']}/{s['n_streams']} streams | "
                      f"{s['frames_sent']} frames | {s['ticks']} ticks | "
                      f"{s['clients_served']} clients served", flush=True)
                last = time.monotonic()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
