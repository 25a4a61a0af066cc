"""The serving tick on one device: mel + streaming VAD + per-frame u8
quantization for ``S`` streams, optionally behind an ingest resampler
(port of ``melspec_tpu.streaming.serving``).

The reference's live path runs per stream and per hop on the host: one
mel column, one ``VoiceActivityDetector`` step, one quantized wire record
(``examples/browser/worker.js:42-61``, ``src/wasm.rs:95-145``,
``src/vad.rs:137-205``). Here one tick advances all ``S`` streams by
``H`` hops:

- bulk streaming mel (``streaming/multistream.py``: rdft matmuls, or K1);
- the streaming-VAD decisions over a carried history of the last
  ``min_x - 1`` frames per stream (``MultiStreamVad``);
- per-frame u8 min/max quantization (``ops/quant.quantize_frames``,
  bit-exact with the host quantizer);
- for source-rate clients (8 kHz telephony, 48 kHz media),
  ``SourceRateFrontend`` resamples first, through kernels K4 / K3.

The host receives ``n_mels`` bytes, two f32 and two flags per frame, all
outputs of a tick in one device-to-host transfer. Chunks reach the device
by a synchronous copy, so a serving loop may refill its host buffer as
soon as ``push_many`` returns.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Tuple

import numpy as np
import torch

from melspec_tpu_torch._device import resolve_device, stream_mask, to_host
from melspec_tpu_torch.config import DetectionSettings, MelConfig
from melspec_tpu_torch.kernels.sig_mel import k1_accepts
from melspec_tpu_torch.ops.mel_kernel import sig_geometry, whisper_head
from melspec_tpu_torch.ops.quant import quantize_frames
from melspec_tpu_torch.ops.resample import validate_ratio
from melspec_tpu_torch.ops.vad import streaming_decision_fields_batched
from melspec_tpu_torch.streaming.multistream import (MultiStreamMel,
                                                     MultiStreamState)
from melspec_tpu_torch.streaming.resample import (MultiResampleState,
                                                  MultiStreamResampler)
from melspec_tpu_torch.streaming.state_io import (load_stream_state,
                                                  save_stream_state)
from melspec_tpu_torch.utils.instances import shared_instance


def _frontend_meta(front: "MultiStreamFrontend") -> dict:
    cfg, s = front.config, front.vad.settings
    return {
        "kind": "MultiStreamFrontend",
        "n_streams": front.n_streams,
        "fft_size": cfg.fft_size, "hop_size": cfg.hop_size,
        "n_mels": cfg.n_mels, "sampling_rate": float(cfg.sampling_rate),
        "dtype": str(front.mel.dtype).removeprefix("torch."),
        "fft_impl": front.mel.fft_impl, "record_norm": front.record_norm,
        "vad": [float(s.min_energy), s.min_y, s.min_x, s.min_mel],
    }


def _empty_tick(n_streams: int, n_mels: int) -> tuple:
    z = np.zeros((n_streams, 0), np.float32)
    return (np.zeros((n_streams, 0, n_mels), np.uint8), z, z,
            z.astype(bool), z.astype(bool))


class VadStreamState(NamedTuple):
    """Carried state of the batched streaming VAD: the last ``min_x - 1``
    REAL mel frames per stream (tail-aligned; leading slots are zero until
    enough frames arrived) and the saturating count of real frames."""

    hist: torch.Tensor   # [S, min_x - 1, n_mels] float32
    count: torch.Tensor  # [S] int32, saturates at min_x


class MultiStreamVad:
    """Batched equivalent of feeding each stream's
    ``VoiceActivityDetector`` (reference ``src/vad.rs:137-205``) its valid
    mel frames in order.

    The decision at frame ``t`` classifies the window of the last
    ``min_x`` frames only, so the carried state per stream is the previous
    ``min_x - 1`` frames; a push of ``H`` frames computes all ``H``
    decisions with one ``streaming_decision_fields_batched`` call over
    ``concat(hist, new)``. Decisions whose window is not yet full of real
    frames are ``False`` (the host detector's ``None``, the wire record's
    ``va=0``).

    Within one push a stream's invalid frames form a PREFIX (warm-up):
    ``valid`` is ``active & (samples_seen >= fft)`` and never un-sets
    while active; a reused slot must be ``reset``.
    """

    def __init__(self, settings: DetectionSettings = DetectionSettings(),
                 n_streams: int = 16, n_mels: int = 80, device=None):
        if settings.min_x < 3:
            raise ValueError("streaming VAD needs min_x >= 3")
        if n_mels < 3:
            raise ValueError("Sobel VAD needs n_mels >= 3")
        self.device = resolve_device(device)
        self.settings = settings
        self.n_streams = n_streams
        self.n_mels = n_mels

    def init(self) -> VadStreamState:
        k = self.settings.min_x - 1
        return VadStreamState(
            hist=torch.zeros((self.n_streams, k, self.n_mels),
                             dtype=torch.float32, device=self.device),
            count=torch.zeros(self.n_streams, dtype=torch.int32,
                              device=self.device),
        )

    def _push(self, state: VadStreamState, mels: torch.Tensor,
              valid: torch.Tensor):
        """Device push: ``mels [S, H, n_mels]``, ``valid [S, H]`` ->
        ``(state, va [S, H])``."""
        min_x = self.settings.min_x
        k = min_x - 1
        h = mels.shape[1]
        seq = torch.cat([state.hist, mels.to(torch.float32)], dim=1)
        img = seq.transpose(-1, -2)                     # [S, M, k+H]
        fields = streaming_decision_fields_batched(img, self.settings)
        # a decision is real when its min_x-frame window holds only real
        # frames: prior real frames + valid new frames up to this one
        cumv = torch.cumsum(valid.to(torch.int32), dim=1, dtype=torch.int32)
        warmed = (state.count[:, None] + cumv) >= min_x
        va = fields["active"] & valid & warmed
        # history: the last k REAL frames. Eligible frames are the k hist
        # slots followed by the v valid new frames (the invalid prefix is
        # skipped); eligible element j sits at seq position j for j < k
        # and k + (H - v) + (j - k) after the gap
        v = valid.sum(dim=1, dtype=torch.int32)          # [S]
        j = v[:, None] + torch.arange(k, dtype=torch.int32,
                                      device=mels.device)[None, :]
        pos = torch.where(j < k, j, (h - v)[:, None] + j).to(torch.int64)
        hist = torch.gather(seq, 1, pos[:, :, None].expand(-1, -1,
                                                           seq.shape[2]))
        count = torch.clamp_max(state.count + v, min_x)
        return VadStreamState(hist, count), va

    def push(self, state: VadStreamState, mels, valid
             ) -> Tuple[VadStreamState, np.ndarray]:
        """``mels [S, H, n_mels]``, ``valid [S, H]`` -> ``(state, va [S, H]
        bool numpy)``."""
        mels = torch.as_tensor(mels, device=self.device)
        if mels.dim() != 3 or mels.shape[0] != self.n_streams:
            raise ValueError("mels must be [n_streams, n_hops, n_mels]")
        if mels.shape[1] == 0:
            return state, np.zeros((self.n_streams, 0), bool)
        valid = torch.as_tensor(valid, dtype=torch.bool, device=self.device)
        state, va = self._push(state, mels, valid)
        return state, to_host(va)[0]

    def reset(self, state: VadStreamState, mask) -> VadStreamState:
        mask = stream_mask(mask, self.n_streams, self.device)
        return VadStreamState(
            hist=torch.where(mask[:, None, None], 0.0, state.hist),
            count=torch.where(mask, 0, state.count),
        )


class FrontendState(NamedTuple):
    mel: MultiStreamState
    vad: VadStreamState


class MultiStreamFrontend:
    """The whole serving tick (mel, VAD decision, 8-bit quantization) for
    ``S`` streams.

    ``push_many(state, chunks [S, H, hop], active [S])`` returns
    ``(state, q [S, H, n_mels] u8, lo [S, H], hi [S, H], va [S, H],
    valid [S, H])``: what a serving loop needs to pack the wire record
    ``u32 idx | u8 va | f32 min | f32 max | u8[n_mels]``
    (``examples/browser/worker.js:52-58``) without the float mel.

    ``record_norm``: ``"whisper"`` quantizes the whisper-normalized mel
    (this repo's interchange; ``docs/PARITY.md``), ``"log10"`` the
    unnormalized log10 column as the reference wasm binding does
    (``src/wasm.rs:110-114``), rdft or bf3. The VAD consumes the normalized
    frames in both modes, as the reference's detector does.
    """

    def __init__(self, config: MelConfig = MelConfig(),
                 n_streams: int = 16,
                 settings: DetectionSettings = DetectionSettings(),
                 dtype=torch.float32, fft_impl: str = "rdft",
                 record_norm: str = "whisper", device=None):
        if record_norm not in ("whisper", "log10"):
            raise ValueError("record_norm must be 'whisper' or 'log10'")
        if record_norm == "log10" and fft_impl == "sig":
            raise ValueError(
                "record_norm='log10' needs fft_impl 'rdft' or 'bf3' "
                "(the sig kernel applies the whisper norm in-kernel)"
            )
        self.device = resolve_device(device)
        self.mel = MultiStreamMel(config, n_streams, dtype=dtype,
                                  fft_impl=fft_impl, device=self.device)
        self.vad = MultiStreamVad(settings, n_streams, config.n_mels,
                                  device=self.device)
        self.config = config
        self.n_streams = n_streams
        self.record_norm = record_norm

    def init(self) -> FrontendState:
        return FrontendState(self.mel.init(), self.vad.init())

    def _tick(self, state: FrontendState, chunks: torch.Tensor,
              active: torch.Tensor):
        """The device tick: ``(state, q, lo, hi, va, valid)`` tensors."""
        log10 = self.record_norm == "log10"
        mstate, log_mel, mels, valid = self.mel._push_many(
            state.mel, chunks, active, log10=log10)
        vstate, va = self.vad._push(state.vad, mels, valid)
        q, lo, hi = quantize_frames(log_mel if log10 else mels)
        return FrontendState(mstate, vstate), q, lo, hi, va, valid

    def push_many(self, state: FrontendState, chunks, active=None):
        chunks = self.mel._chunks(chunks)
        hop = self.config.hop_size
        ok = (chunks.shape[0] == self.n_streams) and (
            (chunks.dim() == 3 and chunks.shape[2] == hop)
            or (chunks.dim() == 2 and chunks.shape[1] % hop == 0)
        )
        if not ok:
            raise ValueError(
                "chunks must be [n_streams, n_hops, hop_size] or flat "
                "[n_streams, n_hops*hop_size]")
        n_hops = (chunks.shape[1] if chunks.dim() == 3
                  else chunks.shape[1] // hop)
        if n_hops == 0:
            return (state, *_empty_tick(self.n_streams, self.config.n_mels))
        state, *out = self._tick(state, chunks,
                                 stream_mask(active, self.n_streams,
                                             self.device))
        return (state, *to_host(*out))

    def reset(self, state: FrontendState, mask) -> FrontendState:
        return FrontendState(self.mel.reset(state.mel, mask),
                             self.vad.reset(state.vad, mask))

    # checkpoint / resume (streaming/state_io.py): every live stream's
    # carried window and VAD history across a process restart
    def state_meta(self) -> dict:
        return _frontend_meta(self)

    def save_state(self, path, state: FrontendState) -> None:
        save_stream_state(path, state, meta=self.state_meta())

    def load_state(self, path) -> FrontendState:
        return load_stream_state(path, like=self.init(),
                                 meta=self.state_meta())


class SourceRateState(NamedTuple):
    rs: MultiResampleState
    fe: FrontendState


class SourceRateFrontend:
    """The serving tick for a rate-homogeneous fleet whose clients send
    SOURCE-rate PCM (8 kHz telephony, 44.1 / 48 kHz media): resample ->
    mel -> streaming VAD -> u8 quant for all ``S`` streams on the device.

    ``push_many(state, chunks [S, H, hop_src], active)`` takes ``hop_src
    = hop * down / up`` source samples per hop and returns the
    ``MultiStreamFrontend`` output tuple. The resampler's spurious warm-up
    prefix is an exact multiple of the hop (``align=hop``) and the mel
    warm-up counter starts at ``-spurious_out``, so every VALID frame is
    the frame a plain frontend fed host-resampled audio gives
    ``spurious_out / hop`` hops earlier.

    ``resample_precision`` defaults to ``"highest"``, where the JAX
    package's default is ``"bf3"``. bf3 (three bf16 products per tap) is
    the faster branch on the TPU's matrix unit only. On an H100 the
    SIMT kernel takes about twice as long in bf3 (PERF.md), and bf3 puts
    the 8 kHz records' stopband minimum about 1e-3 from the float64
    result, against 4e-5 for ``"highest"`` (``tests/test_torch_serving.py``).
    ``"bf3"`` stays for parity with the JAX package's default.
    """

    def __init__(self, config: MelConfig = MelConfig(),
                 n_streams: int = 16, input_rate: int = 48000,
                 settings: DetectionSettings = DetectionSettings(),
                 dtype=torch.float32, fft_impl: str = "rdft",
                 record_norm: str = "whisper", beta: float = 5.0,
                 resample_impl: str = "auto",
                 resample_precision: str = "highest", device=None):
        up, down = validate_ratio(int(config.sampling_rate),
                                  int(input_rate))
        if up == down:
            raise ValueError(
                "input_rate equals the config rate; use MultiStreamFrontend"
            )
        hop = config.hop_size
        if (hop * down) % up:
            raise ValueError(
                f"one {hop}-sample hop at {config.sampling_rate:.0f} Hz is "
                f"not a whole number of samples at {input_rate} Hz"
            )
        self.device = resolve_device(device)
        self.hop_src = hop * down // up
        self.front = MultiStreamFrontend(config, n_streams, settings,
                                         dtype, fft_impl, record_norm,
                                         device=self.device)
        self.rs = MultiStreamResampler(up, down, n_streams, align=hop,
                                       beta=beta, impl=resample_impl,
                                       precision=resample_precision,
                                       device=self.device)
        assert self.rs.spurious_out % hop == 0
        self.config = config
        self.n_streams = n_streams
        self.beta = float(beta)

    def _delay_idx(self, mel_state: MultiStreamState, mask=None):
        """Start (or restart) the mel warm-up counter at ``-spurious_out``
        so frames touching the resampler's garbage prefix are never
        valid."""
        d = self.rs.spurious_out
        idx = mel_state.idx - d
        if mask is not None:
            idx = torch.where(mask, idx, mel_state.idx)
        return mel_state._replace(idx=idx)

    def init(self) -> SourceRateState:
        fe = self.front.init()
        return SourceRateState(
            self.rs.init(), FrontendState(self._delay_idx(fe.mel), fe.vad))

    def push_many(self, state: SourceRateState, chunks, active=None):
        chunks = torch.as_tensor(chunks, dtype=torch.float32,
                                 device=self.device)
        ok = (chunks.shape[0] == self.n_streams) and (
            (chunks.dim() == 3 and chunks.shape[2] == self.hop_src)
            or (chunks.dim() == 2 and chunks.shape[1] % self.hop_src == 0)
        )
        if not ok:
            raise ValueError(
                f"chunks must be [n_streams, n_hops, {self.hop_src}] or "
                f"flat [n_streams, n_hops*{self.hop_src}]")
        h = (chunks.shape[1] if chunks.dim() == 3
             else chunks.shape[1] // self.hop_src)
        if h == 0:
            return (state, *_empty_tick(self.n_streams, self.config.n_mels))
        # whole hops consume whole resampler windows: hop_src integral
        # means up | hop (gcd(up, down) = 1), so h*hop_src is a multiple
        # of down
        active = stream_mask(active, self.n_streams, self.device)
        rstate, y = self.rs.step(state.rs, chunks.reshape(self.n_streams, -1),
                                 active)
        fstate, *out = self.front._tick(state.fe, y, active)
        return (SourceRateState(rstate, fstate), *to_host(*out))

    def reset(self, state: SourceRateState, mask) -> SourceRateState:
        mask = stream_mask(mask, self.n_streams, self.device)
        fe = self.front.reset(state.fe, mask)
        return SourceRateState(
            self.rs.reset(state.rs, mask),
            FrontendState(self._delay_idx(fe.mel, mask), fe.vad))

    def state_meta(self) -> dict:
        meta = _frontend_meta(self.front)
        meta.update(kind="SourceRateFrontend",
                    up=self.rs.up, down=self.rs.down, beta=self.beta,
                    spurious_out=self.rs.spurious_out)
        return meta

    def save_state(self, path, state: SourceRateState) -> None:
        save_stream_state(path, state, meta=self.state_meta())

    def load_state(self, path) -> SourceRateState:
        return load_stream_state(path, like=self.init(),
                                 meta=self.state_meta())


def shared_frontend(config: MelConfig = MelConfig(), n_streams: int = 16,
                    settings: DetectionSettings = DetectionSettings(),
                    fft_impl: str = "rdft", record_norm: str = "whisper",
                    input_rate: int | None = None, beta: float = 5.0,
                    device=None):
    """The canonical (process-shared) serving frontend for this config:
    ``SourceRateFrontend`` when ``input_rate`` differs from the config
    rate, else ``MultiStreamFrontend``. One argument spelling keeps
    ``shared_instance``'s key stable, so :func:`calibrate_fft_impl`'s
    probe instances are the instances a server then serves with."""
    dev = resolve_device(device)
    if input_rate is not None and input_rate != int(config.sampling_rate):
        return shared_instance(
            SourceRateFrontend, config, n_streams, input_rate=input_rate,
            settings=settings, fft_impl=fft_impl, record_norm=record_norm,
            beta=beta, device=dev)
    return shared_instance(
        MultiStreamFrontend, config, n_streams, settings=settings,
        fft_impl=fft_impl, record_norm=record_norm, device=dev)


def calibrate_fft_impl(config: MelConfig = MelConfig(), n_streams: int = 16,
                       hops: int = 4,
                       settings: DetectionSettings = DetectionSettings(),
                       record_norm: str = "whisper",
                       input_rate: int | None = None, beta: float = 5.0,
                       reps: int = 3, verbose: bool = True,
                       device=None) -> str:
    """Time the serving tick's two bulk routes, ``"rdft"`` (f32 matmuls)
    and ``"sig"`` (kernel K1), at THIS deployment's tick shape on the card
    (CUDA events around a whole ``push_many``, best of ``reps`` after one
    warm-up) and return the faster one's name.

    Returns ``"rdft"`` without timing where the sig route cannot serve
    the config (``record_norm="log10"``; no geometry for (fft, hop) at
    offset = hop; K1 refuses the config's head, ``k1_accepts``, as
    ``mel_kernel.resolve_pallas_impl`` asks) or the device is the CPU
    (K1's plain version there is no measure of the kernel)."""
    dev = resolve_device(device)
    if record_norm == "log10" or dev.type != "cuda":
        return "rdft"
    if sig_geometry(config.fft_size, config.hop_size,
                    offset=config.hop_size) is None:
        return "rdft"
    head = whisper_head(config.fft_size, config.n_mels,
                        float(config.sampling_rate), torch.device("cpu"))
    if not k1_accepts(head, hop=config.hop_size):
        return "rdft"
    rng = np.random.default_rng(7)
    times = {}
    for impl in ("rdft", "sig"):
        front = shared_frontend(config, n_streams, settings, impl,
                                record_norm, input_rate, beta, device=dev)
        hop_in = getattr(front, "hop_src", config.hop_size)
        base = (rng.standard_normal((n_streams, hops, hop_in)) * 0.1
                ).astype(np.float32)
        state = front.push_many(front.init(), base)[0]  # warm-up
        best = float("inf")
        for r in range(reps):
            x = base + np.float32((r + 1) * 1e-6)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state = front.push_many(state, x)[0]
            e1.record()
            torch.cuda.synchronize(dev)
            best = min(best, e0.elapsed_time(e1) / 1e3)
        times[impl] = best
    pick = min(times, key=times.get)  # type: ignore[arg-type]
    if verbose:
        print(f"calibrate_fft_impl[{n_streams}sx{hops}h]: "
              + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in times.items())
              + f" -> {pick}", file=sys.stderr)
    return pick
