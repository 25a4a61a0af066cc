"""WAV readers (copies of ``melspec_tpu.io.wav``'s ``read_wav_f32le``,
``read_wav`` and ``read_wav_mono`` and the RIFF walk they need),
``load_audio`` (read and resample to one rate) and ``iter_pcm_f32le``
(raw float32-LE PCM from a byte stream)."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from melspec_tpu_torch.ops.resample import resample_poly, validate_ratio


def _find_chunk(wav_bytes: bytes, chunk_ids: Tuple[bytes, ...]) -> Tuple[int, int]:
    """Walk the RIFF chunk list; return (payload offset, size) of the first
    chunk whose id is in ``chunk_ids``."""
    if len(wav_bytes) < 12 or wav_bytes[:4] != b"RIFF" or wav_bytes[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    while pos + 8 <= len(wav_bytes):
        chunk_id = wav_bytes[pos : pos + 4]
        (chunk_size,) = struct.unpack_from("<I", wav_bytes, pos + 4)
        if chunk_id in chunk_ids:
            return pos + 8, chunk_size
        pos += 8 + chunk_size
        if chunk_size % 2:
            pos += 1  # chunks are word-aligned
    raise ValueError(f"no {chunk_ids[0].decode(errors='replace')!r} chunk found")


def _read_fmt(wav_bytes: bytes) -> Tuple[int, int, int, int]:
    """Return (format_tag, channels, sample_rate, bits_per_sample)."""
    pos, chunk_size = _find_chunk(wav_bytes, (b"fmt ", b"fmt\x00"))
    tag, channels, rate = struct.unpack_from("<HHI", wav_bytes, pos)
    bits = struct.unpack_from("<H", wav_bytes, pos + 14)[0] \
        if chunk_size >= 16 else 0
    if tag == 0xFFFE and chunk_size >= 40:
        # WAVE_FORMAT_EXTENSIBLE: the real format tag is the first
        # two bytes of the SubFormat GUID
        (tag,) = struct.unpack_from("<H", wav_bytes, pos + 24)
    return tag, channels, rate, bits


def read_wav_f32le(path: Union[str, Path]) -> np.ndarray:
    """Read a mono float32-LE WAV; returns float32 samples. Rejects files
    whose fmt chunk declares anything else."""
    wav_bytes = Path(path).read_bytes()
    tag, _, _, bits = _read_fmt(wav_bytes)
    if tag != 3 or bits not in (0, 32):
        raise ValueError(
            f"{path}: not float32 PCM (format tag {tag}, {bits} bits)"
        )
    offset, size = _find_chunk(wav_bytes, (b"data",))
    payload = wav_bytes[offset : offset + size]
    n = len(payload) // 4
    return np.frombuffer(payload[: n * 4], dtype="<f4").copy()


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a WAV (16-bit PCM or 32-bit float, any channel count) ->
    (f32 samples ``[n, channels]``, rate). Other widths raise instead of
    being silently misdecoded."""
    wav_bytes = Path(path).read_bytes()
    tag, channels, rate, bits = _read_fmt(wav_bytes)
    if channels < 1:
        raise ValueError(f"{path}: fmt declares {channels} channels")
    offset, size = _find_chunk(wav_bytes, (b"data",))
    payload = wav_bytes[offset : offset + size]
    if tag == 1:  # integer PCM
        if bits not in (0, 16):
            raise ValueError(
                f"{path}: {bits}-bit PCM unsupported (16-bit only)"
            )
        data = np.frombuffer(payload[: (len(payload) // 2) * 2], dtype="<i2")
        data = data.astype(np.float32) / 32768.0
    elif tag == 3:  # IEEE float
        if bits not in (0, 32):
            raise ValueError(
                f"{path}: {bits}-bit float unsupported (32-bit only)"
            )
        data = np.frombuffer(payload[: (len(payload) // 4) * 4],
                             dtype="<f4").copy()
    else:
        raise ValueError(f"unsupported WAV format tag {tag}")
    n = len(data) // channels
    return data[: n * channels].reshape(n, channels), rate


def read_wav_mono(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Read a mono WAV (16-bit PCM, or 32-bit float) -> (f32 samples, rate).
    Multi-channel files raise."""
    data, rate = read_wav(path)
    if data.shape[1] != 1:
        raise ValueError(f"{path} is not mono (channels={data.shape[1]})")
    return data[:, 0], rate


def load_audio(path: Union[str, Path], target_rate: Optional[int] = 16000,
               device=None) -> np.ndarray:
    """Read a WAV as float32 mono at ``target_rate``: multi-channel files
    are downmixed (channel mean), then resampled with ``resample_poly`` on
    ``device`` (``None``: CUDA) after the rate pair is validated
    (``validate_ratio``). ``target_rate=None``, or a file already at that
    rate, returns the file's samples and touches no device."""
    data, rate = read_wav(path)
    samples = data[:, 0] if data.shape[1] == 1 \
        else data.mean(axis=1, dtype=np.float64).astype(np.float32)
    if target_rate is None or int(rate) == int(target_rate):
        return samples
    up, down = validate_ratio(int(target_rate), int(rate))
    out = resample_poly(samples, up, down, device=device)
    return out.cpu().numpy().astype(np.float32, copy=False)


def iter_pcm_f32le(stream, chunk_bytes: int = 4096):
    """Yield float32 sample blocks from a raw f32le byte stream (the
    reference examples' stdin transport, read in 4096-byte chunks). A
    trailing partial float is carried into the next block, so chunk
    boundaries never drop bytes; 1-3 dangling bytes at EOF are discarded,
    like the reference's ``chunks_exact``."""
    carry = b""
    while True:
        buf = stream.read(chunk_bytes)
        if not buf:
            return
        buf = carry + buf
        n = len(buf) // 4 * 4
        carry = buf[n:]
        if n:
            yield np.frombuffer(buf[:n], dtype="<f4")
