"""8-bit TGA container for quantized mel spectrograms + frame interleaving
(a copy of ``melspec_tpu.io.tga`` on the port's own quantizer; host
numpy, byte for byte the JAX package's output).

Byte-compatible with the reference's interchange format
(``src/quant.rs:15-136``): 18-byte TGA header, image type 3 (uncompressed
grayscale), 8-byte ID field storing the quantization range as two
little-endian f32s, then ``n_mels * width`` bytes of row-major pixels.
``interleave_frames`` mirrors ``src/mel.rs:480-544`` including its
even-frame-count and ``min_width`` padding rules (whisper.cpp requires an
even number of mel columns).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

from melspec_tpu_torch.ops.quant import QuantizationRange, dequantize, quantize

TGA_HEADER_LEN = 18
TGA_ID_LEN = 8
TGA_MAX_WIDTH = 0xFFFF


def interleave_frames(
    frames: Sequence[np.ndarray],
    major_column_order: bool = False,
    min_width: int = 0,
) -> np.ndarray:
    """Flatten a list of ``[n_mels, w]`` frames into one float32 vector.

    Row-major (default) is what whisper.cpp's ``set_mel`` expects: each mel
    band's full time series, band after band. Column-major is for waterfall
    images. When ``min_width > 0`` and the frame count is odd, a zero frame
    of width 1 is appended (whisper needs an even column count); if the
    combined width is below ``min_width``, a zero block pads to it.
    """
    if len(frames) == 0:
        raise ValueError("frames is empty")
    if min_width % 2 != 0:
        raise ValueError("min_width must be even")

    frames = [np.asarray(f, dtype=np.float64) for f in frames]
    n_mels = frames[0].shape[0]

    if min_width > 0 and len(frames) % 2 != 0:
        frames = frames + [np.zeros((n_mels, 1))]

    combined = sum(f.shape[1] for f in frames)
    padding = max(0, min_width - combined)
    if padding > 0:
        frames = frames + [np.zeros((n_mels, padding))]

    if major_column_order:
        # frame-major: for each frame, all its rows in order
        return np.concatenate([f.reshape(-1) for f in frames]).astype(
            np.float32)
    return np.concatenate(frames, axis=1).reshape(-1).astype(np.float32)


def tga_8bit_data(data: np.ndarray, n_mels: int) -> bytes:
    """Serialize interleaved row-major mel data to one TGA byte blob."""
    data = np.asarray(data, dtype=np.float32).reshape(-1)
    if data.size % n_mels != 0:
        # the header would declare width*n_mels pixels but the blob would
        # carry data.size bytes: a malformed image parsers reject later
        raise ValueError(
            f"data size {data.size} is not a whole number of {n_mels}-mel "
            "columns"
        )
    quantized, rng = quantize(data)
    width = data.size // n_mels
    header = bytearray(TGA_HEADER_LEN)
    header[0] = TGA_ID_LEN            # ID field length
    header[1] = 0                     # no color map
    header[2] = 3                     # uncompressed grayscale
    # bytes 3..7 color-map spec, 8..11 x/y origin: zero
    header[12:14] = struct.pack("<H", width)
    header[14:16] = struct.pack("<H", n_mels)
    header[16] = 8                    # bits per pixel
    header[17] = 0                    # descriptor
    id_field = struct.pack("<ff", rng.min, rng.max)
    return bytes(header) + id_field + quantized.tobytes()


def save_tga_8bit(data: np.ndarray, n_mels: int,
                  path: Union[str, Path]) -> None:
    """Write one TGA file; width must fit the u16 header (use ``tga_8bit``
    for longer spectrograms)."""
    data = np.asarray(data, dtype=np.float32).reshape(-1)
    if data.size // n_mels >= TGA_MAX_WIDTH:
        raise ValueError("width greater than TARGA max, use tga_8bit()")
    Path(path).write_bytes(tga_8bit_data(data, n_mels))


def tga_8bit(data: np.ndarray, n_mels: int) -> List[bytes]:
    """Chunk an arbitrarily wide spectrogram into u16-max-wide TGA blobs."""
    return [
        tga_8bit_data(chunk, n_mels)
        for chunk in chunk_frames_into_strides(data, n_mels, TGA_MAX_WIDTH)
    ]


def parse_tga_8bit(blob: bytes) -> np.ndarray:
    """Parse a TGA blob back to interleaved float32 mel data."""
    if len(blob) < TGA_HEADER_LEN + TGA_ID_LEN:
        raise ValueError("truncated TGA data")
    lo, hi = struct.unpack_from("<ff", blob, TGA_HEADER_LEN)
    pixels = np.frombuffer(blob, dtype=np.uint8,
                           offset=TGA_HEADER_LEN + TGA_ID_LEN)
    return dequantize(pixels, QuantizationRange(min=lo, max=hi))


def load_tga_8bit(path: Union[str, Path]) -> np.ndarray:
    """Load a TGA file, returning the interleaved float32 frame data."""
    return parse_tga_8bit(Path(path).read_bytes())


def chunk_frames_into_strides(
    frames: np.ndarray, n_mels: int, stride_size: int
) -> List[np.ndarray]:
    """Split row-major interleaved data into ``stride_size``-wide chunks
    (reference ``src/quant.rs:100-136``)."""
    frames = np.asarray(frames, dtype=np.float32).reshape(-1)
    width = frames.size // n_mels
    if stride_size == width:
        return [frames]
    img = frames.reshape(n_mels, width)
    return [img[y : y + stride_size, x : x + stride_size].reshape(-1)
            for y in range(0, n_mels, stride_size)
            for x in range(0, width, stride_size)]


def to_array2(frames: np.ndarray, n_mels: int) -> np.ndarray:
    """De-interleave row-major data into a float64 ``[n_mels, width]`` image
    (reference ``src/quant.rs:168-174``)."""
    frames = np.asarray(frames)
    return frames.reshape(n_mels, frames.size // n_mels).astype(np.float64)
