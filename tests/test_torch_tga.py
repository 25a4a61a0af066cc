"""The port's TGA container and frame interleaving against the JAX
package on the same numpy inputs: byte for byte (both quantize on the
host in float32 with one expression tree), and the vendored goldens
re-serialized."""

import struct
from pathlib import Path

import numpy as np
import pytest

from melspec_tpu.io import tga as jtga
from melspec_tpu_torch.io import tga
from melspec_tpu_torch.ops.quant import quantize

TESTDATA = Path(__file__).resolve().parents[1] / "testdata"
GOLDENS = ["quantized_mel_golden.tga", "jfk_full_speech_chunk1_golden.tga",
           "blank/frame_23760.tga", "speech/frame_27125.tga"]


def _data(seed, n_mels, width):
    return (np.random.default_rng(seed).normal(size=n_mels * width)
            * 1.3).astype(np.float32)


@pytest.mark.parametrize("n_mels,width", [(80, 6), (128, 301), (4, 1)])
def test_tga_bytes_equal_jax(n_mels, width):
    data = _data(n_mels + width, n_mels, width)
    blob = tga.tga_8bit_data(data, n_mels)
    assert blob == jtga.tga_8bit_data(data, n_mels)
    assert len(blob) == 18 + 8 + n_mels * width
    assert struct.unpack_from("<HH", blob, 12) == (width, n_mels)
    np.testing.assert_array_equal(tga.parse_tga_8bit(blob),
                                  jtga.parse_tga_8bit(blob))


def test_constant_and_linspace_bytes_equal_jax():
    for data in (np.full(80 * 3, 0.25, np.float32),
                 np.linspace(-1.0, 1.0, 80 * 6).astype(np.float32)):
        assert tga.tga_8bit_data(data, 80) == jtga.tga_8bit_data(data, 80)


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_reserialized(name):
    """Each vendored golden parses as JAX parses it, and the dequantized
    image serializes back to JAX's bytes with the golden's pixels and
    header."""
    blob = (TESTDATA / name).read_bytes()
    mel = tga.load_tga_8bit(TESTDATA / name)
    np.testing.assert_array_equal(mel, jtga.load_tga_8bit(TESTDATA / name))
    again = tga.tga_8bit_data(mel, 80)
    assert again == jtga.tga_8bit_data(mel, 80)
    assert again[:18] == blob[:18]
    assert again[26:] == blob[26:]
    requant, qr = quantize(mel.astype(np.float32))
    assert qr.min == struct.unpack_from("<f", blob, 18)[0]
    np.testing.assert_array_equal(requant,
                                  np.frombuffer(blob, np.uint8, offset=26))
    np.testing.assert_array_equal(tga.to_array2(mel, 80),
                                  jtga.to_array2(mel, 80))


@pytest.mark.parametrize("column_major", [False, True])
@pytest.mark.parametrize("min_width", [0, 2, 10])
def test_interleave_matches_jax(column_major, min_width):
    rng = np.random.default_rng(min_width)
    frames = [rng.normal(size=(5, w)) for w in (2, 1, 3)]
    got = tga.interleave_frames(frames, column_major, min_width)
    want = jtga.interleave_frames(frames, column_major, min_width)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_interleave_rejects_bad_args():
    with pytest.raises(ValueError):
        tga.interleave_frames([], False, 0)
    with pytest.raises(ValueError):
        tga.interleave_frames([np.ones((4, 1))], False, 3)
    with pytest.raises(ValueError):
        tga.tga_8bit_data(np.zeros(81, np.float32), 80)


@pytest.mark.parametrize("stride", [4, 7, 10, 100])
def test_chunks_and_multi_blob_match_jax(stride):
    data = _data(stride, 4, 10)
    got = tga.chunk_frames_into_strides(data, 4, stride)
    want = jtga.chunk_frames_into_strides(data, 4, stride)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    wide = _data(1, 4, 100)
    assert tga.tga_8bit(wide, 4) == jtga.tga_8bit(wide, 4)


def test_save_load_roundtrip_matches_jax(tmp_path):
    frame = np.arange(80, dtype=np.float64).reshape(80, 1) / 80
    data = tga.interleave_frames([frame], False, 2)
    tga.save_tga_8bit(data, 80, tmp_path / "port.tga")
    jtga.save_tga_8bit(data, 80, tmp_path / "jax.tga")
    assert (tmp_path / "port.tga").read_bytes() == \
        (tmp_path / "jax.tga").read_bytes()
    loaded = tga.load_tga_8bit(tmp_path / "port.tga")
    q, qr = quantize(data)
    from melspec_tpu_torch.ops.quant import dequantize
    np.testing.assert_array_equal(loaded, dequantize(q, qr))
    with pytest.raises(ValueError, match="TARGA max"):
        tga.save_tga_8bit(np.zeros(tga.TGA_MAX_WIDTH, np.float32), 1,
                          tmp_path / "wide.tga")
    with pytest.raises(ValueError, match="truncated"):
        tga.parse_tga_8bit(b"\x08" * 20)
