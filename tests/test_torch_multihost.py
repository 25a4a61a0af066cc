"""The port's input dispatch (``parallel/multihost.py``) against the JAX
package's (``tests/test_multihost.py``) on the same inputs: the static
partition, ``chunk_audio`` bit for bit (``pad_to_batch`` and the empty
host included), ``load_host_shard`` on the vendored TEN-VAD wavs with the
wrong-rate refusal, the step cache's LRU, and ``multihost_frontend`` over
a gloo group of 2 CPU processes (this file's ``__main__`` block is the
worker) against JAX's on the global batch of its 8-device mesh."""

import sys
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from melspec_tpu_torch.parallel import (make_mesh,  # noqa: E402
                                        multihost_frontend)

WAVS = sorted((ROOT / "testdata" / "ten-vad").glob("*.wav"))[:4]
CLIP = 4 * 16000
LOCAL = 8  # rows a rank; JAX's global batch holds 2 * LOCAL


def _worker(rank: int, world: int, out_dir: Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world)
    try:
        out, n_valid = multihost_frontend(make_mesh(device="cpu"), WAVS,
                                          CLIP, LOCAL)
    finally:
        dist.destroy_process_group()
    res = {k: v.numpy() for k, v in out.items()}
    res["n_valid"] = n_valid
    res["foreign_modules"] = np.asarray(sorted(
        m for m in sys.modules
        if m.split(".")[0].startswith("jax") or m.split(".")[0]
        == "melspec_tpu"), dtype=str)
    np.savez(out_dir / f"rank{rank}.npz", **res)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
    sys.exit(0)

# the worker stops above: the test side below imports JAX and pytest


import pytest  # noqa: E402

from melspec_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from melspec_tpu.parallel import multihost as jmh  # noqa: E402
from melspec_tpu_torch.config import DetectionSettings  # noqa: E402
from melspec_tpu_torch.parallel import multihost  # noqa: E402
from test_torch_parallel_ranks import BARS, collect, launch  # noqa: E402


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_shard_files_partition_matches_jax():
    paths = [f"clip{i}.wav" for i in range(37)]
    shards = [multihost.shard_files_for_host(paths, p, 5) for p in range(5)]
    assert shards == [jmh.shard_files_for_host(paths, p, 5)
                      for p in range(5)]
    flat = [p for s in shards for p in s]
    assert sorted(flat) == sorted(paths)
    sizes = [len(s) for s in shards]
    assert max(sizes) - min(sizes) <= 1
    assert multihost.shard_files_for_host(paths) == paths  # no group: 0 / 1
    assert (_message(lambda: multihost.shard_files_for_host(paths, 5, 5))
            == _message(lambda: jmh.shard_files_for_host(paths, 5, 5)))


@pytest.mark.parametrize("case", [
    dict(lengths=[1000], clip=400),
    dict(lengths=[1000], clip=400, pad=5),
    dict(lengths=[400, 7, 1201], clip=400, pad=9),
    dict(lengths=[], clip=400),
    dict(lengths=[], clip=400, pad=3),
], ids=["tail", "pad", "several", "empty_host", "empty_host_pad"])
def test_chunk_audio_bit_equal_to_jax(case):
    rng = np.random.default_rng(len(case["lengths"]))
    clips = [rng.normal(size=n).astype(np.float32) for n in case["lengths"]]
    got = multihost.chunk_audio(clips, case["clip"], case.get("pad"))
    want = jmh.chunk_audio(clips, case["clip"], case.get("pad"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_chunk_audio_overflow_message_matches_jax():
    clip = np.arange(1000, dtype=np.float32)
    assert (_message(lambda: multihost.chunk_audio([clip], 400, 2))
            == _message(lambda: jmh.chunk_audio([clip], 400, 2)))


def test_load_host_shard_matches_jax():
    for pad in (None, 12):
        got = multihost.load_host_shard(WAVS[:3], CLIP, pad_to_batch=pad,
                                        expected_rate=16000)
        want = jmh.load_host_shard(WAVS[:3], CLIP, pad_to_batch=pad,
                                   expected_rate=16000)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert (_message(lambda: multihost.load_host_shard(WAVS[:1], CLIP,
                                                       expected_rate=8000))
            == _message(lambda: jmh.load_host_shard(WAVS[:1], CLIP,
                                                    expected_rate=8000)))


@pytest.fixture
def step_cache(monkeypatch):
    """The cache emptied, with a stand-in for the step it builds."""
    built = []
    monkeypatch.setattr(multihost, "_STEP_CACHE", type(
        multihost._STEP_CACHE)())

    def build(mesh, settings, axis):
        built.append(settings)
        return object()

    monkeypatch.setattr(multihost, "sharded_frontend_step", build)
    return built


def test_step_cache_evicts_only_the_coldest(step_cache):
    mesh = make_mesh(device="cpu")
    keys = [DetectionSettings(min_energy=0.01 * i) for i in range(17)]
    steps = [multihost._cached_frontend_step(mesh, s, "batch")
             for s in keys[:16]]
    assert multihost._cached_frontend_step(mesh, keys[0], "batch") \
        is steps[0]  # a hit, and key 0 is now the warmest
    multihost._cached_frontend_step(mesh, keys[16], "batch")
    assert len(multihost._STEP_CACHE) == 16 and len(step_cache) == 17
    assert multihost._cached_frontend_step(mesh, keys[0], "batch") \
        is steps[0]
    assert multihost._cached_frontend_step(mesh, keys[2], "batch") \
        is steps[2]
    multihost._cached_frontend_step(mesh, keys[1], "batch")  # evicted
    assert len(step_cache) == 18


def test_step_cache_concurrent_misses_share_one_step(step_cache):
    mesh = make_mesh(device="cpu")
    key = DetectionSettings(min_energy=0.3)
    got, barrier = [], threading.Barrier(8)

    def worker():
        barrier.wait(timeout=30)
        got.append(multihost._cached_frontend_step(mesh, key, "batch"))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is got[0] for g in got)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("multihost")
    return collect(launch(__file__, 2, out_dir), out_dir)


@pytest.fixture(scope="module")
def global_runs():
    """On the global batch (every file in order, ``2 * LOCAL`` rows): JAX's
    ``multihost_frontend`` on its 8-device mesh, the port's in one process,
    and a float64 witness of the two ln heads (JAX's rdft Fbank and
    BatchLogMel in float64)."""
    import jax.numpy as jnp
    from melspec_tpu.config import BatchLogMelConfig, FbankConfig
    from melspec_tpu.ops.batch_logmel import BatchLogMel
    from melspec_tpu.ops.fbank import Fbank

    want, jvalid = jmh.multihost_frontend(jmake_mesh(), WAVS, CLIP,
                                          2 * LOCAL)
    one, _ = multihost_frontend(make_mesh(device="cpu"), WAVS, CLIP,
                                2 * LOCAL)
    x = jmh.load_host_shard(WAVS, CLIP, 2 * LOCAL)[0].astype(np.float64)
    f64 = {"fbank": Fbank(FbankConfig(apply_cmn=True), dtype=jnp.float64,
                          fft_impl="rdft").compute(x),
           "nemo": BatchLogMel(BatchLogMelConfig(), dtype=jnp.float64,
                               fft_impl="rdft").compute(x)}
    return ({k: np.asarray(v) for k, v in want.items()}, jvalid,
            {k: v.numpy() for k, v in one.items()},
            {k: np.asarray(v) for k, v in f64.items()})


def _by_file(two_ranks):
    """``(rank, rank rows, global rows)`` per file: rank r holds files r,
    r + 2, ... (round robin), the global batch every file in order."""
    rows = [(n - 1) // CLIP + 1 for n in
            (len(multihost.read_wav_mono(w)[0]) for w in WAVS)]
    start = np.cumsum([0] + rows)
    seen = [0, 0]
    out = []
    for f, n in enumerate(rows):
        r = f % 2
        out.append((r, slice(seen[r], seen[r] + n),
                    slice(start[f], start[f] + n)))
        seen[r] += n
    for r, got in enumerate(two_ranks):
        assert (got["n_valid"][seen[r]:] == 0).all()  # pad rows
    return out


@pytest.mark.parametrize("against", ["jax", "one_rank"])
def test_multihost_frontend_two_ranks(two_ranks, global_runs, against):
    """Two ranks' rows against JAX's global batch and against the port's
    one-process run of every file: whisper mel and the VAD at the step's
    bars, the summed aggregates exactly. On these real clips the ln heads
    (NeMo, fbank) of JAX's CPU route lie further from float64 (3.5e-4,
    2.7e-3) than the step's noise bars allow, so against JAX the port's
    are held no further from the float64 witness than JAX's."""
    want, jvalid, one, f64 = global_runs
    ref = want if against == "jax" else one
    flips = 0
    dist = {"nemo": [0.0, 0.0], "fbank": [0.0, 0.0]}  # port, JAX
    for r, mine, theirs in _by_file(two_ranks):
        got = two_ranks[r]
        np.testing.assert_array_equal(got["n_valid"][mine], jvalid[theirs])
        keys = ("mel",) if against == "jax" else BARS
        for key in keys:
            assert np.abs(got[key][mine] - ref[key][theirs]).max() \
                <= BARS[key], key
        flips += int((got["vad_smoothed"][mine]
                      != ref["vad_smoothed"][theirs]).sum())
        for key in ("nemo", "fbank"):
            dist[key][0] = max(dist[key][0], np.abs(
                got[key][mine] - f64[key][theirs]).max())
            dist[key][1] = max(dist[key][1], np.abs(
                want[key][theirs] - f64[key][theirs]).max())
    assert flips <= 1
    if against == "jax":  # the port's worst row no further than JAX's
        assert all(port <= jax_ for port, jax_ in dist.values()), dist
    for got in two_ranks:
        assert got["mel"].shape == (LOCAL, (CLIP - 400) // 160 + 1, 80)
        assert got["foreign_modules"].size == 0
        for key in ("vad_active_columns", "vad_total_columns"):
            assert int(got[key]) == int(ref[key])
