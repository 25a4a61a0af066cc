"""The port's scale-out package over real ``torch.distributed`` groups:
gloo groups of 2 and 4 CPU processes (this file's ``__main__`` block is
the worker, started once per group for the module) and one process
without a group, on the same seeded numpy inputs, held against the JAX
package on its 8-device virtual CPU mesh (``tests/test_sharding.py``,
``tests/test_multihost.py``, ``tests/test_configs_broad.py``):

- the frontend step's rank blocks, concatenated in rank order, at
  ``tests/test_torch_frontend_step.py``'s bars; its summed VAD aggregates
  equal JAX's exactly at every rank count; zero-padded tails count only
  their real frames (26 columns a 4800-sample row); a 0/1 integer mask is
  refused on every rank;
- the 48 kHz serving tick over the ranks' streams against one rank and
  JAX at ``tests/test_configs_broad.py``'s bars (the CPU's float32 sums
  change with the block's shape: 4 ranks of 2 streams land up to 6e-8
  from one rank of 8 on a frame's minimum), and its whole-fleet
  checkpoint resumed bit for bit and read by JAX's unsharded frontend;
- unequal local blocks refused on every rank.

The workers import torch, numpy and the port only (each checks).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from melspec_tpu_torch.config import DetectionSettings, MelConfig  # noqa: E402
from melspec_tpu_torch.parallel import (  # noqa: E402
    global_batch_from_local, make_mesh, sharded_frontend_step,
    sharded_serving)

STEP_SET = dict(min_energy=0.5, min_y=2, min_x=5, min_mel=0)
SERVE_SET = dict(min_energy=0.5, min_y=3, min_x=5)
CFG = (400, 160, 80, 16000.0)
ROWS, T = 8, 8000
# per-row valid samples: full rows, zero-padded tails and a pad row
COUNTS = np.asarray([8000, 4000, 8000, 0, 8000, 6000, 8000, 8000], np.int32)
TAIL_N, TAIL_T = 8, 4800  # tests/test_multihost.py:139
STREAMS, TICKS, CKPT_AT, RATE = 8, 4, 2, 48000
OUTS = ("q", "lo", "hi", "va", "valid")


def _inputs():
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(ROWS, T)) * 0.3).astype(np.float32)
    tails = np.zeros((2 * TAIL_N, TAIL_T), np.float32)
    tails[:TAIL_N] = (rng.normal(size=(TAIL_N, TAIL_T)) * 0.3).astype(
        np.float32)
    chunks = (rng.normal(size=(TICKS, STREAMS, 4, 480)) * 0.3).astype(
        np.float32)
    return x, tails, chunks


def _block(n: int, mesh) -> slice:
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def run(mesh, out_dir: Path) -> dict:
    """Everything one rank computes, as numpy arrays by name."""
    x, tails, chunks = _inputs()
    res = {}
    step = sharded_frontend_step(mesh, DetectionSettings(**STEP_SET))
    rows = _block(ROWS, mesh)
    for k, v in step(x[rows], COUNTS[rows]).items():
        res[f"step.{k}"] = v.numpy()
    trows = _block(2 * TAIL_N, mesh)
    mask = np.arange(2 * TAIL_N) < TAIL_N
    for name, valid in (("all", None), ("masked", mask[trows])):
        out = step(tails[trows], valid)
        res[f"tail.{name}"] = np.asarray([int(out["vad_total_columns"]),
                                          int(out["vad_active_columns"])])
    try:
        step(x[rows], np.ones(rows.stop - rows.start, np.int32))
    except ValueError as e:
        res["refused_01"] = np.asarray(str(e))

    front, init_fn, tick_fn = sharded_serving(
        mesh, MelConfig(*CFG), n_streams=STREAMS,
        settings=DetectionSettings(**SERVE_SET), input_rate=RATE)
    mine = chunks[:, _block(STREAMS, mesh)]
    path = out_dir / "fleet.npz"
    state = init_fn()
    for t in range(TICKS):
        if t == CKPT_AT:
            front.save_state(path, state)
        state, *outs = tick_fn(state, mine[t], None)
        for name, v in zip(OUTS, outs):
            res[f"tick{t}.{name}"] = v.numpy()
    state = front.load_state(path)
    equal = True
    for t in range(CKPT_AT, TICKS):
        state, *outs = tick_fn(state, mine[t], None)
        equal &= all(np.array_equal(v.numpy(), res[f"tick{t}.{name}"])
                     for name, v in zip(OUTS, outs))
    res["resume_equal"] = np.asarray(equal)

    block = global_batch_from_local(mesh, x[rows])
    res["block_equal"] = np.asarray(torch.equal(block, torch.from_numpy(
        x[rows])))
    try:
        global_batch_from_local(mesh, np.zeros((mesh.rank + 1, 10)))
    except ValueError as e:
        res["unequal"] = np.asarray(str(e))
    return res


def _worker(rank: int, world: int, out_dir: Path) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank) == (world, rank), mesh
        res = run(mesh, out_dir)
    finally:
        dist.destroy_process_group()
    res["foreign_modules"] = np.asarray(sorted(
        m for m in sys.modules
        if m.split(".")[0].startswith("jax") or m.split(".")[0]
        == "melspec_tpu"), dtype=str)
    np.savez(out_dir / f"rank{rank}.npz", **res)


def launch(script: str, world: int, out_dir: Path) -> list:
    """Start ``world`` workers of ``script`` (rank, world, out_dir)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, script, str(r), str(world), str(out_dir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(ROOT)) for r in range(world)]


def collect(procs: list, out_dir: Path) -> list:
    """Wait for the workers; their outputs by rank (any failure raises
    with the workers' output)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, log[-3000:])
           for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    if bad:
        raise AssertionError(f"workers failed: {bad}")
    return [dict(np.load(out_dir / f"rank{r}.npz"))
            for r in range(len(procs))]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
    sys.exit(0)

# the worker stops above: the test side below imports JAX and pytest


import jax  # noqa: E402
import pytest  # noqa: E402

from melspec_tpu import config as jconfig  # noqa: E402
from melspec_tpu import parallel as jpar  # noqa: E402
from melspec_tpu.ops.quant import quantize as jquantize  # noqa: E402

KEYS = ("mel", "nemo", "fbank", "vad_smoothed", "vad_active_columns",
        "vad_total_columns", "mel_q8", "mel_q8_range")
BARS = {"mel": 2e-5, "nemo": 2e-4, "fbank": 2e-4}  # test_torch_frontend_step
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{world: [rank outputs]}``; the groups run while this process
    computes the one-rank case."""
    base = tmp_path_factory.mktemp("ranks")
    procs = {w: launch(__file__, w, base / f"w{w}") for w in (2, 4)}
    try:
        (base / "w1").mkdir()
        out = {1: [run(make_mesh(device="cpu"), base / "w1")]}
    finally:
        groups = {w: collect(p, base / f"w{w}") for w, p in procs.items()}
    out.update(groups)
    return out, base


@pytest.fixture(scope="module")
def ref():
    """The JAX package on its 8-device mesh, on the same inputs."""
    x, tails, chunks = _inputs()
    mesh = jpar.make_mesh()
    step = jpar.sharded_frontend_step(mesh,
                                      jconfig.DetectionSettings(**STEP_SET))
    res = {f"step.{k}": np.asarray(v) for k, v in step(x, COUNTS).items()}
    mask = np.arange(2 * TAIL_N) < TAIL_N
    for name, valid in (("all", None), ("masked", mask)):
        out = step(tails, valid)
        res[f"tail.{name}"] = np.asarray([int(out["vad_total_columns"]),
                                          int(out["vad_active_columns"])])
    front, init_fn, tick_fn = jpar.sharded_serving(
        mesh, jconfig.MelConfig(*CFG), n_streams=STREAMS,
        settings=jconfig.DetectionSettings(**SERVE_SET), input_rate=RATE)
    state = init_fn()
    active = np.ones(STREAMS, bool)
    for t in range(TICKS):
        state, *outs = tick_fn(state, jax.numpy.asarray(chunks[t]), active)
        for name, v in zip(OUTS, outs):
            res[f"tick{t}.{name}"] = np.asarray(v)
    res["serving"] = (front, tick_fn)
    return res


def _cat(outs: list, key: str) -> np.ndarray:
    return np.concatenate([o[key] for o in outs])


def _hold_tick(got: list, want: list) -> None:
    """``tests/test_configs_broad.py``'s bars for one tick."""
    q, lo, hi, va, valid = got
    jq, jlo, jhi, jva, jvalid = want
    np.testing.assert_array_equal(valid, jvalid)
    assert int(np.sum(va != jva)) <= 1
    np.testing.assert_allclose(lo, jlo, atol=1e-5)
    np.testing.assert_allclose(hi, jhi, atol=1e-5)
    assert np.abs(q.astype(int) - jq.astype(int)).max() <= 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key", KEYS)
def test_step_blocks_match_jax(ranks, ref, world, key):
    outs = ranks[0][world]
    want = ref[f"step.{key}"]
    if key in ("vad_active_columns", "vad_total_columns"):
        assert all(int(o[f"step.{key}"]) == int(want) for o in outs)
        return
    got = _cat(outs, f"step.{key}")
    if key in BARS:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got - want).max() <= BARS[key]
    elif key == "vad_smoothed":
        assert got.shape == want.shape and int((got != want).sum()) <= 1
    else:  # u8 of each rank's block: JAX's quantizer on JAX's mel rows
        b = ROWS // world
        mel = ref["step.mel"]
        for r, o in enumerate(outs):
            q, rng = jquantize(mel[r * b : (r + 1) * b])
            g = o[f"step.{key}"]
            if key == "mel_q8":
                assert g.dtype == np.uint8
                assert np.abs(g.astype(int) - q.astype(int)).max() <= 1
            else:
                assert g.shape == (1, 2)
                np.testing.assert_allclose(g[0], [rng.min, rng.max],
                                           atol=2e-5)


def test_aggregates_do_not_change_with_rank_count(ranks):
    def cols(n):  # decisions of n valid samples at 400/160
        return max((n - 400) // 160 + 1 - 2, 0) if n >= 400 else 0

    total = sum(cols(int(n)) for n in COUNTS)
    seen = {(int(o["step.vad_active_columns"]),
             int(o["step.vad_total_columns"]))
            for w in WORLDS for o in ranks[0][w]}
    assert len(seen) == 1 and seen.pop()[1] == total


@pytest.mark.parametrize("world", WORLDS)
def test_partial_tails_count_only_real_frames(ranks, ref, world):
    for o in ranks[0][world]:
        assert o["tail.all"][0] == 2 * TAIL_N * 26
        assert o["tail.masked"][0] == TAIL_N * 26  # pad rows excluded
        assert o["tail.masked"][1] <= o["tail.all"][1]
        np.testing.assert_array_equal(o["tail.all"], ref["tail.all"])
        np.testing.assert_array_equal(o["tail.masked"], ref["tail.masked"])


@pytest.mark.parametrize("world", WORLDS)
def test_01_integer_mask_refused_on_every_rank(ranks, world):
    for o in ranks[0][world]:
        assert "pass a bool array" in str(o["refused_01"])


@pytest.mark.parametrize("world", (2, 4))
def test_serving_over_ranks_matches_one_rank_and_jax(ranks, ref, world):
    one = ranks[0][1][0]
    for t in range(TICKS):
        got = [_cat(ranks[0][world], f"tick{t}.{n}") for n in OUTS]
        _hold_tick(got, [one[f"tick{t}.{n}"] for n in OUTS])
        _hold_tick(got, [ref[f"tick{t}.{n}"] for n in OUTS])
    assert _cat(ranks[0][world], f"tick{TICKS - 1}.valid").sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_fleet_checkpoint_resumes_and_jax_reads_it(ranks, ref, world):
    """Each rank resumed its rows bit for bit; JAX's unsharded frontend of
    the fleet reads rank 0's file and continues within the bars."""
    assert all(bool(o["resume_equal"]) for o in ranks[0][world])
    front, tick_fn = ref["serving"]
    state = front.load_state(ranks[1] / f"w{world}" / "fleet.npz")
    _, chunks = _inputs()[1:]
    _, *outs = tick_fn(state, jax.numpy.asarray(chunks[CKPT_AT]),
                       np.ones(STREAMS, bool))
    _hold_tick([np.asarray(v) for v in outs],
               [ref[f"tick{CKPT_AT}.{n}"] for n in OUTS])


@pytest.mark.parametrize("world", WORLDS)
def test_local_blocks_and_unequal_shapes(ranks, world):
    for o in ranks[0][world]:
        assert bool(o["block_equal"])
        if world == 1:
            assert "unequal" not in o  # no group: nothing to compare
        else:
            assert "same local block shape" in str(o["unequal"])
            assert "(1, 10)" in str(o["unequal"])


@pytest.mark.parametrize("world", (2, 4))
def test_workers_import_no_jax(ranks, world):
    assert all(o["foreign_modules"].size == 0 for o in ranks[0][world])
