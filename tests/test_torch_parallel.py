"""The port's scale-out package in one process (no group: the mesh of one
rank) against the JAX package on its 8-device virtual CPU mesh, on the
same numpy inputs: ``make_mesh`` / ``Mesh`` / ``shard_batch``,
``sharded_whisper_mel`` (``tests/test_sharding.py``'s bar, 1e-5),
``sharded_multistream`` and ``sharded_serving`` (also at 48 kHz) at
``tests/test_configs_broad.py``'s bars (valid exact, q within one step, at
most one VA flip a tick, lo / hi within 1e-5), whole-fleet checkpoints
read across the packages, the validation messages, and the default device
without CUDA. Several ranks: ``tests/test_torch_parallel_ranks.py``."""

import jax
import numpy as np
import pytest
import torch

from melspec_tpu import config as jconfig
from melspec_tpu import parallel as jpar
from melspec_tpu.streaming import multistream as jms
from melspec_tpu_torch import parallel as par
from melspec_tpu_torch.config import DetectionSettings, MelConfig
from melspec_tpu_torch.parallel import sharding

CPU = torch.device("cpu")
CFG = MelConfig(400, 160, 80, 16000.0)
JCFG = jconfig.MelConfig(400, 160, 80, 16000.0)
SET = dict(min_energy=0.5, min_y=3, min_x=5)
S = 16


def _mesh():
    return par.make_mesh(device="cpu")


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mesh_fields_and_shard_batch_without_group():
    mesh = _mesh()
    assert (mesh.group, mesh.axis, mesh.size, mesh.rank, mesh.device) == (
        None, "batch", 1, 0, CPU)
    assert mesh.shape == {"batch": 1}
    assert par.make_mesh(axis="x", device="cpu").shape == {"x": 1}
    assert hash(mesh) == hash(_mesh()) and mesh == _mesh()
    with pytest.raises(ValueError, match="one process"):
        sharding.Mesh(None, "batch", 2, 0, CPU)
    fn = par.shard_batch(lambda x: x * 2.0, mesh)
    y = fn(np.ones((16, 64), np.float32))
    assert isinstance(y, torch.Tensor) and y.device == CPU
    assert torch.equal(y, torch.full((16, 64), 2.0))


def test_sharded_whisper_mel_matches_jax():
    rng = np.random.default_rng(0)
    batch = (rng.normal(size=(8, 16000)) * 0.3).astype(np.float32)
    want = np.asarray(jpar.sharded_whisper_mel(jpar.make_mesh())(batch))
    got = par.sharded_whisper_mel(_mesh())(batch)
    assert got.shape == want.shape == (8, 98, 80)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("fft_impl", ["rdft", "sig"])
def test_sharded_multistream_matches_jax(fft_impl):
    """rdft against JAX's ``sharded_multistream``; sig (K1's plain version
    at offset = hop here) against JAX's sig ``MultiStreamMel`` a hop at a
    time (JAX's sharded entry point has no route choice)."""
    multi, init_fn, push_fn = par.sharded_multistream(
        _mesh(), CFG, n_streams=S, fft_impl=fft_impl)
    assert multi.n_streams == S and multi.fft_impl == fft_impl
    if fft_impl == "rdft":
        _, jinit, jpush = jpar.sharding.sharded_multistream(
            jpar.make_mesh(), JCFG, n_streams=S)
        jstate = jinit()
    else:
        ref = jms.MultiStreamMel(JCFG, S, fft_impl="sig")
        jstate = ref.init()

        def jpush(st, x, active):
            st, m, v = ref.push_many(st, x[:, None, :], active)
            return st, m[:, 0], v[:, 0]
    state = init_fn()
    rng = np.random.default_rng(2)
    checked = 0
    for t in range(4):
        chunks = (rng.normal(size=(S, 160)) * 0.2).astype(np.float32)
        active = np.ones(S, bool)
        active[3] = t != 1
        state, mels, valid = push_fn(state, chunks, active)
        jstate, jmels, jvalid = jpush(jstate, chunks, active)
        assert mels.shape == (S, 80) and valid.shape == (S,)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        v = valid.numpy()
        assert np.abs(mels.numpy()[v] - np.asarray(jmels)[v]).max(
            initial=0) <= 2e-5
        checked += int(v.sum())
    assert checked == 2 * S - 1  # the window fills after three hops


def _serving(input_rate):
    settings = DetectionSettings(**SET)
    port = par.sharded_serving(_mesh(), CFG, n_streams=S, settings=settings,
                               input_rate=input_rate)
    ref = jpar.sharded_serving(jpar.make_mesh(), JCFG, n_streams=S,
                               settings=jconfig.DetectionSettings(**SET),
                               input_rate=input_rate)
    return port, ref


def _hold(got, want) -> None:
    """``tests/test_configs_broad.py``'s bars for one tick."""
    q, lo, hi, va, valid = (t.numpy() for t in got)
    jq, jlo, jhi, jva, jvalid = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(valid, jvalid)
    assert int(np.sum(va != jva)) <= 1
    np.testing.assert_allclose(lo, jlo, atol=1e-5)
    np.testing.assert_allclose(hi, jhi, atol=1e-5)
    assert np.abs(q.astype(int) - jq.astype(int)).max() <= 1


@pytest.mark.parametrize("input_rate", [None, 48000], ids=["16k", "48k"])
def test_sharded_serving_matches_jax(input_rate):
    (front, init_fn, tick_fn), (jfront, jinit, jtick) = _serving(input_rate)
    width = front.hop_src if input_rate else 160
    state, jstate = init_fn(), jinit()
    rng = np.random.default_rng(11)
    checked = 0
    for _ in range(3):
        chunks = (rng.normal(size=(S, 4, width)) * 0.3).astype(np.float32)
        active = np.ones(S, bool)
        state, *got = tick_fn(state, chunks, active)
        jstate, *want = jtick(jstate, jax.numpy.asarray(chunks), active)
        assert got[0].dtype == torch.uint8 and got[0].shape == (S, 4, 80)
        _hold(got, want)
        checked += int(got[4].sum())
    assert checked >= S * 4


@pytest.mark.parametrize("input_rate", [None, 48000], ids=["16k", "48k"])
def test_fleet_checkpoint_across_packages(tmp_path, input_rate):
    """The port's whole-fleet file is read by JAX's ``load_state`` (an
    unsharded frontend of the fleet), JAX's by the port's sharded front;
    the port resumes bit for bit (``tests/test_configs_broad.py:231``)."""
    (front, init_fn, tick_fn), (jfront, jinit, jtick) = _serving(input_rate)
    width = front.hop_src if input_rate else 160
    rng = np.random.default_rng(17)
    a, b = ((rng.normal(size=(S, 4, width)) * 0.3).astype(np.float32)
            for _ in range(2))
    active = np.ones(S, bool)
    state, *_ = tick_fn(init_fn(), a, active)
    jstate, *_ = jtick(jinit(), jax.numpy.asarray(a), active)

    front.save_state(tmp_path / "port.npz", state)
    _, *ref = tick_fn(state, b, active)
    _, *again = tick_fn(front.load_state(tmp_path / "port.npz"), b, active)
    for r, g in zip(ref, again):
        assert torch.equal(r, g)

    from_port = jfront.load_state(tmp_path / "port.npz")
    jfront.save_state(tmp_path / "jax.npz", jstate)
    from_jax = front.load_state(tmp_path / "jax.npz")
    port_leaves, from_jax_leaves = [], []
    sharding._flatten(state, port_leaves)
    sharding._flatten(from_jax, from_jax_leaves)
    for p, pj in zip(port_leaves, jax.tree_util.tree_leaves(from_port),
                     strict=True):
        np.testing.assert_array_equal(np.asarray(pj), p.numpy())
    for j, jp in zip(jax.tree_util.tree_leaves(jstate), from_jax_leaves,
                     strict=True):
        np.testing.assert_array_equal(jp.numpy(), np.asarray(j))
    _, *got = tick_fn(from_jax, b, active)
    _, *want = jtick(jstate, jax.numpy.asarray(b), active)
    _hold(got, want)


def test_validation_messages_match_jax():
    jmesh = jpar.make_mesh()
    mesh8 = sharding.Mesh(object(), "batch", 8, 0, CPU)  # no collective runs
    for n in (12, 7):
        assert (_message(lambda: sharding._stream_axis_spec(mesh8, "batch",
                                                            n))
                == _message(lambda: jpar.sharding._stream_axis_spec(
                    jmesh, "batch", n)))
    for fn, jfn in ((par.sharded_serving, jpar.sharded_serving),
                    (par.sharded_multistream,
                     jpar.sharding.sharded_multistream)):
        assert (_message(lambda: fn(_mesh(), CFG, n_streams=8, axis="x"))
                == _message(lambda: jfn(jmesh, JCFG, n_streams=8,
                                        axis="x")))
    assert "mesh has no axis 'x'" in _message(
        lambda: par.shard_batch(abs, _mesh(), "x"))
    assert "mesh has no axis 'x'" in _message(
        lambda: par.sharded_frontend_step(_mesh(), axis="x"))
    step = par.sharded_frontend_step(_mesh(), DetectionSettings())
    jstep = jpar.sharded_frontend_step(jmesh, jconfig.DetectionSettings())
    x = np.zeros((8, 8000), np.float32)
    mask01 = np.asarray([1, 0] * 4, np.int32)
    assert _message(lambda: step(x, mask01)) == _message(
        lambda: jstep(x, mask01))
    _, _, tick_fn = par.sharded_serving(_mesh(), CFG, n_streams=8)
    with pytest.raises(ValueError, match="serves 8 of the 8"):
        tick_fn(None, np.zeros((16, 1, 160), np.float32), None)
    with pytest.raises(ValueError, match="differs from the mesh"):
        par.sharded_frontend_step(
            sharding.Mesh(None, "batch", 1, 0, torch.device("cuda")),
            device="cpu")


@pytest.mark.parametrize("call", [
    lambda: par.make_mesh(),
    lambda: par.make_mesh(device="cuda"),
    lambda: par.sharded_frontend_step(),
], ids=["mesh", "cuda", "step"])
def test_default_device_raises_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_default_device_is_the_ranks_card(monkeypatch):
    """``device=None`` on a card: ``cuda:{rank % device count}``; nothing
    runs on it here."""
    monkeypatch.setattr(sharding, "resolve_device",
                        lambda d=None: torch.device("cuda" if d is None
                                                    else d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert par.make_mesh().device == torch.device("cuda", 0)
