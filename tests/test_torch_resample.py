"""The port's resampler against the JAX package on the same numpy inputs:
host builders bit for bit, ``resample_poly`` in float64, the plain
versions of K3 / K4 against the Pallas kernels in interpret mode, and the
streaming resampler's state geometry and outputs under every ``impl``.

Tolerances: highest precision is an f32 dot of 61 / 21 taps on signals of
scale 0.3, held at the JAX tests' 2e-6; bf3 drops the x1*g1 term and
rounds x1, held at 1e-5 x scale against the float64 host result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from melspec_tpu.ops import resample as jres
from melspec_tpu.streaming import resample as jsres
from melspec_tpu_torch.kernels import resample as kres
from melspec_tpu_torch.ops import resample as res
from melspec_tpu_torch.streaming.resample import MultiStreamResampler

CPU = "cpu"
RATIOS = [(1, 3), (160, 441), (2, 1), (3, 2), (7, 5), (2, 6), (1, 2)]
KERNEL_RATIOS = [(1, 3), (2, 1), (1, 2)]


@pytest.fixture
def jax_matrix_shapes_only(monkeypatch):
    """JAX's kernel geometry builds its m-blocked phase matrix to read its
    row count; at 44.1 kHz that matrix is 56500 x 20480 float64 (9 GB).
    Give JAX an unfilled array of that shape instead (small ones stay
    real)."""
    real = jres._phase_matrix

    def shapes_only(up, down, beta, m=1):
        k, r_lo = res.phase_matrix_rows(up, down, m)
        if k * up * m <= 1 << 24:
            return real(up, down, beta, m)
        return np.empty((k, up * m)), r_lo

    monkeypatch.setattr(jres, "_phase_matrix", shapes_only)


def _noise(seed, shape, dtype=np.float32):
    return (np.random.default_rng(seed).normal(size=shape) * 0.3).astype(
        dtype)


@pytest.mark.parametrize("up,down", RATIOS)
def test_host_builders_bit_identical(up, down, jax_matrix_shapes_only):
    u, d = res.validate_ratio(up, down)
    assert (u, d) == jres.validate_ratio(up, down)
    np.testing.assert_array_equal(res.resample_filter(up, down),
                                  jres.resample_filter(up, down))
    g, r_lo = res._phase_matrix(u, d, 5.0)
    jg, jr_lo = jres._phase_matrix(u, d, 5.0)
    assert g.dtype == jg.dtype == np.float64 and r_lo == jr_lo
    np.testing.assert_array_equal(g, jg)
    for n in (0, 1, 17, 1603):
        assert (res.resample_output_len(n, up, down)
                == jres.resample_output_len(n, up, down))
    m = res.kernel_block_m(u, d)
    assert m == jres.kernel_block_m(u, d)
    for q in (m, 3 * m, m + 1):
        jgeom = jres.resample_kernel_geometry(u, d, q)
        geom = res.resample_kernel_geometry(u, d, q)
        assert geom == (None if jgeom is None else jgeom[:5])


def test_validate_ratio_rejects_what_jax_rejects():
    for args in [(0, 3), (44101, 16000)]:
        with pytest.raises(ValueError) as port:
            res.validate_ratio(*args)
        with pytest.raises(ValueError) as ref:
            jres.validate_ratio(*args)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("up,down", RATIOS)
def test_resample_poly_f64_matches_jax(up, down):
    for n in (1, 17, 1000, 1603):
        x = _noise(n + up, (2, n), np.float64)
        got = res.resample_poly(x, up, down, device=CPU)
        want = np.asarray(jres.resample_poly(x, up, down))
        assert got.dtype == torch.float64 and got.shape == want.shape
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * scale


def test_resample_poly_f32_int_and_edges():
    x = _noise(1, (3, 2, 800))
    got = res.resample_poly(x, 160, 441, device=CPU)
    want = np.asarray(jres.resample_poly(x, 160, 441))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < 1e-5
    xi = np.arange(50, dtype=np.int16)
    assert res.resample_poly(xi, 2, 1, device=CPU).dtype == torch.float32
    assert res.resample_poly(x, 3, 3, device=CPU).shape == x.shape
    assert res.resample_poly(np.zeros((2, 0)), 1, 3,
                             device=CPU).shape == (2, 0)


@pytest.mark.parametrize("up,down", [(1, 3), (160, 441), (2, 1)])
def test_streaming_resampler_matches_jax(up, down):
    x = _noise(up + down, 5000)
    port, ref = res.StreamingResampler(up, down), jres.StreamingResampler(
        up, down)
    for a, b in [(0, 333), (333, 1000), (1000, 5000)]:
        np.testing.assert_array_equal(port.push(x[a:b]), ref.push(x[a:b]))
    np.testing.assert_array_equal(port.flush(), ref.flush())


@pytest.mark.parametrize("up,down", KERNEL_RATIOS)
@pytest.mark.parametrize("precision", ["highest", "bf3"])
def test_plain_k3_k4_match_pallas_interpret(up, down, precision):
    """The plain K3 on a concat and K4 on (buf, chunks) against JAX's
    Pallas kernels (interpret mode) and the float64 result."""
    mr = MultiStreamResampler(up, down, 8, align=160, impl="kernel",
                              precision=precision, device=CPU)
    q = 512
    buf = _noise(up, (8, mr._len))
    chunks = _noise(down, (8, q * down))
    sig = np.concatenate([buf, chunks], axis=1)
    k3 = kres.resample(torch.from_numpy(sig), up, down, q,
                       precision=precision)
    k4 = kres.resample_pair(torch.from_numpy(buf), torch.from_numpy(chunks),
                            up, down, q, precision=precision)
    assert torch.equal(k3, k4) and k3.shape == (8, q * up)
    jprec = "bf3" if precision == "bf3" else None
    want = np.asarray(jres.pallas_resample_pair(
        jnp.asarray(buf), jnp.asarray(chunks), up, down, q,
        precision=jprec, interpret=True))
    g64, _ = res._phase_matrix(up, down, 5.0)
    exact = (np.lib.stride_tricks.sliding_window_view(
        sig.astype(np.float64), g64.shape[0], axis=1)[:, ::down][:, :q]
        @ g64).reshape(8, q * up)
    scale = np.abs(exact).max()
    if precision == "highest":
        assert np.abs(k3.numpy() - want).max() <= 2e-6
        assert np.abs(k3.numpy() - exact).max() <= 2e-6
    else:
        assert np.abs(k3.numpy() - exact).max() <= 1e-5 * scale
        assert np.abs(want - exact).max() <= 1e-5 * scale
        assert np.abs(k3.numpy() - want).max() <= 2e-6


def test_plain_versions_count_no_launches():
    before = dict(kres.launches)
    x = torch.from_numpy(_noise(0, (2, 2000)))
    kres.resample(x, 1, 3, 600)
    kres.resample_pair(x[:, :510], x[:, 510:], 1, 3, 400)
    assert kres.launches == before


def test_eligibility_comes_from_shared_memory():
    for up, down in KERNEL_RATIOS + [(3, 2), (7, 5)]:
        assert kres.kernel_eligible(up, down, precision="bf3")
    # 44.1 kHz -> 16 kHz: a 493 x 160 phase matrix, 315 KB in f32
    assert not kres.kernel_eligible(160, 441)
    groups, g_len, smem = kres.tile(1, 3, 61, True)
    assert groups * kres.WINDOWS == 1024 and g_len == 124
    assert smem == 4 * (124 + 2 * (1023 * 3 + 61))
    assert kres.pair_eligible(510, 1920, 1, 3)
    assert not kres.pair_eligible(510, 480, 1, 3)  # 1-hop 48 kHz tick
    with pytest.raises(ValueError, match="at least as long"):
        kres.resample_pair(torch.zeros(1, 510), torch.zeros(1, 480), 1, 3,
                           160)
    with pytest.raises(ValueError, match="shared memory"):
        kres.resample(torch.zeros(1, 5000), 160, 441, 4)
    with pytest.raises(ValueError, match="precision"):
        kres.resample(torch.zeros(1, 5000), 1, 3, 4, precision="fast")


@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (1, 2), (160, 441)])
@pytest.mark.parametrize("impl", ["auto", "conv", "frames", "kernel"])
def test_state_geometry_matches_jax(up, down, impl, jax_matrix_shapes_only):
    port = MultiStreamResampler(up, down, 2, align=160, impl=impl,
                                device=CPU)
    ref = jsres.MultiStreamResampler(up, down, 2, align=160, impl=impl)
    assert (port._len, port.spurious_out) == (ref._len, ref.spurious_out)
    assert port.spurious_out % 160 == 0


def test_spurious_out_at_8k_depends_on_impl():
    """At 8 kHz the kernel routes' longer tail doubles the warm-up."""
    kw = dict(align=160, device=CPU)
    assert MultiStreamResampler(2, 1, 2, impl="auto", **kw).spurious_out == 320
    assert MultiStreamResampler(2, 1, 2, impl="kernel",
                                **kw).spurious_out == 320
    assert MultiStreamResampler(2, 1, 2, impl="conv", **kw).spurious_out == 160


@pytest.mark.parametrize("up,down,impl", [
    (1, 3, "kernel"), (2, 1, "kernel"), (1, 2, "kernel"), (1, 3, "conv"),
    (160, 441, "conv"), (2, 1, "frames"), (1, 3, "auto"),
])
def test_multistream_resampler_matches_jax(up, down, impl):
    """Ticks from the same state (the JAX state carried over): outputs
    within 2e-6 and carried tails equal; a stream inactive on one tick
    keeps its tail; a reset restarts it."""
    s = 8
    port = MultiStreamResampler(up, down, s, align=160, impl=impl,
                                device=CPU)
    ref = jsres.MultiStreamResampler(up, down, s, align=160, impl=impl)
    jst = ref.init()
    rng = np.random.default_rng(up * 10 + down)
    n = down * 128 * 4
    jst, _ = ref.push(jst, _noise(1, (s, n)))
    pst = port.init()._replace(buf=torch.tensor(np.asarray(jst.buf)))
    for t in range(3):
        chunk = (rng.normal(size=(s, n)) * 0.3).astype(np.float32)
        active = np.ones(s, bool)
        active[t] = False
        pst, y = port.push(pst, chunk, active)
        jst, jy = ref.push(jst, chunk, active)
        assert y.shape == jy.shape == (s, n * up // down)
        assert np.abs(y[active] - jy[active]).max() <= 2e-6
        np.testing.assert_array_equal(pst.buf.numpy(), np.asarray(jst.buf))
        if t == 1:
            mask = np.asarray([True] + [False] * (s - 1))
            pst, jst = port.reset(pst, mask), ref.reset(jst, mask)
            np.testing.assert_array_equal(pst.buf.numpy(),
                                          np.asarray(jst.buf))


def test_multistream_resampler_host_prefix_parity():
    """After its spurious prefix the streaming output is the host
    StreamingResampler's, for a 1-hop chunk too (K3's plain version over
    the concat, since n = 480 < L = 510)."""
    s = 3
    for impl, n in [("kernel", 480), ("kernel", 1920), ("conv", 1920)]:
        mr = MultiStreamResampler(1, 3, s, align=160, impl=impl, device=CPU)
        x = _noise(n, (s, 6 * n))
        state, outs = mr.init(), []
        for t in range(6):
            state, y = mr.push(state, x[:, t * n:(t + 1) * n])
            outs.append(y)
        got = np.concatenate(outs, axis=1)[:, mr.spurious_out:]
        for i in range(s):
            ref = res.StreamingResampler(1, 3).push(x[i])
            m = min(got.shape[1], len(ref))
            assert m > 0
            assert np.abs(got[i, :m] - ref[:m]).max() <= 2e-6


def test_multistream_resampler_validation():
    with pytest.raises(ValueError, match="identity"):
        MultiStreamResampler(3, 3, 2, device=CPU)
    with pytest.raises(ValueError, match="precision"):
        MultiStreamResampler(1, 3, 8, precision="fast", device=CPU)
    with pytest.raises(ValueError, match="impl must be"):
        MultiStreamResampler(1, 3, 8, impl="fft", device=CPU)
    mr = MultiStreamResampler(1, 3, 2, device=CPU)
    with pytest.raises(ValueError, match="multiple of down"):
        mr.push(mr.init(), np.zeros((2, 100), np.float32))
    with pytest.raises(ValueError, match="n_streams"):
        mr.push(mr.init(), np.zeros((3, 99), np.float32))
    assert mr.push(mr.init(), np.zeros((2, 0), np.float32))[1].shape == (2, 0)
    mr = MultiStreamResampler(160, 441, 8, align=160, impl="kernel",
                              device=CPU)
    with pytest.raises(ValueError, match="no Pallas geometry"):
        mr.push(mr.init(), np.zeros((8, 441 * 128), np.float32))
