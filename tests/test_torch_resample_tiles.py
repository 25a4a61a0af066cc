"""K3/K4's tile geometry on the CPU (the kernel runs on the card only):
``kernels/resample.py::tile`` and the eligibility rules accept every
ratio the first version of ``csrc/resample.cu`` took, every tile fits a
block's shared memory, and a model of the kernel's walk written from its
index arithmetic covers every window once, stages every sample the taps
read (split between ``buf`` and ``chunks`` at ``la`` as the kernel splits
it) and reads shared memory without bank conflicts."""

import math

import numpy as np
import pytest
import torch

from melspec_tpu_torch.kernels import resample as kres
from melspec_tpu_torch.ops.resample import phase_matrix_rows
from melspec_tpu_torch.streaming.resample import MultiStreamResampler

RATIOS = [(1, 3), (2, 1), (1, 2), (3, 2), (7, 5)]
# a ratio whose G leaves the preferred tiles no room in bf3 (fallback)
FALLBACK_RATIO = (1, 240)


def first_version_smem(up, down, k, bf3):
    """Shared bytes of the first version's block (256 threads, 4 windows
    a thread, G and the span's slices in shared memory)."""
    groups = max(1, 256 // up)
    span = (groups * 4 - 1) * down + k
    g_len = -(-k * up * (2 if bf3 else 1) // 4) * 4
    return 4 * (g_len + span * (2 if bf3 else 1))


def sweep():
    for up in range(1, 41):
        for down in list(range(1, 41)) + [147, 160, 240, 300, 441]:
            if math.gcd(up, down) == 1 and up != down:
                yield up, down


@pytest.mark.parametrize("up,down", RATIOS)
@pytest.mark.parametrize("precision", ["highest", "bf3"])
def test_ratios_accepted_as_before(up, down, precision):
    assert kres.kernel_eligible(up, down, precision=precision)
    length = MultiStreamResampler(up, down, 1, align=160, impl="kernel",
                                  precision=precision, device="cpu")._len
    hop = 160 * down // up
    assert kres.pair_eligible(length, 4 * hop, up, down,
                              precision=precision) == (4 * hop >= length)


@pytest.mark.parametrize("precision", ["highest", "bf3"])
def test_44k_still_refused(precision):
    assert not kres.kernel_eligible(160, 441, precision=precision)
    assert not kres.pair_eligible(600, 441 * 40, 160, 441,
                                  precision=precision)
    k = phase_matrix_rows(160, 441)[0]
    assert kres.tile(160, 441, k, precision == "bf3") is None


@pytest.mark.parametrize("bf3", [False, True])
def test_accepts_every_ratio_the_first_version_took(bf3):
    n = 0
    for up, down in sweep():
        k = phase_matrix_rows(up, down)[0]
        if first_version_smem(up, down, k, bf3) <= kres.MAX_SMEM_BYTES:
            assert kres.tile(up, down, k, bf3) is not None, (up, down)
            n += 1
    assert n > 1000


@pytest.mark.parametrize("bf3", [False, True])
@pytest.mark.parametrize("shape", [(1, 1), (256, 160), (256, 640),
                                   (64, 320), (256, 80000), (7, 9600)])
def test_shared_bytes_within_a_block(bf3, shape):
    for up, down in sweep():
        k = phase_matrix_rows(up, down)[0]
        t = kres.tile(up, down, k, bf3, *shape)
        if t is None:
            continue
        assert t.smem <= kres.MAX_SMEM_BYTES
        slices = 2 if bf3 and t.r == 1 else 1
        assert t.smem == 4 * (t.g_len + t.nbuf * t.stride * slices)
        g_floats = k * up * (2 if bf3 else 1)
        if t.r == 1:  # G in shared memory
            assert t.g_len >= g_floats and t.g_len % 4 == 0
        else:  # G in the tiled kernel's parameters
            assert t.g_len == 0 and g_floats <= kres.MAX_PARAM_G
        assert t.stride == kres.slot(t.span - 1, t.r, down, t.pad) + 1
        assert t.windows % t.r == 0 and t.windows <= t.threads * t.r
        assert t.threads in kres.THREADS


def test_tiled_instances_are_the_serving_ratios():
    """The C instances' K (resample.cu's kInstances) are the phase
    matrices' row counts, and only those ratios get R = 8."""
    for up, down, k in kres.TILED:
        assert phase_matrix_rows(up, down)[0] == k
        assert 2 * k * up <= kres.MAX_PARAM_G  # bf3's g0 and g1
        t = kres.tile(up, down, k, False)
        assert (t.r, t.pad) == (kres.TILED_R, 1)
    for up, down in [(3, 2), (7, 5)]:
        k = phase_matrix_rows(up, down)[0]
        assert kres.tile(up, down, k, True).r == 1


@pytest.mark.parametrize("shape,threads,walks", [
    ((256, 80000), 64, True),    # the bulk tick: a persistent walk
    ((256, 640), 32, False),     # the 4-hop tick (K4)
    ((256, 160), 32, False),     # the 1-hop tick (K3)
    ((256, 8000), 64, True),     # 50 hops: the walk wraps
])
def test_tile_sizes_follow_the_shape(shape, threads, walks):
    t = kres.tile(1, 3, 61, False, *shape)
    assert t.threads == threads and t.windows == threads * 8
    assert (t.grid < t.items) == walks
    assert t.grid == min(t.items, 132 * (512 // threads))
    if shape[1] == 640:
        assert t.items >= kres.TILES_PER_SM * 132


def test_8k_tick_fills_a_grid():
    t = kres.tile(2, 1, 21, False, 64, 320)
    assert (t.threads, t.r, t.windows, t.grid) == (32, 8, 256, t.items)
    assert t.items == 128


def test_fallback_geometry():
    up, down = FALLBACK_RATIO
    k = phase_matrix_rows(up, down)[0]
    t = kres.tile(up, down, k, True)
    assert (t.nbuf, t.pad, t.r) == (1, 0, 1) and t.windows in (
        kres.FALLBACK_WINDOWS)
    assert kres.tile(up, down, k, False).nbuf == 2


def reads(t, up, down, k):
    """For one item: ``win [windows, K]`` span samples read by each
    window's taps, and ``addr`` the shared-memory words the kernel reads
    them from, written as csrc/resample.cu computes them (the tiled
    instances from the thread's base ``t*(C + pad)`` plus ``u + (u / C) *
    pad``, the generic one from ``(t + m) * (down + pad) + c``)."""
    j = np.arange(k)
    if t.r > 1:
        c = t.r * down
        th, rr = np.divmod(np.arange(t.windows), t.r)
        u_local = rr[:, None] * down + j[None, :]
        addr = (th[:, None] * (c + t.pad) + u_local
                + (u_local // c) * t.pad)
        win = th[:, None] * c + u_local
    else:
        th = np.arange(t.windows)
        m, cc = np.divmod(j, down)
        addr = (th[:, None] + m[None, :]) * (down + t.pad) + cc[None, :]
        win = th[:, None] * down + j[None, :]
    return win, addr


def model(t, up, down, k, q, a, b):
    """The kernel's walk over ``(a [S, la], b [S, lb])``: each block's
    items, each item's staged buffer (the copies' words, NaN where no
    copy wrote) and the windows each thread stores. Returns the windows
    matrix ``[S, q, K]`` gathered through the shared-memory words and the
    number of times each (stream, window) was stored."""
    s, la = a.shape
    lb = b.shape[1]
    stored = np.zeros((s, q), int)
    gathered = np.full((s, q, k), np.nan)
    walked = np.zeros(t.items, int)
    for blk in range(t.grid):
        walked[blk::t.grid] += 1
    assert (walked == 1).all()
    win, addr = reads(t, up, down, k)
    u = np.arange(t.span)
    slots = u + u // (t.r * down) * t.pad
    assert len(np.unique(slots)) == t.span and slots.max() < t.stride
    for item in range(t.items):
        st, ti = divmod(item, t.tiles)
        w0 = ti * t.windows
        i = w0 * down + u
        from_a = i < la
        from_b = ~from_a & (i - la < lb)
        vals = np.zeros(t.span)  # past the signal's end: zero-filled
        vals[from_a] = a[st, i[from_a]]
        vals[from_b] = b[st, i[from_b] - la]
        buf = np.full(t.stride, np.nan)
        buf[slots] = vals
        assert (win < t.span).all()
        w = w0 + np.arange(t.windows)
        keep = w < q
        stored[st, w[keep]] += 1
        gathered[st, w[keep]] = buf[addr[keep]]
    return gathered, stored


@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (1, 2), (3, 2),
                                     (FALLBACK_RATIO)])
@pytest.mark.parametrize("bf3", [False, True])
def test_staging_walk_keeps_the_slot(up, down, bf3):
    """The staging loop's running word ``d`` and remainder ``r``
    (resample.cu::stage: ``d += step + step / chunk * pad``, one more pad
    word where ``r`` wraps) equal ``slot(u)`` at every sample a thread
    copies."""
    k = phase_matrix_rows(up, down)[0]
    t = kres.tile(up, down, k, bf3, 256, 80000)
    chunk, step = t.r * down, t.threads
    for tid in range(step):
        u, r, d = tid, tid % chunk, tid + tid // chunk * t.pad
        while u < t.span:
            assert d == kres.slot(u, t.r, down, t.pad)
            u += step
            d += step + step // chunk * t.pad
            r += step % chunk
            if r >= chunk:
                r -= chunk
                d += t.pad


@pytest.mark.parametrize("q", [1, 159, 160, 640, 80000])
@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (1, 2), (3, 2)])
def test_plan_model_covers_every_window_once(q, up, down):
    k = phase_matrix_rows(up, down)[0]
    s = 2 if q == 80000 else 5
    length = MultiStreamResampler(up, down, 1, align=160, impl="kernel",
                                  device="cpu")._len
    n = (q - 1) * down + k - length + 3  # a few samples past the last tap
    rng = np.random.default_rng(q + up)
    a = rng.normal(size=(s, length))
    b = rng.normal(size=(s, max(n, 0)))
    t = kres.tile(up, down, k, False, s, q, 132)
    gathered, stored = model(t, up, down, k, q, a, b)
    assert (stored == 1).all()
    sig = np.concatenate([a, b], axis=1)
    want = np.lib.stride_tricks.sliding_window_view(sig, k, axis=1)[
        :, ::down][:, :q]
    np.testing.assert_array_equal(gathered, want)


@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (1, 2)])
def test_k4_split_at_la_matches_k3_over_the_concat(up, down):
    """K4's staging (``a`` before ``la``, ``b`` after) gathers the same
    windows as K3's over the concat, for every split of the signal."""
    k = phase_matrix_rows(up, down)[0]
    q = 300
    rng = np.random.default_rng(up * 10 + down)
    sig = rng.normal(size=(3, (q - 1) * down + k))
    t = kres.tile(up, down, k, False, 3, q)
    k3, _ = model(t, up, down, k, q, sig, sig[:, :0])
    for la in (0, 1, 509, 510, 511, sig.shape[1] - 1):
        k4, stored = model(t, up, down, k, q, sig[:, :la], sig[:, la:])
        assert (stored == 1).all()
        np.testing.assert_array_equal(k4, k3)


def test_fallback_model_covers_every_window_once():
    up, down = FALLBACK_RATIO
    k = phase_matrix_rows(up, down)[0]
    t = kres.tile(up, down, k, True, 2, 70)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 69 * down + k))
    gathered, stored = model(t, up, down, k, 70, a, a[:, :0])
    assert (stored == 1).all() and not np.isnan(gathered).any()


@pytest.mark.parametrize("up,down", [(1, 3), (2, 1), (1, 2), (3, 2),
                                     (7, 5), (2, 3)])
def test_lanes_read_distinct_banks(up, down):
    """At every tap, the 32 lanes of a warp read 32 different banks
    (G's words are one broadcast)."""
    k = phase_matrix_rows(up, down)[0]
    t = kres.tile(up, down, k, False, 256, 80000)
    _, addr = reads(t, up, down, k)
    lanes = np.arange(32) * t.r  # each lane's first window
    for j in range(k):
        assert len(np.unique(addr[lanes, j] % 32)) == 32, j


def test_step_decides_its_route_once(monkeypatch):
    """A kernel-route tick asks pair_eligible once and calls the
    kernel wrapper that does not ask again."""
    mr = MultiStreamResampler(1, 3, 2, align=160, impl="kernel",
                              device="cpu")
    asked = []
    real = kres.pair_eligible
    monkeypatch.setattr(kres, "pair_eligible",
                        lambda *a, **kw: asked.append(a) or real(*a, **kw))

    def refuse(*a, **kw):
        raise AssertionError("the step asked again")

    monkeypatch.setattr(kres, "resample_pair", refuse)
    monkeypatch.setattr(kres, "resample", refuse)
    active = torch.ones(2, dtype=torch.bool)
    st = mr.init()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 1920)).astype(np.float32))
    st, y = mr.step(st, x, active)
    assert len(asked) == 1 and y.shape == (2, 640)
    st, y1 = mr.step(st, x[:, :480], active)  # 1 hop: K3 over the concat
    assert len(asked) == 2 and y1.shape == (2, 160)


def test_routed_equals_the_checked_wrappers():
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.normal(size=(3, 510)).astype(np.float32))
    ch = torch.from_numpy(rng.normal(size=(3, 1920)).astype(np.float32))
    before = dict(kres.launches)
    for prec in ("highest", "bf3"):
        k4 = kres.resample_pair(buf, ch, 1, 3, 640, precision=prec)
        k3 = kres.resample(torch.cat([buf, ch], 1), 1, 3, 640,
                           precision=prec)
        assert torch.equal(kres.resample_routed(buf, ch, 1, 3, 640,
                                                precision=prec), k4)
        assert torch.equal(kres.resample_routed(
            torch.cat([buf, ch], 1), None, 1, 3, 640, precision=prec), k3)
        assert torch.equal(k3, k4)
    assert kres.launches == before
