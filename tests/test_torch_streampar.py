"""The port's stream parallelism (ziria_tpu_torch/parallel/streampar.py)
on 8 virtual CPU entries against the JAX package's on its 8 virtual CPU
devices (tests/test_streampar.py's cases) and the port's one-device
``run_jit``: stateless, rate- and rank-changing, fast-forwarded
(``advance``), finite-memory (warm-ups added down the pipeline, windows
spanning several shards, on the entries or on the host) and batched
(dp x sp, ragged) pipelines; the halo exchange of ``sliding_parallel``.
Integer outputs bitwise, float outputs within rtol = atol = 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import ziria_tpu_torch as z
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_parallel import both, cpu_mesh
from ziria_tpu.parallel import streampar as jsp
from ziria_tpu_torch.backend.execute import run_jit
from ziria_tpu_torch.parallel import streampar as sp

TOL = dict(rtol=1e-5, atol=1e-5)


def meshes():
    return sp.stream_mesh(8, device="cpu"), jsp.stream_mesh(8)


def check(build, xs, width=None, exact=True, host=None):
    """The port's stream_parallel of `build` over `xs` against the
    reference's and the port's run_jit. With `host` (a monkeypatch),
    the host's warm-up must not run."""
    comp, jcomp = both(build)
    m, jm = meshes()
    want = run_jit(comp, xs, width=width, device="cpu")
    if host is not None:
        def boom(*a, **k):
            raise AssertionError("host warm-up used")
        host.setattr(sp, "_entry_carry_fn", lambda *a, **k: boom)
    got = sp.stream_parallel(comp, xs, m, width=width)
    if host is not None:
        host.undo()
    ref = np.asarray(jsp.stream_parallel(jcomp, xs, jm, width=width))
    assert got.shape == want.shape == ref.shape
    cmp = np.testing.assert_array_equal if exact else \
        (lambda a, b: np.testing.assert_allclose(a, b, **TOL))
    cmp(got, want)
    cmp(got, ref)


def fir(d, t, k, taps=None, name="fir"):
    """A k-tap FIR over int32 (state: the last k inputs), memory=k."""
    def step(s, x):
        s2 = t.concatenate([s[1:], t.asarray(x, dtype=t.int32)[None]]) \
            if t is jnp else torch.cat([s[1:], torch.as_tensor(
                x, dtype=torch.int32).reshape(1)])
        w = s2 if taps is None else s2 * t.asarray(taps)
        return s2, w.sum()
    return d.map_accum(step, np.zeros(k, np.int32), name=name, memory=k)


def test_stateless_rate_and_rank_changing():
    """Stateless pipelines shard with no exchange: an affine map with an
    uneven remainder, a 4 -> 1 sum, pairs to a scalar, a scalar to a
    3-vector, and a stream shorter than the mesh (the one-device
    path)."""
    rng = np.random.default_rng(3)
    check(lambda d, t: d.pipe(d.zmap(lambda x: x * 3 + 1, name="affine"),
                              d.zmap(lambda x: x % 251, name="mod")),
          np.arange(8 * 513, dtype=np.int32))
    check(lambda d, t: d.zmap(lambda v: v.sum(), in_arity=4, out_arity=1,
                              name="sum4"),
          np.arange(8 * 64 * 4 + 12, dtype=np.int32))
    check(lambda d, t: d.zmap(lambda p: p[0] * p[0] + p[1] * p[1],
                              name="mag2"),
          rng.integers(-50, 50, size=(8 * 129 + 5, 2)).astype(np.int32))
    check(lambda d, t: d.zmap(lambda x: t.stack([x, x + 1, x * 2]),
                              name="fan3"),
          np.arange(8 * 100, dtype=np.int32))
    check(lambda d, t: d.zmap(lambda x: x + 1, name="inc"),
          np.arange(5, dtype=np.int32))


def test_fast_forwarded_state():
    """advance stages: a counter (s + n), the same after fold (map into
    accum), a GF(2) LFSR advanced by a matrix power, and a pipeline of
    all three state classes (map, advance, memory)."""
    def ctr(d, t):
        return d.pipe(d.zmap(lambda x: x * 2, name="pre"),
                      d.map_accum(lambda s, x: (s + 1, x + s), 7,
                                  name="ctr", advance=lambda s, n: s + n))
    check(ctr, np.arange(8 * 300 + 13, dtype=np.int32))
    check(lambda d, t: d.fold(ctr(d, t)),
          np.arange(8 * 64 + 3, dtype=np.int32))
    M = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 0]], np.uint8)

    def mpow(n):
        r, b = np.eye(3, dtype=np.uint8), M.copy()
        while n:
            if n & 1:
                r = (r @ b) % 2
            b, n = (b @ b) % 2, n >> 1
        return r

    def lfsr(d, t):
        if t is jnp:
            def step(s, x):
                return (jnp.asarray(M, jnp.uint8) @ s) % 2, x ^ s[0]

            def adv(s, n):
                return (jnp.asarray(mpow(int(n)), jnp.uint8) @ s) % 2
        else:
            def step(s, x):
                s = torch.as_tensor(s, dtype=torch.uint8)
                return ((torch.from_numpy(M).to(torch.int32)
                         @ s.to(torch.int32)) % 2).to(torch.uint8), x ^ s[0]

            def adv(s, n):
                s = torch.as_tensor(np.asarray(s), dtype=torch.int32)
                return ((torch.from_numpy(mpow(int(n))).to(torch.int32)
                         @ s) % 2).to(torch.uint8)
        return d.map_accum(step, np.array([1, 0, 1], np.uint8),
                           name="lfsr", advance=adv)
    check(lfsr, np.random.default_rng(3).integers(
        0, 2, 8 * 100 + 5).astype(np.uint8))
    check(lambda d, t: d.pipe(
        d.zmap(lambda x: x + 1, name="inc"),
        d.map_accum(lambda s, x: (s + 1, x * s), 1, name="ctr",
                    advance=lambda s, n: s + n),
        fir(d, t, 3, name="fir3")),
        np.random.default_rng(8).integers(-9, 9, 8 * 150 + 5)
        .astype(np.int32))


def test_memory_warm_ups(monkeypatch):
    """Finite-memory stages: a 5-tap FIR; two FIRs around a rate change
    (their warm-ups add up); a 40-tap window spanning three 16-item
    shards and a 4-tap float FIR, both warmed on the entries (the host
    warm-up poisoned); a 100-tap window longer than every prefix."""
    rng = np.random.default_rng(7)
    check(lambda d, t: fir(d, t, 5, np.array([5, -4, 3, -2, 1], np.int32)),
          rng.integers(-50, 50, 8 * 200 + 11).astype(np.int32))
    check(lambda d, t: d.pipe(
        fir(d, t, 5, name="a"),
        d.zmap(lambda x: t.stack([x, -x]), in_arity=1, out_arity=2,
               name="expand"),
        fir(d, t, 5, name="b")),
        np.random.default_rng(4).integers(-100, 100, 2427).astype(np.int32))
    check(lambda d, t: fir(d, t, 40, np.arange(1, 41, dtype=np.int32) % 7
                           - 3, name="fir40"),
          (np.arange(8 * 16, dtype=np.int32) * 13) % 101, width=4,
          host=monkeypatch)
    taps = np.array([1.0, -2.0, 3.0, 0.5], np.float32)

    def ffir(d, t):
        def step(s, x):
            s2 = t.concatenate([s[1:], x[None]]) if t is jnp else \
                torch.cat([s[1:], torch.as_tensor(x).reshape(1)])
            return s2, (s2 * t.asarray(taps)).sum()
        return d.map_accum(step, np.zeros(4, np.float32), name="fir4",
                           memory=4)
    check(ffir, np.arange(8 * 64, dtype=np.float32), exact=False,
          host=monkeypatch)
    check(lambda d, t: fir(d, t, 100, name="fir100"),
          (np.arange(8 * 13, dtype=np.int32) * 7) % 53)


def test_warm_up_on_the_entry_device(monkeypatch):
    """The warm-up of `carry_at`: a 4-tap FIR at a length that leaves a
    tail after the bulk (the tail's carry warmed from the stream), then
    with the two lowerings' carry signatures made to differ (every
    shard warmed through `carry_at`, single and batched); each equal to
    run_jit and the reference exactly, and every width-1 warm-up
    lowering made on the device `carry_at` was given."""
    made = []
    real = sp.lower

    def spy(comp, width=None, target_items=8192, device="cuda"):
        if width == 1:
            made.append(device)
        return real(comp, width=width, target_items=target_items,
                    device=device)
    monkeypatch.setattr(sp, "lower", spy)
    taps = np.array([3, -1, 2, 1], np.int32)
    rng = np.random.default_rng(31)
    xs = rng.integers(-50, 50, 8 * 64 + 13).astype(np.int32)
    check(lambda d, t: fir(d, t, 4, taps), xs, width=4)
    n_tail = len(made)
    assert n_tail >= 1
    monkeypatch.setattr(sp, "_carry_sig", lambda c: object())
    check(lambda d, t: fir(d, t, 4, taps), xs, width=4)
    assert len(made) > n_tail
    comp, _jcomp = both(lambda d, t: fir(d, t, 4, taps))
    batch = rng.integers(-50, 50, (4, 4 * 32 + 9)).astype(np.int32)
    got = sp.stream_parallel_batched(comp, batch,
                                     cpu_mesh(2, 4, names=("dp", "sp")),
                                     width=4)
    for f in range(batch.shape[0]):
        np.testing.assert_array_equal(
            got[f], run_jit(comp, batch[f], width=4, device="cpu"))
    assert all(isinstance(d, torch.device) and d.type == "cpu"
               for d in made), made


def test_batched_dp_x_sp():
    """A batch over (dp 2, sp 4): stateless + advance, a memory stage
    seeded from each frame's own items (warmed on the entries), ragged
    frame lengths whose tail finishes on one device, a window wider
    than a shard, frames too short to split; each frame equal to its
    run_jit and to the reference's batch."""
    names = ("dp", "sp")
    m = cpu_mesh(2, 4, names=names)
    jm = JMesh(np.array(jax.devices()[:8]).reshape(2, 4), names)

    def run(build, batch, width=None):
        comp, jcomp = both(build)
        got = sp.stream_parallel_batched(comp, batch, m, width=width)
        ref = jsp.stream_parallel_batched(jcomp, batch, jm, width=width)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        for f in range(batch.shape[0]):
            np.testing.assert_array_equal(
                got[f], run_jit(comp, batch[f], width=width, device="cpu"))

    def aff_ctr(d, t):
        return d.pipe(d.zmap(lambda x: x * 2 + 1, name="aff"),
                      d.map_accum(lambda s, x: (s + 1, x + s), 3,
                                  name="ctr", advance=lambda s, n: s + n))
    rng = np.random.default_rng(23)
    run(aff_ctr, rng.integers(-50, 50, (6, 4 * 128)).astype(np.int32))
    for n in (4 * 128 + 97, 4 * 32 - 5):
        run(aff_ctr, rng.integers(-50, 50, (4, n)).astype(np.int32))

    def pre_fir(d, t):
        return d.pipe(d.zmap(lambda x: x * 2, name="pre"), fir(d, t, 3))
    run(pre_fir, rng.integers(-40, 40, (4, 4 * 64 + 37)).astype(np.int32))
    run(lambda d, t: fir(d, t, 12, np.array(
        [1, -2, 3, 1, -1, 2, 0, 1, -3, 2, 1, 1], np.int32), name="fir12"),
        rng.integers(-40, 40, (4, 4 * 8)).astype(np.int32), width=2)
    run(lambda d, t: d.zmap(lambda x: x * 3 - 1, name="aff"),
        np.arange(2 * 3, dtype=np.int32).reshape(2, 3))


def test_sliding_parallel_halo():
    """A 16-tap correlation over 8 shards with a 15-item halo equals the
    one-device correlation and the reference's; window 1 is a plain
    map; shards shorter than the halo are refused with the
    reference's message."""
    m, jm = meshes()
    rng = np.random.default_rng(0)
    taps = rng.normal(size=16).astype(np.float32)
    xs = rng.normal(size=8 * 200).astype(np.float32)

    def corr(t):
        def f(block):
            w = t.stack([block[i: i + block.shape[0] - 15]
                         for i in range(16)], -1)
            return (w * t.asarray(taps)[None, :]).sum(-1)
        return f
    got = sp.sliding_parallel(corr(torch), xs, window=16, mesh=m)
    assert got.shape == (xs.shape[0] - 15,)
    np.testing.assert_allclose(got, corr(torch)(torch.from_numpy(xs)),
                               **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jsp.sliding_parallel(corr(jnp), xs, 16, jm)), **TOL)
    xs = np.arange(8 * 32, dtype=np.float32)
    np.testing.assert_array_equal(
        sp.sliding_parallel(lambda b: b * 2.0, xs, window=1, mesh=m),
        xs * 2.0)
    msgs = []
    for mod, mm in ((sp, m), (jsp, jm)):
        with pytest.raises(mod.StreamParError) as e:
            mod.sliding_parallel(lambda b: b, np.arange(16, dtype=np.float32),
                                 window=8, mesh=mm)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "halo" in msgs[0]


def test_refusals_and_failing_shards():
    """Unbounded state (a cumsum) is refused single and batched with the
    reference's message; an sp axis that crosses processes is refused;
    a shard whose program fails raises (nothing falls back)."""
    comp, jcomp = both(lambda d, t: d.map_accum(
        lambda s, x: (s + x, s + x), 0, name="cumsum"))
    m, jm = meshes()
    msgs = []
    for mod, c, mm in ((sp, comp, m), (jsp, jcomp, jm)):
        with pytest.raises(mod.StreamParError, match="advance") as e:
            mod.stream_parallel(c, np.arange(64, dtype=np.int32), mm)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    names = ("dp", "sp")
    with pytest.raises(sp.StreamParError, match="advance"):
        sp.stream_parallel_batched(comp, np.zeros((2, 4 * 32), np.int32),
                                   cpu_mesh(2, 4, names=names))
    split = z.parallel.mesh.Mesh([(0, "cpu"), (1, "cpu")], ("sp",))
    with pytest.raises(ValueError, match="other processes"):
        sp.stream_parallel(z.zmap(lambda x: x), np.arange(8), split)
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("shard 2 failed")
        return x + 1
    with pytest.raises(RuntimeError, match="shard 2 failed"):
        sp.stream_parallel(z.zmap(flaky, name="flaky"),
                           np.arange(8 * 4, dtype=np.int32), m, width=4)
    with pytest.raises(RuntimeError, match="window fn failed"):
        sp.sliding_parallel(
            lambda b: (_ for _ in ()).throw(RuntimeError("window fn failed")),
            np.arange(64, dtype=np.float32), 2, m)
