"""The port's stage pipelines, frame batching and auto-pipelining
(ziria_tpu_torch/parallel/stages.py, batch.py, autosplit.py) on 8
virtual CPU entries, against the JAX package on its 8 virtual CPU
devices (tests/test_parallel.py and tests/test_autosplit.py's cases)
and the port's one-device run. Integer outputs are bitwise, float
outputs within the reference tests' rtol = atol = 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import ziria_tpu as jz
import ziria_tpu_torch as z
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.core import ir as jir
from ziria_tpu.parallel import autosplit as jauto, batch as jbatch, \
    lower_stage_parallel as jlower_pp, shard_batch as jshard_batch
from ziria_tpu_torch.backend.execute import run_jit, run_jit_carry
from ziria_tpu_torch.backend.lower import LowerError
from ziria_tpu_torch.core import ir
from ziria_tpu_torch.parallel import autosplit, batch, mesh as pmesh
from ziria_tpu_torch.parallel import lower_stage_parallel

TOL = dict(rtol=1e-5, atol=1e-5)


def cpu_mesh(*shape, names=("pp",)):
    n = int(np.prod(shape))
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cpu")] * n
    return pmesh.Mesh(devs.reshape(shape), names)


def jmesh(*shape, names=("pp",)):
    n = int(np.prod(shape))
    return JMesh(np.array(jax.devices()[:n]).reshape(shape), names)


def both(build):
    """`build(z)` with each package's DSL: (port comp, reference comp)."""
    return build(z, torch), build(jz, jnp)


def test_stage_pipelines_equal_the_reference():
    """Two stages, a stateful stage before and after a stateless one (the
    downstream carry must not step on the fill bubbles), rate-mismatched
    stages (1 -> 2, 2 -> 1) and four int32 stages (the dtype kept
    through every boundary): each pipeline's output equals the
    reference's and the port's fused one-device run."""
    cases = {
        "two": (lambda d, t: d.par_pipe(
            d.zmap(lambda x: x * 2.0, name="dbl"),
            d.zmap(lambda x: x + 1.0, name="inc")), 2, 4, np.float32),
        "cumsum_neg": (lambda d, t: d.par_pipe(
            d.map_accum(lambda s, x: (s + x, s + x), 0.0, name="cumsum"),
            d.zmap(lambda x: -x, name="neg")), 2, 3, np.float32),
        "neg_ctr": (lambda d, t: d.par_pipe(
            d.zmap(lambda x: -x, name="neg"),
            d.map_accum(lambda s, x: (s + 1.0, x + s), 0.0, name="ctr")),
            2, 2, np.float32),
        "rates": (lambda d, t: d.par_pipe(
            d.repeat(d.let("x", d.take, d.emits(
                lambda e: t.stack([e["x"], e["x"]]), 2))),
            d.repeat(d.let("p", d.takes(2), d.emit1(
                lambda e: e["p"][0] + e["p"][1])))), 2, 2, np.float32),
        "four_int": (lambda d, t: d.par_pipe(*[
            d.zmap(lambda x, _k=k: x + _k, name=f"s{k}")
            for k in range(4)]), 4, 2, np.int32),
    }
    for name, (build, k, width, dt) in cases.items():
        comp, jcomp = both(build)
        pp = lower_stage_parallel(comp, cpu_mesh(k), width=width,
                                  in_item=((), dt))
        jpp = jlower_pp(jcomp, jmesh(k), width=width,
                        in_item=jax.ShapeDtypeStruct((), dt))
        assert (pp.take, pp.emit, pp.n_stages) == \
            (jpp.take, jpp.emit, jpp.n_stages), name
        xs = np.arange(5 * pp.take, dtype=dt).reshape(5, pp.take)
        got = pp.run(xs)
        want = np.asarray(jpp.run(xs))
        assert got.dtype == want.dtype, name
        if dt == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=name)
        fused = run_jit(ir.pipe(*ir.par_segments(comp)), xs.reshape(-1),
                        width=1, device="cpu")
        np.testing.assert_allclose(got.reshape(fused.shape), fused, **TOL,
                                   err_msg=name)


def test_exit_carries_and_dp_x_pp():
    """run_carry's exit carries continue the fused one-device run
    exactly (drain bubbles never step a carry); on a (dp 2, pp 4) mesh
    each stream of a batch runs its own pipeline, its outputs equal to
    the reference's and its carry continuing a ragged remainder."""
    comp, jcomp = both(lambda d, t: d.par_pipe(
        d.map_accum(lambda s, x: (s + x, s + x), 0.0, name="cumsum"),
        d.map_accum(lambda s, x: (s + 1.0, x + s), 0.0, name="ctr")))
    pp = lower_stage_parallel(comp, cpu_mesh(2), width=2)
    xs = np.arange(5 * pp.take, dtype=np.float32).reshape(5, pp.take)
    got, carry = pp.run_carry(xs)
    jgot, _jc = jlower_pp(jcomp, jmesh(2), width=2).run_carry(xs)
    np.testing.assert_allclose(got, np.asarray(jgot), **TOL)
    seq = ir.pipe(*ir.par_segments(comp))
    tail = np.arange(7, dtype=np.float32) + 1000.0
    t, _ = run_jit_carry(seq, tail, carry=carry, width=1, device="cpu")
    full = run_jit(seq, np.concatenate([xs.reshape(-1), tail]), width=1,
                   device="cpu")
    np.testing.assert_allclose(np.concatenate([got.reshape(-1), t]), full,
                               **TOL)

    def four(d, t):
        return [d.zmap(lambda x: x * 2.0, name="s0"),
                d.map_accum(lambda s, x: (s + x, s + x), 0.0,
                            name="cumsum"),
                d.zmap(lambda x: x + 1.0, name="s2"),
                d.map_accum(lambda s, x: (s + 1.0, x + s), 0.0,
                            name="ctr")]
    stages, jstages = four(z, torch), four(jz, jnp)
    names = ("dp", "pp")
    pp = lower_stage_parallel(z.par_pipe(*stages), cpu_mesh(2, 4,
                                                            names=names),
                              width=4, batch_axis="dp")
    jm = jmesh(2, 4, names=names)
    jpp = jlower_pp(jz.par_pipe(*jstages), jm, width=4, batch_axis="dp")
    rng = np.random.default_rng(3)
    bulk = rng.normal(size=(4, 5, pp.take)).astype(np.float32)
    rems = rng.normal(size=(4, 7)).astype(np.float32)
    ys, carries = pp.run_carry(bulk)
    np.testing.assert_allclose(
        ys, np.asarray(jpp.run(jshard_batch(jm, bulk, axis="dp"))), **TOL)
    assert isinstance(carries, list) and len(carries) == 4
    fused = z.pipe(*stages)
    for b in range(4):
        t, _ = run_jit_carry(fused, rems[b], carry=carries[b], device="cpu")
        want = run_jit(fused, np.concatenate([bulk[b].reshape(-1), rems[b]]),
                       device="cpu")
        np.testing.assert_allclose(np.concatenate([ys[b].reshape(-1), t]),
                                   want, **TOL, err_msg=f"stream {b}")


def test_stage_mesh_refusals():
    """A segment count other than the axis's raises LowerError; a pp
    axis that crosses processes is refused (its chunks move every
    macro step); an input item of another shape raises."""
    comp = z.par_pipe(z.zmap(lambda x: x), z.zmap(lambda x: x))
    with pytest.raises(LowerError, match="2 |>>>| segments"):
        lower_stage_parallel(comp, cpu_mesh(3), width=1)
    split = pmesh.Mesh([(0, "cpu"), (1, "cpu")], ("pp",))
    with pytest.raises(ValueError, match="crosses processes"):
        lower_stage_parallel(comp, split, width=1)
    pp = lower_stage_parallel(comp, cpu_mesh(2), width=2, in_item=((2,),
                                                                   "f4"))
    with pytest.raises(LowerError, match="shape"):
        pp.run(np.zeros((3, pp.take), np.float32))


def test_frame_batching_and_mesh_helpers():
    """data_parallel over 8 CPU entries equals the one-device result;
    shard_batch, gather, ppermute (zeros where nothing arrives) and
    psum (exact, bool kept) behave as their JAX collectives;
    frame_mesh refuses more devices than it sees; the elastic rule's
    divisors are the reference's; a mesh on cuda without a card
    raises."""
    mesh = batch.frame_mesh(8, device="cpu")
    assert mesh.shape == {"dp": 8} and mesh.size == 8
    assert mesh == batch.frame_mesh(device="cpu") and \
        hash(mesh) == hash(batch.frame_mesh(device="cpu"))
    x = np.arange(16 * 32, dtype=np.float32).reshape(16, 32)
    fn = batch.data_parallel(lambda a: (a * 2).sum(axis=-1), mesh)
    np.testing.assert_array_equal(fn(x).numpy(), (x * 2).sum(-1))
    jfn = jbatch.data_parallel(lambda a: (a * 2).sum(axis=-1),
                               jbatch.frame_mesh(8))
    np.testing.assert_allclose(fn(torch.from_numpy(x)).numpy(),
                               np.asarray(jfn(x)), **TOL)
    parts = batch.shard_batch(mesh, x)
    assert len(parts) == 8 and parts[3].shape == (2, 32)
    assert torch.equal(pmesh.gather(parts), torch.from_numpy(x))
    moved = pmesh.ppermute(parts, [(i, i + 1) for i in range(7)])
    assert torch.equal(moved[0], torch.zeros(2, 32))
    assert all(torch.equal(moved[i + 1], parts[i]) for i in range(7))
    ints = [torch.full((3,), i, dtype=torch.int32) for i in range(8)]
    assert pmesh.psum(ints).tolist() == [28] * 3
    flags = [torch.tensor([i == 5, False]) for i in range(8)]
    assert pmesh.psum(flags).dtype == torch.bool
    assert pmesh.psum(flags).tolist() == [True, False]
    with pytest.raises(ValueError, match="need 9 devices, only 8 visible"):
        batch.frame_mesh(9, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        batch.shard_batch(mesh, x[:12])
    for n, cap in ((8, 8), (8, 5), (6, 4), (7, 3), (12, 8)):
        assert batch.largest_divisor(n, cap) == \
            jbatch.largest_divisor(n, cap)
    with pytest.raises(ValueError):
        batch.largest_divisor(0, 4)
    assert batch.elastic_mesh(4, n_devices=1, device="cpu") is None
    for s in (4, 6, 9, 11):
        m = batch.elastic_mesh(s, device="cpu")
        jm = jbatch.elastic_mesh(s)
        assert (m and m.size) == (jm and jm.devices.size)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            batch.frame_mesh(device="cuda")
        with pytest.raises(RuntimeError, match="CUDA device"):
            pmesh.Mesh(["cuda:0"] * 4, ("dp",))


def test_autosplit_decisions_equal_the_reference():
    """balanced_partition's cuts, the items-moved cost of a repeat, the
    rate-weighted split, the nested |>>>| flattened to a fixpoint and
    the oversplit error are the reference's; an 8-way split of 8 stages
    runs on 8 entries equal to the fused run."""
    for costs, k in (([5, 1, 1, 1, 5], 2), ([9, 1, 1, 1], 2),
                     ([1, 2, 3], 3), ([4, 1, 7, 2, 2, 9, 1], 3)):
        assert autosplit.balanced_partition(costs, k) == \
            jauto.balanced_partition(costs, k)
    rep, jrep = both(lambda d, t: d.repeat(d.let(
        "v", d.takes(64), d.emit(lambda env: env["v"].sum()))))
    assert autosplit.default_stage_cost(rep, 1) == \
        jauto.default_stage_cost(jrep, 1) == 65.0

    def rated(d, t):
        return d.pipe(
            d.zmap(lambda x: x + 1, name="pre"),
            d.zmap(lambda x: t.stack([x, -x]), in_arity=1, out_arity=2,
                   name="expand"),
            d.zmap(lambda x: x * 2, name="a"),
            d.zmap(lambda x: x - 1, name="b"),
            d.zmap(lambda x: x ^ 3, name="c"))
    prog, jprog = both(rated)
    segs = ir.par_segments(autosplit.auto_pipeline(prog, 2))
    jsegs = jir.par_segments(jauto.auto_pipeline(jprog, 2))
    assert [len(ir.pipeline_stages(s)) for s in segs] == \
        [len(jir.pipeline_stages(s)) for s in jsegs] == [3, 2]
    nested = ir.Pipe(z.zmap(lambda x: x + 1, name="a"),
                     ir.ParPipe(z.zmap(lambda x: x + 2, name="b"),
                                z.zmap(lambda x: x + 3, name="c")))
    segs = ir.par_segments(autosplit.auto_pipeline(nested, 2))
    assert len(segs) == 2 and sum(len(ir.pipeline_stages(s))
                                  for s in segs) == 3
    two, jtwo = both(lambda d, t: d.pipe(d.zmap(lambda x: x, name="a"),
                                         d.zmap(lambda x: x, name="b")))
    with pytest.raises(autosplit.AutoSplitError) as e:
        autosplit.auto_pipeline(two, 3)
    with pytest.raises(jauto.AutoSplitError) as je:
        jauto.auto_pipeline(jtwo, 3)
    assert str(e.value) == str(je.value)
    eight = z.pipe(*[z.zmap(lambda x, _k=k: x * 2 + _k, name=f"s{k}")
                     for k in range(8)])
    pp = lower_stage_parallel(autosplit.auto_pipeline(eight, 8),
                              cpu_mesh(8), width=4)
    xs = np.arange(6 * pp.take, dtype=np.float32)
    np.testing.assert_allclose(pp.run(xs.reshape(6, pp.take)).reshape(-1),
                               run_jit(eight, xs, device="cpu"), rtol=1e-6)


def test_measured_costs_are_a_deterministic_split():
    """Measured stage costs (timing-dependent, so only what does not
    depend on the clock): one positive cost a stage, a 2-way split
    that keeps every stage once and in order, whose pipeline equals the
    fused run; an empty cascade is refused; the shared stage runner
    names its backend (jit; hybrid for a stage the jit refuses)."""
    stages = [z.zmap(lambda x: x + 1, name="s0"),
              z.zmap(lambda x: (x * 1664525 + 1013904223) % 2147483647,
                     name="heavy"),
              z.zmap(lambda x: x * 3, name="s2"),
              z.zmap(lambda x: x - 2, name="s3")]
    prog = z.pipe(*stages)
    xs = np.arange(1 << 10, dtype=np.int32)
    costs = autosplit.measured_stage_costs(autosplit._flatten(prog), xs,
                                           width=8, device="cpu")
    assert len(costs) == 4 and all(c > 0 for c in costs)
    out = autosplit.auto_pipeline(prog, 2, sample=xs, width=8, device="cpu")
    segs = ir.par_segments(out)
    assert len(segs) == 2
    assert [s.label() for seg in segs for s in autosplit._flatten(seg)] \
        == ["s0", "heavy", "s2", "s3"]
    pp = lower_stage_parallel(out, cpu_mesh(2), width=8,
                              in_item=((), np.int32))
    m = xs.shape[0] // pp.take
    np.testing.assert_array_equal(
        pp.run(xs[:m * pp.take].reshape(m, pp.take)).reshape(-1),
        run_jit(prog, xs[:m * pp.take], device="cpu"))
    shrink = z.zmap(lambda v: v.sum(), in_arity=64, out_arity=1,
                    name="sum64")
    with pytest.raises(autosplit.AutoSplitError, match="0 items"):
        autosplit.measured_stage_costs([shrink] * 3, xs[:100],
                                       device="cpu")
    go = autosplit.stage_runner(stages[2], xs, width=8, device="cpu")
    assert go.backend == "jit"
    np.testing.assert_array_equal(go(), xs * 3)
    dyn = z.repeat(z.let("x", z.take, z.branch(
        lambda e: e["x"] > 5, z.emit1(lambda e: e["x"]),
        z.emit1(lambda e: -e["x"]))))
    go = autosplit.stage_runner(dyn, xs[:16], device="cpu")
    assert go.backend == "hybrid"
    np.testing.assert_array_equal(
        go(), np.where(xs[:16] > 5, xs[:16], -xs[:16]))
