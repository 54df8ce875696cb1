"""The port's vectorizer (ziria_tpu_torch/core/vectorize.py) and
run_vect against the JAX package on the CPU: at equal explicit model
constants and chunk budget the plans are the reference's candidate for
candidate (the dump line for line); widen, mitigator and run_vect give
the interpreter's and the reference's outputs (within 1e-6 where float
sums reorder, else exact); the model constants are the port's own
fits, one row per device kind, each with its pedigree; --ddump-vect
prints the plan."""

import numpy as np
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
import ziria_tpu as jz
import ziria_tpu_torch as z
from ziria_tpu.backend.execute import run_vect as jax_run_vect
from ziria_tpu.core import ir as jir
from ziria_tpu.core import vectorize as JV
from ziria_tpu.core.card import steady_state as jax_steady_state
from ziria_tpu_torch.backend.execute import run_jit, run_vect
from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core import vectorize as V
from ziria_tpu_torch.core.card import steady_state
from ziria_tpu_torch.interp.interp import run

TAPS = np.array([0.25, 0.5, 0.25], dtype=np.float32)
REF_BUDGET = 4 << 20              # the reference's default live chunk


def _fir_step_t(state, x):
    state = torch.as_tensor(state)
    state = torch.cat([torch.as_tensor(x, dtype=state.dtype).reshape(1),
                       state[:-1]])
    return state, (state * torch.from_numpy(TAPS).to(state.device)).sum()


def _fir_step_j(state, x):
    import jax.numpy as jnp
    state = jnp.roll(state, 1).at[0].set(x)
    return state, (state * TAPS).sum()


def _progs(m, fir_step, stack):
    """The same pipelines in one package: FIR chain, rate change,
    stateless chain, scan-bound cumulative sum."""
    return {
        "fir": m.pipe(m.zmap(lambda x: x * 2.0),
                      m.map_accum(fir_step, np.zeros(3, np.float32),
                                  name="fir3"),
                      m.zmap(lambda x: x + 1.0)),
        "rates": m.pipe(
            m.zmap(lambda v: v.sum(), in_arity=3, out_arity=1,
                   name="sum3"),
            m.zmap(lambda x: stack([x, -x]), in_arity=1, out_arity=2,
                   name="split2")),
        "stateless": m.pipe(m.zmap(lambda x: x + 1),
                            m.zmap(lambda x: x * 2)),
        "scan": m.pipe(m.map_accum(lambda s, x: (s + x, s + x),
                                   np.float32(0.0))),
    }


def _port():
    return _progs(z, _fir_step_t, lambda vs: torch.stack(
        [torch.as_tensor(v) for v in vs]))


def _ref():
    import jax.numpy as jnp
    return _progs(jz, _fir_step_j, jnp.stack)


def _as_port(x):
    """The reference's words in the port's: its live-chunk cap is the
    TPU's VMEM budget, the port's a share of the card's L2."""
    if isinstance(x, str):
        return x.replace("VMEM budget", "chunk budget")
    return (x[0], [(w, u, _as_port(n)) for w, u, n in x[1]])


def test_plans_equal_the_references_at_equal_constants():
    """Both rows of both packages' constants, every pipeline: the
    search's candidates (width, utility, note) and the dumps agree (the
    live-chunk cap named in the port's words)."""
    port, ref = _port(), _ref()
    rows = [JV.MODEL_CONSTANTS["cpu"], JV.MODEL_CONSTANTS["tpu"],
            V.MODEL_CONSTANTS["cpu"], V.MODEL_CONSTANTS["cuda"]]
    for name in port:
        ps, rs = ir.pipeline_stages(port[name]), \
            jir.pipeline_stages(ref[name])
        for c in rows:
            got = V.search_width(steady_state(ps), ps, 4, REF_BUDGET,
                                 constants=c)
            want = JV.search_width(jax_steady_state(rs), rs, 4,
                                   REF_BUDGET, constants=c)
            assert got == _as_port(want), name
        got = V.vectorize(port[name], chunk_budget=REF_BUDGET,
                          constants=JV.model_constants("cpu")).dump()
        assert got == _as_port(JV.vectorize(ref[name]).dump()), name


def test_widen_and_mitigators_equal_the_interpreter():
    """Uniform and per-stage widths (mitigators between them), a
    widened repeat, and the mitigator as a stream identity."""
    port = _port()
    xs = np.arange(96, dtype=np.float32)
    for name in ("fir", "stateless", "rates"):
        want = np.asarray(run(port[name], list(xs)).out_array())
        for w in (2, 4):
            got = run_jit(z.widen(port[name], w), xs.reshape(-1, w),
                          width=1, device="cpu")
            np.testing.assert_allclose(np.asarray(got).reshape(
                want.shape), want, rtol=1e-6, atol=1e-6)
    fir = port["fir"]
    want = np.asarray(run(fir, list(xs)).out_array())
    wide = z.widen(fir, {0: 4, 1: 2, 2: 2})
    assert any("mitigate[4->2]" in s.label()
               for s in ir.pipeline_stages(wide))
    got = run(wide, list(xs.reshape(-1, 4))).out_array()
    np.testing.assert_allclose(np.asarray(got).reshape(-1), want,
                               rtol=1e-6, atol=1e-6)
    m = z.mitigator(6, 4)
    got = run(m, list(np.arange(48, dtype=np.int32).reshape(-1, 6)))
    np.testing.assert_array_equal(np.asarray(got.out_array()).reshape(-1),
                                  np.arange(48))
    rep = ir.Repeat(ir.seq(ir.let("x", ir.take, ir.emit1(
        lambda env: env["x"] * 3))))
    xs_i = np.arange(64, dtype=np.int32)
    got = run_jit(V.widen(rep, 4), xs_i.reshape(-1, 4), width=1,
                  device="cpu")
    np.testing.assert_array_equal(np.asarray(got).reshape(-1), xs_i * 3)


def test_run_vect_equals_the_references():
    """Fully static (one jit segment at the planned width), a dynamic
    middle stage bridged through the hybrid backend, and a rate-change
    chain: run_vect equals the interpreter and the reference's
    run_vect."""
    port, ref = _port(), _ref()
    for name, xs in (("fir", np.arange(256, dtype=np.float32)),
                     ("rates", np.arange(96, dtype=np.float32))):
        got = run_vect(port[name], xs, device="cpu")
        want = np.asarray(run(port[name], list(xs)).out_array())
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(np.asarray(got), np.asarray(
            jax_run_vect(ref[name], xs)), rtol=1e-6, atol=1e-6)

    def dyn(m):
        body = m.seq(m.let("x", m.take, m.let_ref(
            "n", lambda env: int(env["x"]) % 3,
            m.seq(m.while_loop(lambda env: env["n"] > 0,
                               m.assign("n", lambda env: env["n"] - 1)),
                  m.emit(lambda env: env["x"])))))
        return m.pipe(m.zmap(lambda x: x + 1), m.repeat(body),
                      m.zmap(lambda x: x * 2))

    xs = np.arange(32, dtype=np.int64)
    plan = V.vectorize(dyn(z), device="cpu")
    assert [s.dynamic for s in plan.segments] == [False, True, False]
    got = run_vect(dyn(z), xs, device="cpu")
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(run(dyn(z), list(xs))
                                             .out_array()))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jax_run_vect(dyn(jz), xs)))


def test_model_constants_are_the_ports_own(tmp_path, capsys):
    """One fitted row per device kind (no TPU row), each measured by the
    port's calibration script and naming where; the active row follows
    the run's device; --ddump-vect prints the plan of the CLI's
    device."""
    assert set(V.MODEL_CONSTANTS) == {"cuda", "cpu"}
    for plat, row in V.MODEL_CONSTANTS.items():
        assert row["vpu_parallel"] > 0 and row["step_overhead"] > 0
        assert "scripts/calibrate_vect.py" in row["pedigree"]
    assert "H100" in V.MODEL_CONSTANTS["cuda"]["pedigree"]
    assert V.active_platform("cpu") == "cpu"
    assert V.active_platform("cuda") == "cuda"
    assert V.model_constants(device="cpu") == V.MODEL_CONSTANTS["cpu"]
    assert V.MODEL_CONSTANTS["cpu"] != JV.MODEL_CONSTANTS["cpu"]
    # without constants, the search and its utility plan with the row
    # of their device, the card's by default
    ps = ir.pipeline_stages(_port()["fir"])
    ss = steady_state(ps)
    for dev, plat in ((None, "cuda"), ("cuda", "cuda"), ("cpu", "cpu")):
        kw = {} if dev is None else {"device": dev}
        row = V.MODEL_CONSTANTS[plat]
        assert V.search_width(ss, ps, **kw) == \
            V.search_width(ss, ps, constants=row), dev
        assert V.utility(ss, ps, 8, **kw) == \
            V.utility(ss, ps, 8, constants=row), dev
    assert V.search_width(ss, ps) != V.search_width(ss, ps, device="cpu")

    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import StreamSpec, write_stream
    src = tmp_path / "p.zir"
    src.write_text("fun incr(x: int32) : int32 { return x * 3 - 1 }\n"
                   "let comp main = read[int32] >>> map incr >>> "
                   "write[int32]\n")
    inf = tmp_path / "in.dbg"
    write_stream(StreamSpec(ty="int32", path=str(inf), mode="dbg"),
                 np.arange(8, dtype=np.int32))
    assert cli.main([f"--src={src}", f"--input-file-name={inf}",
                     f"--output-file-name={tmp_path / 'o.dbg'}",
                     "--platform=cpu", "--ddump-vect"]) == 0
    err = capsys.readouterr().err
    assert "model constants:" in err and "segment 0:" in err
    assert V.MODEL_CONSTANTS["cpu"]["pedigree"] in err
