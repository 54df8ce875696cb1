"""The port's fixed-point primitives (ziria_tpu_torch/ops/fxp.py) and
fixed-point math library (ops/ext_math.py) against the JAX package's, on
the CPU, bit for bit: every function at random values, at the int16
rails and int32 edges and at 0, quantize_q at NaN, +-inf and +-1e9;
each ext_math function on numpy values and on CPU tensors, alone and
under ``torch.func.vmap``, and through a LUT the frontend's lutinfer
builds over a whole domain; and the copied tables pinned to the JAX
arrays. The contract of this path is exactness, so no tolerance.
"""

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu.ops import ext_math as R_ext, fxp as R_fxp
from ziria_tpu_torch.ops import ext_math as P_ext, fxp as P_fxp


@pytest.fixture(scope="module")
def vals():
    """The inputs every case draws from (numpy, made from one seed)."""
    rng = np.random.default_rng(20261018)
    i32 = rng.integers(-2 ** 31, 2 ** 31, 2048, dtype=np.int64) \
        .astype(np.int32)
    i32[:6] = [-2 ** 31, 2 ** 31 - 1, 0, -1, 1, -2 ** 31 + 1]
    big = rng.integers(-2 ** 28, 2 ** 28, (2, 2048)).astype(np.int32)
    big[:, :6] = [[0, 0, 7, -7, 2 ** 28, -2 ** 28],
                  [0, -5, 0, 0, -2 ** 28, 2 ** 28]]
    pairs = rng.integers(-2 ** 15, 2 ** 15, (40, 64, 2)).astype(np.int32)
    pairs[0] = np.where(rng.integers(0, 2, (64, 2)) > 0, 32767, -32768)
    pairs[1], pairs[2], pairs[3] = -32768, 32767, 0
    conj = rng.integers(-2 ** 15, 2 ** 15, (40, 64, 2)).astype(np.int32)
    conj[0] = -32768
    rot = rng.integers(-2 ** 16, 2 ** 16, (2048, 2)).astype(np.int32)
    ang = rng.integers(-32768, 32768, 2048).astype(np.int32)
    ang[:4] = [-32768, 32767, 16384, -16385]
    i16 = rng.integers(-32768, 32768, (2, 2048)).astype(np.int16)
    i16[:, :4] = [[-32768, 32767, 0, 0], [0, -32768, 0, 32767]]
    u32 = np.abs(i32.astype(np.int64)).clip(0, 2 ** 31 - 1) \
        .astype(np.int32)
    c64 = (pairs[..., 0] + 1j * pairs[..., 1]).astype(np.complex64)
    return dict(i32=i32, u32=u32, big=big, pairs=pairs, conj=conj,
                rot=rot, ang=ang, i16=i16, c64=c64)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    """Bitwise equal, dtype included."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


(RH, RL), (IH, IL) = R_fxp._TW64

# name -> (inputs drawn from `vals`, call on a module (fxp))
PRIMITIVES = {
    "rsra": (["i32"], lambda m, x: [m.rsra(x, s) for s in (0, 1, 5, 7,
                                                            10)]),
    "sat16": (["i32"], lambda m, x: [m.sat16(x)]),
    "cordic_atan2": (["big"], lambda m, b: list(m.cordic_atan2(b[0],
                                                                b[1]))),
    "cordic_rotate": (["rot", "ang"], lambda m, p, a: [
        m.cordic_rotate(p, a, k) for k in (15, 10)]),
    "_gemm_q14": (["pairs"], lambda m, p: [
        m._gemm_q14(p[..., 0], RH, RL), m._gemm_q14(p[..., 1], IH, IL)]),
    "dft64_q14": (["pairs"], lambda m, p: [m.dft64_q14(p, s)
                                           for s in (0, 7, 10)]),
    "idft64_wifi_q14": (["pairs"], lambda m, p: [m.idft64_wifi_q14(p)]),
    "cmul_conj_i32": (["pairs", "conj"], lambda m, a, b: [
        m.cmul_conj_i32(a, b, s) for s in (0, 4)]),
    "cabs2_i32": (["pairs"], lambda m, p: [m.cabs2_i32(p, s)
                                           for s in (0, 4)]),
    "isqrt_u32": (["u32"], lambda m, x: [m.isqrt_u32(x)]),
}


DFT = ("_gemm_q14", "dft64_q14", "idft64_wifi_q14", "cmul_conj_i32",
       "cabs2_i32")


def _primitives(names, vals):
    for name in names:
        keys, call = PRIMITIVES[name]
        args = [vals[k] for k in keys]
        want = call(R_fxp, *args)
        got = call(P_fxp, *[_t(a) for a in args])
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            _same(g, w)


def test_dft_and_pair_primitives_bitwise(vals):
    """The split-Q14 products (float64 in the port, int32 GEMMs in the
    reference) and the pair arithmetic, at random values, the int16
    rails and 0; products at shift 0 on rail values wrap at 32 bits as
    the reference's do."""
    _primitives(DFT, vals)


def test_shift_cordic_and_sqrt_primitives_bitwise(vals):
    """rsra, sat16, both CORDICs and isqrt at random values, int32 edges
    and 0; shifts of negative values are arithmetic."""
    _primitives(sorted(set(PRIMITIVES) - set(DFT)), vals)


def test_quantize_q_and_edges(vals):
    """quantize_q at random floats, NaN, +-inf, +-1e9, the rounding
    edges and 0, at three Q formats; the float clamp equals the
    reference's cast-then-saturate."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0, 6, 2048),
                        [np.nan, np.inf, -np.inf, 1e9, -1e9, 3e38, -3e38,
                         0.0, -0.0, 15.99951171875, -16.000244140625,
                         0.000244140625, -0.000244140625,
                         0.5 / 2048, -0.5 / 2048]]).astype(np.float32)
    for q in (0, 11, 15):
        _same(P_fxp.quantize_q(_t(x), q), R_fxp.quantize_q(x, q))
        _same(P_fxp.quantize_q(x, q), R_fxp.quantize_q(x, q))
    # the fixed-point boundary of rx_fxp, on a (frames, samples, 2) array
    from ziria_tpu.phy.wifi import rx_fxp as R_rx
    from ziria_tpu_torch.phy.wifi import rx_fxp as P_rx
    frames = rng.normal(0, 1.5, (3, 500, 2)).astype(np.float32)
    _same(P_rx.quantize_frame(_t(frames)), R_rx.quantize_frame(frames))
    # int32 wrap and arithmetic shift, the XLA semantics the port keeps
    edge = _t(np.array([-2 ** 31, 2 ** 31 - 1, -1, -3], np.int32))
    _same(P_fxp.rsra(edge, 1), R_fxp.rsra(edge.numpy(), 1))
    _same(edge * 3, np.asarray(edge.numpy()) * np.int32(3))


EXT = {
    "sin_int16": lambda m, v: [m.sin_int16(v["i16"][0])],
    "cos_int16": lambda m, v: [m.cos_int16(v["i16"][0])],
    "sincos_int16": lambda m, v: list(m.sincos_int16(v["i16"][1])),
    "atan2_int16": lambda m, v: [m.atan2_int16(v["i16"][0],
                                               v["i16"][1])],
    "usqrt": lambda m, v: [m.usqrt(v["i32"])],
    "ulog2": lambda m, v: [m.ulog2(v["i32"])],
    "dft64_fxp": lambda m, v: [m.dft64_fxp(v["c64"])],
    "idft64_fxp": lambda m, v: [m.idft64_fxp(v["c64"])],
}


def test_ext_math_on_numpy_and_tensors(vals):
    """Each ext_math function on numpy values (numpy out), on CPU
    tensors (tensors out) and lane by lane under torch.func.vmap,
    against the reference's, and on scalars."""
    for name in sorted(EXT):
        _ext_case(name, vals)


def _ext_case(name, vals):
    want = EXT[name](R_ext, vals)
    got_np = EXT[name](P_ext, vals)
    tv = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in vals.items()}
    got_t = EXT[name](P_ext, tv)
    for n, t, w in zip(got_np, got_t, want):
        assert isinstance(n, np.ndarray) and isinstance(t, torch.Tensor)
        _same(n, w)
        _same(t, w)
    fn = getattr(P_ext, name)
    if name == "atan2_int16":
        lanes = torch.func.vmap(fn)(tv["i16"][0][:64], tv["i16"][1][:64])
        _same(lanes, want[0][:64])
        _same(fn(np.int16(-3), np.int16(-32768)),
              R_ext.atan2_int16(np.int16(-3), np.int16(-32768)))
    elif name in ("dft64_fxp", "idft64_fxp"):
        _same(torch.func.vmap(fn)(tv["c64"][:8]), want[0][:8])
    elif name != "sincos_int16":
        src = "i16" if name.endswith("int16") else "i32"
        x = tv[src][0] if src == "i16" else tv[src]
        _same(torch.func.vmap(fn)(x[:64]), want[0][:64])
        one = x[5].numpy()[()]
        _same(fn(one), getattr(R_ext, name)(one))
    _same(P_ext.rad_to_q15(np.linspace(-7, 7, 101)),
          R_ext.rad_to_q15(np.linspace(-7, 7, 101)))
    np.testing.assert_array_equal(P_ext.q15_to_rad(vals["i16"][0]),
                                  R_ext.q15_to_rad(vals["i16"][0]))


def test_tables_pinned_to_the_reference():
    """The port's own copies of the CORDIC angles, both split twiddle
    sets, the sine LUT and the demap's Q7 norms equal the JAX arrays."""
    from ziria_tpu.phy.wifi import rx_fxp as R_rx
    from ziria_tpu_torch.phy.wifi import rx_fxp as P_rx

    _same(P_fxp._CORDIC_ANGLES, R_fxp._CORDIC_ANGLES)
    for mine, ref in ((P_fxp._TW64, R_fxp._TW64),
                      (P_fxp._ITW64_WIFI, R_fxp._ITW64_WIFI)):
        for (h, lo), (rh, rl) in zip(mine, ref):
            _same(h, rh)
            _same(lo, rl)
    _same(P_ext._SIN_LUT, R_ext._SIN_LUT)
    assert P_rx._NORM_Q7 == R_rx._NORM_Q7
    assert (P_rx.Q_IN, P_rx._DFT_SHIFT, P_rx._Z_SHIFT, P_rx._W_SHIFT,
            P_rx.LLR_SHIFT) == (R_rx.Q_IN, R_rx._DFT_SHIFT, R_rx._Z_SHIFT,
                                R_rx._W_SHIFT, R_rx.LLR_SHIFT)


def test_ext_math_in_a_program_and_its_lut():
    """A .zir program declaring the ext_math functions runs on the
    port's interpreter and jit backend with the reference's output, and
    with autolut its pure int8 function (which calls sin_int16 and
    atan2_int16) becomes one table built over the whole domain by
    lutinfer, equal to the direct evaluation."""
    from ziria_tpu.backend.execute import run_jit as R_run_jit
    from ziria_tpu.frontend import compile_source as R_compile
    from ziria_tpu_torch.backend.execute import run_jit
    from ziria_tpu_torch.core.autolut import autolut
    from ziria_tpu_torch.frontend import compile_source
    from ziria_tpu_torch.interp.interp import run

    src = """
      ext fun sin_int16(a: int16) : int16
      ext fun atan2_int16(y: int16, x: int16) : int16
      ext fun usqrt(x: int32) : int32
      ext fun ulog2(x: int32) : int32
      fun f(x: int8) : int32 {
        let a = int16(x) * int16(256);
        return int32(sin_int16(a)) + int32(atan2_int16(int16(x), 100))
               + usqrt(int32(x) * int32(x) + 7) * ulog2(int32(x) + 300)
      }
      let comp main = read[int8] >>> map f >>> write[int32]
    """
    xs = np.arange(-128, 128, dtype=np.int8)
    want = np.asarray(R_run_jit(R_compile(src).comp, xs))
    prog = compile_source(src)
    _same(run(prog.comp, list(xs)).out_array(), want)
    _same(run_jit(prog.comp, xs, device="cpu"), want)
    lut_prog = compile_source(src, autolut=True)
    lutted = autolut(lut_prog.comp)
    assert "lut[" in str(lutted)
    _same(run_jit(lutted, xs, device="cpu"), want)
    _same(np.asarray(run(lutted, list(xs)).out_array()), want)
