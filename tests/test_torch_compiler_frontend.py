"""The port's frontend and evaluator against the JAX package's, on small
programs (CPU).

Each program is compiled by both packages: the printed IR must be the
same (closure addresses, the package name and jnp's array repr aside).
Both packages then run it on the same seeded numpy input, on the interpreter and on the
jit backend (the port's on the CPU), and the outputs must agree --
bitwise for integer and bit streams, within 1e-6 absolute for float32
ones (the device's transcendental functions and FFT round differently
from numpy's). The programs pin the evaluator's dtype policy: C
division and remainder, int8 and int16 promotion, int32 wrap, shifts,
the uint8 ``bit`` in arithmetic, and -- on the jit backend, where the
interpreter would raise -- out-of-range dynamic indexes and slices,
which read clamped and write dropped or clamped as ``lax`` does.
"""

import re

import numpy as np
import pytest

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend.execute import run_jit as jax_run_jit
from ziria_tpu.frontend import compile_source as jax_compile
from ziria_tpu.interp.interp import run as jax_run
from ziria_tpu_torch.backend.execute import run_jit
from ziria_tpu_torch.frontend import ZiriaRuntimeError, compile_source
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.interp.interp import run

INT_SEM = """
let comp main = read[int32] >>> repeat {
  x <- take;
  var q : int32 := 0; var r : int32 := 0; var q2 : int32 := 0;
  var r2 : int32 := 0; var p : int32 := 0; var c8 : int32 := 0;
  var w : int32 := 0; var s : int32 := 0; var t : int32 := 0;
  var u : int32 := 0;
  do {
    let y = x - 50;
    q := y / 7; r := y % 7;
    q2 := x / (0 - 3); r2 := (0 - x) % 5;
    var a : int8 := 100;
    var b : int16 := 30000;
    p := a * 3 + b * 2 + y;
    var cc : int8 := a + y;
    c8 := cc;
    var ww : int32 := 2147483000;
    ww := ww + x * 1000;
    w := ww;
    s := y >> 2;
    t := (x << 24) >> 3;
    var bb : bit := '1;
    u := 256 * bb + (y & 0xFF) ^ (y | 3)
  };
  emit q; emit r; emit q2; emit r2; emit p; emit c8; emit w; emit s;
  emit t; emit u
} >>> write[int32]
"""

OUT_OF_RANGE = """
let comp main = read[int32] >>> repeat {
  x <- take;
  var a8 : arr[8] int32 := {10, 11, 12, 13, 14, 15, 16, 17};
  var v : int32 := 0;
  var sl : arr[3] int32;
  do {
    a8[x] := 99;
    sl := a8[x, 3];
    a8[x + 1, 2] := {7, 8};
    v := a8[x + 2]
  };
  emits a8; emits sl; emit v
} >>> write[int32]
"""

LOOPS = """
let comp main = read[int32] >>> repeat {
  (x : arr[32] int32) <- takes 32;
  var acc : int32 := 0;
  var cnt : int32 := 0;
  var f : double := 0.0;
  var m : int32 := 0;
  var st : arr[7] bit := {'1,'0,'1,'1,'0,'0,'1};
  var o : arr[160] bit;
  do {
    for i in [0, 32] {
      acc := acc + x[i] * i;
      if (x[i] > 3) then { cnt := cnt + 1 }
    };
    for i in [0, 32] { f := f * 0.5 + x[i] };
    if (acc > 500) then { m := acc - 500 } else { m := 500 - acc };
    for p in [0, 160] {
      let fb = st[6] ^ st[3];
      st[1, 6] := st[0, 6];
      st[0] := fb;
      o[p] := fb ^ (x[p % 32] & 1)
    }
  };
  emit acc; emit cnt; emit int32(f * 1000.0); emit m; emits o
} >>> write[int32]
"""

FLOATS = """
ext fun sqrt(x: double) : double
ext fun atan2(y: double, x: double) : double
ext fun cos(x: double) : double
let comp main = read[double] >>> repeat {
  (x : arr[4] double) <- takes 4;
  var o : arr[6] double;
  do {
    let c = complex(x[0], x[1]) * complex(x[2], 0.0 - x[3]);
    o[0] := c.re; o[1] := c.im;
    o[2] := sqrt(x[0] * x[0] + x[1] * x[1]);
    o[3] := atan2(x[1], x[0]);
    o[4] := cos(x[2]) / 3.0;
    if (x[3] > 0.0) then { o[5] := x[3] } else { o[5] := 0.0 - x[3] }
  };
  emits o
} >>> write[double]
"""

STATE = """
let comp main = read[bit] >>> {
  var st : arr[7] bit := {'1,'1,'1,'1,'1,'1,'1};
  var ph : int32 := 0;
  repeat {
    x <- take;
    var y : bit := '0;
    do {
      let fb = st[6] ^ st[3];
      st[1, 6] := st[0, 6];
      st[0] := fb;
      y := x ^ fb;
      ph := (ph + 1) % 5
    };
    emit y
  }
} >>> write[bit]
"""

_RNG = np.random.default_rng(20261017)
INPUTS = {
    "int_sem": (INT_SEM, _RNG.integers(-2000, 2000, 64).astype(np.int32)),
    "out_of_range": (OUT_OF_RANGE,
                     np.array([0, 3, 7, -1, -3, 8, 20, -20, 5, 6], np.int32)),
    "loops": (LOOPS, _RNG.integers(-10, 10, 128).astype(np.int32)),
    "floats": (FLOATS, _RNG.normal(size=64).astype(np.float32)),
    "state": (STATE, _RNG.integers(0, 2, 300).astype(np.uint8)),
}


def _printed(comp) -> str:
    """The IR as printed, without closure addresses, the package name
    and the value kind of a localized state's initial value (a jnp
    Array in the reference, numpy in the port)."""
    s = re.sub(r" at 0x[0-9a-f]+", "", str(comp))
    s = s.replace("Array(", "array(").replace(", weak_type=True", "")
    return s.replace("ziria_tpu_torch", "ziria_tpu")


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_printed_ir_is_the_references():
    for name, (src, _xs) in INPUTS.items():
        assert _printed(compile_source(src).comp) == \
            _printed(jax_compile(src).comp), name


@pytest.mark.parametrize("name", ["int_sem", "loops", "floats", "state"])
def test_interp_and_jit_equal_the_references(name):
    """Both backends of both packages on the same input: the
    interpreters bitwise (both numpy), the jit backends at _same's
    tolerance. The device paths of the evaluator run here: vmapped
    firings with where-merged ifs, the lane-vector loop, the plain
    float loop, GF(2) compression and a localized stateful stage."""
    src, xs = INPUTS[name]
    prog, ref = compile_source(src), jax_compile(src)
    np.testing.assert_array_equal(run(prog.comp, list(xs)).out_array(),
                                  jax_run(ref.comp, list(xs)).out_array())
    E.reset_counts()
    _same(run_jit(prog.comp, xs, device="cpu"),
          jax_run_jit(ref.comp, xs))


def test_out_of_range_indexes_follow_lax_on_jit():
    """The interpreter (both packages) refuses an out-of-range slice;
    the jit backends wrap a negative index once, clamp reads and slice
    starts, and drop out-of-range element writes."""
    src, xs = INPUTS["out_of_range"]
    prog, ref = compile_source(src), jax_compile(src)
    with pytest.raises(ZiriaRuntimeError):
        run(prog.comp, list(xs))
    _same(run_jit(prog.comp, xs, device="cpu"), jax_run_jit(ref.comp, xs))


CORRELATE = """
let comp main = read[double] >>> repeat {
  (x : arr[72] double) <- takes 72;
  var h : arr[32] double;
  var out : arr[40] double;
  do {
    for i in [0, 32] { h[i] := x[i + 40] * 0.5 };
    for k in [0, 40] {
      var cr : double := 0.0;
      var ci : double := 0.0;
      for i in [0, 32] {
        cr := cr + x[k + i] * h[i] * 0.001;
        ci := ci - x[k + i] * h[31 - i] * 0.003 + cr * 0.5
      };
      out[k] := cr * cr + ci
    }
  };
  emits out
} >>> write[double]
"""


def test_nested_reduction_loop_is_one_lane_vector_pass(monkeypatch):
    """A loop whose body holds an inner reduction over its own locals (a
    correlation: the flagship's LTS timing) runs in a device block as
    ONE lane-vector pass around a plain inner loop, each lane adding in
    the sequential order: bitwise the plain device loop, in 32
    device-loop iterations instead of 40 x 32; within 1e-5 of the
    interpreters (numpy's float32 arithmetic on the host rounds a few
    sums differently from torch's, before and after this rewrite),
    which agree bitwise with each other."""
    from ziria_tpu_torch.backend import hybrid

    xs = np.random.default_rng(11).normal(scale=1000.0, size=144) \
        .astype(np.float32)
    prog = compile_source(CORRELATE)
    want = np.asarray(run(prog.comp, list(xs)).out_array())
    ref = np.asarray(jax_run(jax_compile(CORRELATE).comp,
                             list(xs)).out_array())
    np.testing.assert_array_equal(want, ref)
    hyb = hybrid.hybridize(prog.comp, device="cpu")
    E.reset_counts()
    got = np.asarray(run(hyb, list(xs)).out_array())
    assert hybrid.BLOCKS["device"] >= 2
    assert E.COUNTS["device_loop_iters"] == 2 * 32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    monkeypatch.setattr(E, "NESTED_LANE_PASS", False)
    E.reset_counts()
    plain = np.asarray(run(hyb, list(xs)).out_array())
    assert E.COUNTS["device_loop_iters"] > 2 * 40 * 32
    np.testing.assert_array_equal(plain, got)
