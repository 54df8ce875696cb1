"""The port's hybrid backend: its plan against the reference's, and its
device blocks' rules (CPU; no JAX compile runs here).

``hybridize`` of the flagship receiver must make the reference's
decision for every do-block (weight, effects, threshold). A block
placed on the device runs the evaluator in device mode, and if it
fails there the run raises: nothing demotes it to the host, and no
plain device loop takes over from a lane-vector or GF(2) pass that
meets a device fault (only an analysis gap hands over). A block
whose environment holds a value with no device form runs on the host.
A lane-vector ``if`` writes array elements only from the lanes whose
arm writes them: on the card colliding scatter writes land in no fixed
order, so a masked lane writing its old value back onto a live lane's
element (through a wrapped negative index) would race it.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend.hybrid import hybridize as jax_hybridize
from ziria_tpu.core.opt import fold as jax_fold
from ziria_tpu.frontend import compile_file as jax_compile_file
from ziria_tpu_torch.backend import hybrid
from ziria_tpu_torch.core import ir
from ziria_tpu_torch.core.opt import fold
from ziria_tpu_torch.frontend import compile_file, compile_source
from ziria_tpu_torch.frontend import eval as E
from ziria_tpu_torch.frontend import externals
from ziria_tpu_torch.interp.interp import run

WIFI_RX = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "wifi_rx.zir")

# a heavy do-block (weight over MIN_JIT_WEIGHT) whose lane-vector if
# writes sym[k - 16] only for k >= 16: lanes 0-15 index -16..-1, which
# wrap onto sym[48..63], the elements lanes 64-79 write
ROTATE = """
ext fun sqrt(x: double) : double
let comp main = read[int32] >>> repeat {
  (raw : arr[80] int32) <- takes 80;
  var sym : arr[64] int32;
  var g : double := 0.0;
  do {
    for k in [0, 80] {
      if (k >= 16) then { sym[k - 16] := raw[k] * 3 + k }
    };
    for k in [0, 64] { g := g + sqrt(abs(raw[k]) * 1.0) }
  };
  emits sym
} >>> write[int32]
"""


def _plan(fn, comp, **kw):
    lines = []
    fn(comp, dump=lines.append, **kw)
    return lines


def test_wifi_rx_plan_is_the_references():
    port = _plan(hybrid.hybridize, fold(compile_file(WIFI_RX).comp),
                 chunk_loops=False, device="cpu")
    ref = _plan(jax_hybridize, jax_fold(jax_compile_file(WIFI_RX).comp),
                chunk_loops=False)
    assert port == ref
    assert sum(ln.endswith("-> jit") for ln in port) >= 10


def test_loops_stay_on_the_host_interpreter():
    """With chunk_loops (the CLI's default) the flagship's whole plan is
    the reference's, line for line: its stream-control loops, 1 While
    and 32 For, become chunk machines (backend/chunked.py) named in the
    reference's words and order, and every do-block decision outside
    them is the reference's. (The name dates from the slice in which
    every loop stayed on the host interpreter.)"""
    port = _plan(hybrid.hybridize, fold(compile_file(WIFI_RX).comp),
                 device="cpu")
    ref = _plan(jax_hybridize, jax_fold(jax_compile_file(WIFI_RX).comp))
    assert port == ref
    loops = [ln.strip() for ln in port
             if "chunked" in ln or ln.lstrip().startswith("loop ")]
    assert loops == ["chunked While"] + ["chunked For"] * 32


def test_device_block_failure_raises(monkeypatch):
    prog = compile_source(ROTATE)
    xs = np.arange(160, dtype=np.int32)
    want = run(prog.comp, list(xs)).out_array()
    real = externals.EXTERNALS["sqrt"]

    def device_fails(x):
        if isinstance(x, torch.Tensor):
            raise RuntimeError("injected device failure")
        return real(x)

    # the program's ext table was bound at compile time: recompile
    monkeypatch.setitem(externals.EXTERNALS, "sqrt", device_fails)
    prog = compile_source(ROTATE)
    assert np.array_equal(run(prog.comp, list(xs)).out_array(), want)
    with pytest.raises(RuntimeError, match="injected device failure"):
        run(hybrid.hybridize(prog.comp, device="cpu"), list(xs))

    # a device fault inside the lane-vector loop (its scatter of lane
    # writes) raises too: the plain device loop, which would not meet
    # it, does not take over
    monkeypatch.setitem(externals.EXTERNALS, "sqrt", real)
    prog = compile_source(ROTATE)
    monkeypatch.setattr(E, "_scatter", _fails_on_lanes(
        E._scatter, torch.cuda.OutOfMemoryError))
    with pytest.raises(torch.cuda.OutOfMemoryError, match="lane pass"):
        run(hybrid.hybridize(prog.comp, device="cpu"), list(xs))


def _fails_on_lanes(real, exc):
    """`E._scatter` that raises `exc` on a lane-vector index."""
    def scatter(old, i, v):
        if np.ndim(i) == 1:
            raise exc("injected in the lane pass")
        return real(old, i, v)
    return scatter


# a descrambler in a heavy do-block: its 249-step LFSR loop runs as
# GF(2) block products (gf2.gf2_for)
DESCRAMBLE = """
let comp main = read[bit] >>> repeat {
  (bits : arr[256] bit) <- takes 256;
  var clear : arr[249] bit;
  do {
    var st : arr[7] bit;
    var fb : bit := '0;
    for k in [0, 7] { st[k] := bits[6 - k] };
    for p in [7, 249] {
      fb := st[6] ^ st[3];
      st[1, 6] := st[0, 6];
      st[0] := fb;
      clear[p - 7] := bits[p] ^ fb
    }
  };
  emits clear
} >>> write[bit]
"""


@pytest.mark.parametrize("where", ["lane_vector", "gf2"])
def test_analysis_gap_falls_back_and_device_fault_raises(monkeypatch,
                                                         where):
    """A lane-vector or GF(2) pass that meets an analysis gap (a
    TypeError) restores its cells and the plain device loop gives the
    interpreter's result; a device fault in the same place raises."""
    from ziria_tpu_torch.frontend import gf2

    rng = np.random.default_rng(4)
    if where == "lane_vector":
        # 2 blocks of 80: each runs its 64-step float loop plain, and
        # its 80-step rotate loop as one lane pass
        src, xs, plain_iters = ROTATE, rng.integers(-50, 50, 160), 2 * 144
        xs = xs.astype(np.int32)
    else:
        # 2 blocks of 256: each runs 7 + 249 steps, most of the 249
        # as GF(2) block products
        src, xs, plain_iters = DESCRAMBLE, rng.integers(0, 2, 512), 512
        xs = xs.astype(np.uint8)

    def plant(mp, exc):
        if where == "lane_vector":
            mp.setattr(E, "_scatter", _fails_on_lanes(E._scatter, exc))
        else:
            def compressed(*a, **k):
                raise exc("injected in the lane pass")
            mp.setattr(gf2, "_run_compressed", compressed)

    prog = compile_source(src)
    want = run(prog.comp, list(xs)).out_array()
    E.reset_counts()
    got = run(hybrid.hybridize(prog.comp, device="cpu"), list(xs))
    assert np.array_equal(np.asarray(got.out_array()), want)
    assert E.COUNTS["device_loop_iters"] < plain_iters
    with monkeypatch.context() as mp:
        plant(mp, TypeError)
        E.reset_counts()
        got = run(hybrid.hybridize(prog.comp, device="cpu"), list(xs))
        assert np.array_equal(np.asarray(got.out_array()), want)
        assert E.COUNTS["device_loop_iters"] == plain_iters
    plant(monkeypatch, torch.cuda.OutOfMemoryError)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="lane pass"):
        run(hybrid.hybridize(prog.comp, device="cpu"), list(xs))


def test_env_without_device_form_runs_on_host():
    def closure(env):
        return env.lookup("x") + 1

    closure.z_stmts = ()
    blk = hybrid._DeviceDo(closure, "cpu")
    blk._keep = blk._writes = frozenset({"x"})
    hybrid.reset_counts()
    env = ir.Env()
    env.bind("x", 41)
    assert blk(env) == 42
    env2 = ir.Env()
    env2.bind("x", np.array(["not", "numeric"], dtype=object))
    with pytest.raises(TypeError):
        blk(env2)                          # ran the closure on the host
    assert hybrid.BLOCKS == {"device": 1, "host": 1}


def test_masked_lanes_write_nothing(monkeypatch):
    """The hybrid run equals the interpreter with colliding scatter
    writes resolved first-lane-wins (the order the card may pick),
    and its do-block ran on the device through the lane-vector loop."""
    prog = compile_source(ROTATE)
    xs = np.random.default_rng(3).integers(-50, 50, 240).astype(np.int32)
    want = run(prog.comp, list(xs)).out_array()
    real = E._scatter

    def first_lane_wins(old, i, v):
        it = E._t(i, E._dev(old, i, v))
        vv = E._t(v, it.device)
        if it.dim() == 1:
            vv = vv.flip(0) if vv.dim() and vv.shape[0] == it.shape[0] \
                else vv
            return real(old, it.flip(0), vv)
        return real(old, i, v)

    monkeypatch.setattr(E, "_scatter", first_lane_wins)
    hybrid.reset_counts()
    E.reset_counts()
    got = run(hybrid.hybridize(prog.comp, device="cpu"), list(xs))
    assert np.array_equal(np.asarray(got.out_array()), want)
    assert hybrid.BLOCKS["device"] == 3
    # the rotate loop vectorized: only the 64-step float loop ran plain
    assert E.COUNTS["device_loop_iters"] == 3 * 64
