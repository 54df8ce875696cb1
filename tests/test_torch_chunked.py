"""The port's chunked stream-control machines (ziria_tpu_torch/backend/
chunked.py) against the JAX package on the CPU: the sources of
tests/test_chunked.py through both packages' interpreters and both
packages' chunked hybrid executors, outputs and termination equal
(bitwise: every source is integer), a second run of the same wrapped
object equal too; the wrap decisions dumped in the reference's words;
the demotion rule (only a structural refusal before the loop runs) and
the card's rule (a failing step raises, it is never re-run on the
host)."""

import numpy as np
import pytest

from test_chunked import (EMIT_WHILE_SRC, TAKE_BRANCH_SRC,
                          VAR_TAKE_TAIL_SRC, WHILE_SRC)
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend import hybrid as jax_hybrid
from ziria_tpu.frontend import compile_source as jax_compile
from ziria_tpu.interp.interp import run as jax_run
from ziria_tpu_torch.backend import chunked as C
from ziria_tpu_torch.backend import hybrid as H
from ziria_tpu_torch.frontend import compile_source
from ziria_tpu_torch.interp.interp import run

REPEAT_SRC = """
let comp main = read[int32] >>> repeat {
  (h : arr[4] int32) <- takes 4;
  var s : int32 := 0;
  times 60 {
    x <- take;
    do { if (x > h[0]) then { s := s + x } else { s := s - x } }
  };
  emit s
} >>> write[int32]
"""

LEAD_SRC = """
let comp main = read[int32] >>> {
  var lead : arr[48] int32;
  var g : int32 := 0;
  var acc : int32 := 0;
  do { for i in [0, 48] { lead[i] := 1000 + i } };
  times 8 {
    times 40 {
      var v : int32 := 0;
      if (g < 48) then { do { v := lead[g] } }
      else { x <- take; do { v := x * 2 } };
      do { g := g + 1; acc := acc + v }
    };
    emit acc
  }
} >>> write[int32]
"""

EFFECT_SRC = """
let comp main = read[int32] >>> {
  var s : int32 := 0;
  times 300 { x <- take; do { s := s + x; println s } };
  emit s
} >>> write[int32]
"""

NESTED_WHILE_SRC = """
let comp main = read[int32] >>> {
  var s : int32 := 0;
  times 256 {
    x <- take;
    do { var k : int32 := x % 3; while (k > 0) { s := s + k; k := k - 1 } }
  };
  emit s
} >>> write[int32]
"""

RNG = np.random.default_rng(20261018)

#: (source, inputs): every input list runs through all four executors
CASES = {
    "take_branch": (TAKE_BRANCH_SRC, [np.arange(n, dtype=np.int32)
                                      for n in (0, 1, 79, 255, 300)]),
    "while": (WHILE_SRC, [(np.arange(1000, dtype=np.int32) * 7919) % 97,
                          np.zeros(7, np.int32)]),
    "emit_while": (EMIT_WHILE_SRC, [
        (np.arange(3000, dtype=np.int32) * 13) % 37, np.ones(63, np.int32),
        np.zeros(500, np.int32),
        RNG.integers(0, 50, 1500).astype(np.int32)]),
    "var_take_tail": (VAR_TAKE_TAIL_SRC, [
        np.arange(256, dtype=np.int32),
        np.arange(300, dtype=np.int32) - 5]),
    "repeat": (REPEAT_SRC, [(np.arange(64 * 5, dtype=np.int32) * 13)
                            % 101]),
    "lead_buffer": (LEAD_SRC, [np.arange(400, dtype=np.int32)]),
}


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a.out_array()),
                          np.asarray(b.out_array())) \
        and a.terminated_by == b.terminated_by


@pytest.fixture(scope="module")
def reference():
    """The JAX package's interpreter and chunked runs of every case."""
    out = {}
    for name, (src, inputs) in CASES.items():
        prog = jax_compile(src)
        hyb = jax_hybrid.hybridize(prog.comp)
        out[name] = [(jax_run(prog.comp, list(xs)), jax_run(hyb, list(xs)))
                     for xs in inputs]
    return out


def test_chunk_machines_equal_the_reference(reference):
    """Every source, every input: the port's chunked run equals the
    port's interpreter and both of the reference's runs, twice through
    the same wrapped object; every loop the reference wraps is a
    machine here that ran on the device (no demotion)."""
    for name, (src, inputs) in CASES.items():
        prog = compile_source(src)
        hyb = H.hybridize(prog.comp, device="cpu")
        C.reset_counts()
        for xs, (jw, jc) in zip(inputs, reference[name]):
            want = run(prog.comp, list(xs))
            for _rep in range(2):
                got = run(hyb, list(xs))
                assert _same(got, want), name
                assert _same(got, jw) and _same(got, jc), name
        # the repeat case's loop moves 60 items a frame, under the
        # MIN_ITEMS_FOR gate: it runs on the interpreter, as there
        assert (C.STATS["device_calls"] >= 1) == (name != "repeat"), name
        assert not C.DEMOTED, (name, C.DEMOTED)


def test_emitting_while_small_iter_cap(monkeypatch, reference):
    """A tiny output budget makes one execution take many steps: the
    cap, flush and re-entry stay exact (the reference's own test)."""
    monkeypatch.setattr(C, "WHILE_OUT_ITEMS", 32)
    src, inputs = CASES["emit_while"]
    hyb = H.hybridize(compile_source(src).comp, device="cpu")
    C.reset_counts()
    for xs, (jw, _jc) in zip(inputs, reference["emit_while"]):
        assert _same(run(hyb, list(xs)), jw)
    assert C.STATS["device_calls"] >= 8


def test_wrap_decisions_are_the_references():
    """The dump names the same machines, in the same words and order,
    as the reference's --ddump-hybrid (loops only; an effectful loop
    stays interpreted), and the runtime gate keeps a tiny loop on the
    interpreter."""
    for src in (TAKE_BRANCH_SRC, WHILE_SRC, EMIT_WHILE_SRC, LEAD_SRC,
                EFFECT_SRC, NESTED_WHILE_SRC):
        port, ref = [], []
        H.hybridize(compile_source(src).comp, dump=port.append,
                    device="cpu")
        jax_hybrid.hybridize(jax_compile(src).comp, dump=ref.append)
        loops = [ln for ln in port if "chunked" in ln or "loop " in ln]
        assert loops == [ln for ln in ref
                         if "chunked" in ln or "loop " in ln]
        assert loops
    tiny = """
    let comp main = read[int32] >>> {
      var s : int32 := 0;
      times 4 { x <- take; do { s := s + x } };
      emit s
    } >>> write[int32]
    """
    hyb = H.hybridize(compile_source(tiny).comp, device="cpu")
    C.reset_counts()
    xs = np.arange(10, dtype=np.int32)
    assert _same(run(hyb, list(xs)), jax_run(jax_compile(tiny).comp,
                                             list(xs)))
    assert C.STATS["device_calls"] == 0


def test_structural_refusal_demotes_before_the_loop_runs():
    """A statement while on a lane value (no per-lane form without a
    host read; the reference stages it as a lax.while_loop) is refused
    by the discovery pass, before any state changed: the loop runs on
    the interpreter, the demotion is recorded, the output is exact."""
    prog = compile_source(NESTED_WHILE_SRC)
    hyb = H.hybridize(prog.comp, device="cpu")
    xs = (np.arange(300, dtype=np.int32) * 7) % 11
    C.reset_counts()
    assert _same(run(hyb, list(xs)), run(prog.comp, list(xs)))
    assert C.DEMOTED and "differs per firing" in C.DEMOTED[0][1]
    assert C.STATS["device_calls"] == 0
    # the node stays demoted: a second run never steps
    assert _same(run(hyb, list(xs)), run(prog.comp, list(xs)))
    assert C.STATS["device_calls"] == 0


def test_a_failing_step_raises(monkeypatch):
    """A fault inside a step after the discovery pass (a device fault
    on the card) surfaces: it is never caught and re-run on the
    host."""
    prog = compile_source(TAKE_BRANCH_SRC)
    hyb = H.hybridize(prog.comp, device="cpu")
    real = C._Machine._block
    C.reset_counts()

    def faulty(self, *a, **k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(C._Machine, "_block", faulty)
    with pytest.raises(RuntimeError, match="injected device fault"):
        run(hyb, list(np.arange(300, dtype=np.int32)))
    monkeypatch.setattr(C._Machine, "_block", real)
    assert not C.DEMOTED
    # the machine is not broken: the next run steps on the device
    C.reset_counts()
    xs = np.arange(300, dtype=np.int32)
    assert _same(run(hyb, list(xs)), run(prog.comp, list(xs)))
    assert C.STATS["device_calls"] >= 2


def test_a_host_read_inside_a_step_is_refused():
    """A step may not read a device value on the host (a CUDA graph
    cannot record it): the evaluator's guard raises inside a step,
    which the discovery pass turns into a recorded demotion."""
    import torch

    from ziria_tpu_torch.frontend import eval as E
    E._CAPTURE["guard"] = True
    try:
        with pytest.raises(E.DeviceControlError, match="on the host"):
            E._sync_bool(torch.tensor(True))
        with pytest.raises(E.DeviceControlError, match="on the host"):
            E._to_host(torch.tensor(1))
    finally:
        E._CAPTURE["guard"] = False
    assert E._sync_bool(torch.tensor(True)) is True
