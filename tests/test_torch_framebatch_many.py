"""Frame batching of compiled programs in the port
(ziria_tpu_torch/backend/framebatch.py: StepBatcher, run_many) against
the JAX package's run_many on the CPU: the lockstep, ragged,
divergent-While and interpreter-tail sources of tests/test_framebatch.py
give every frame the reference's output and termination (bitwise:
integer sources), lockstep frames cost no more steps than one frame,
one frame's error surfaces while the others complete, max_out holds,
one frame takes the single-frame path, a failed batched step raises
for its whole group; four 60-byte wifi_rx.zir captures equal the
reference's own run_many and their PSDUs; and the CLI's
--batch-input-files/--batch-output-files."""

import os

import numpy as np
import pytest

from test_framebatch import TAKE_BRANCH_SRC, WHILE_SRC
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.backend import framebatch as jax_fb
from ziria_tpu.backend import hybrid as jax_hybrid
from ziria_tpu.frontend import compile_source as jax_compile
from ziria_tpu_torch.backend import chunked as C
from ziria_tpu_torch.backend import hybrid as H
from ziria_tpu_torch.backend.framebatch import StepBatcher, run_many
from ziria_tpu_torch.frontend import compile_source
from ziria_tpu_torch.interp.interp import run

TAIL_SRC = """
let comp main = read[int32] >>> {
  var s : int32 := 0;
  times 256 {
    x <- take;
    do { s := s + 1 };
    if (x < 0) then { y <- take; do { s := s + y } }
  };
  emit s * s
} >>> write[int32]
"""

ERROR_SRC = """
let comp main = read[int32] >>> {
  var s : int32 := 0;
  times 300 {
    x <- take;
    do { s := s + x }
  };
  if (s < 0) then { do { error "negative checksum" } };
  emit s
} >>> write[int32]
"""

MAXOUT_SRC = """
let comp main = read[int32] >>> repeat {
  var s : int32 := 0;
  times 64 { x <- take; do { s := s + x } };
  times 64 { emit s; do { s := s - 1 } }
} >>> write[int32]
"""

RNG = np.random.default_rng(3)

#: (source, frames) of the reference's run_many tests
CASES = {
    "lockstep": (TAKE_BRANCH_SRC, [(np.arange(300, dtype=np.int32) * k
                                    + k) % 251 for k in range(1, 9)]),
    "ragged": (TAKE_BRANCH_SRC, [np.arange(n, dtype=np.int32) % 97
                                 for n in (37, 150, 255, 256, 300, 512)]),
    "while": (WHILE_SRC, [RNG.integers(0, 50, 400).astype(np.int32)
                          for _ in range(6)]),
    "tail": (TAIL_SRC, [np.arange(n, dtype=np.int32)
                        for n in (256, 256, 257, 300)]),
}


@pytest.fixture(scope="module")
def hybrid_of():
    """Each source compiled and hybridized once per package for the
    module: the reference's jitted steps and the port's machines are
    shared by every case of a source."""
    cache = {}

    def get(src):
        if src not in cache:
            cache[src] = (jax_hybrid.hybridize(jax_compile(src).comp),
                          H.hybridize(compile_source(src).comp,
                                      device="cpu"))
        return cache[src]
    return get


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a.out_array()),
                          np.asarray(b.out_array())) \
        and a.terminated_by == b.terminated_by and a.value == b.value


def test_run_many_equals_the_references(hybrid_of):
    """Every case: each frame of the port's run_many equals its lone
    port run and the reference's run_many; the lockstep frames ride
    full-width groups within the single frame's step count."""
    for name, (src, frames) in CASES.items():
        jhyb, hyb = hybrid_of(src)
        ref = jax_fb.run_many(jhyb, frames)
        C.reset_counts()
        lone = [run(hyb, list(f)) for f in frames]
        single = C.STATS["device_calls"] / len(frames)
        b = StepBatcher(len(frames))
        got = run_many(hyb, frames, batcher=b)
        for g, w, r in zip(got, lone, ref):
            assert _same(g, w) and _same(g, r), name
        assert b.device_calls >= 1 and not C.DEMOTED, name
        if name == "lockstep":
            assert b.device_calls <= single
            assert max(b.group_sizes) == len(frames)


def test_error_max_out_and_the_single_frame_path(hybrid_of):
    """One frame's program error surfaces after the others finish (no
    deadlock, no swallow); max_out holds per frame under batching; one
    frame runs the single-frame path; no frames, no results."""
    hyb = H.hybridize(compile_source(ERROR_SRC).comp, device="cpu")
    good = [np.arange(300, dtype=np.int32) % 64 for _ in range(3)]
    bad = np.full(300, -1, np.int32)
    with pytest.raises(Exception, match="negative checksum"):
        run_many(hyb, good[:1] + [bad] + good[1:],
                 batcher=StepBatcher(4))
    jhyb, hyb = hybrid_of(MAXOUT_SRC)
    frames = [(np.arange(640, dtype=np.int32) * k) % 101
              for k in range(1, 5)]
    ref = jax_fb.run_many(jhyb, frames, max_out=100)
    got = run_many(hyb, frames, max_out=100,
                   batcher=StepBatcher(len(frames)))
    for g, r in zip(got, ref):
        assert len(g.outputs) == 100
        np.testing.assert_array_equal(np.asarray(g.out_array()),
                                      np.asarray(r.out_array()))
    hyb = hybrid_of(TAKE_BRANCH_SRC)[1]
    xs = np.arange(300, dtype=np.int32)
    C.reset_counts()
    (one,) = run_many(hyb, [xs])
    assert _same(one, run(hyb, list(xs)))
    assert run_many(hyb, []) == []


def test_wifi_rx_batch_equals_the_references_run_many():
    """Four 24 Mbit/s captures of 60 bytes + FCS through wifi_rx.zir:
    the port's run_many equals the reference's run_many and each
    capture's PSDU, every step a full-width group."""
    from ziria_tpu.frontend import compile_file as jax_compile_file
    from ziria_tpu.phy import channel as jax_channel
    from ziria_tpu_torch.frontend import compile_file

    src = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "wifi_rx.zir")
    caps = [jax_channel.impaired_capture(24, 60, seed=100 + k,
                                         add_fcs=True) for k in range(4)]
    frames = [[p for p in np.asarray(xi)] for _psdu, xi in caps]
    ref = jax_fb.run_many(jax_hybrid.hybridize(
        jax_compile_file(src).comp), frames)
    hyb = H.hybridize(compile_file(src).comp, device="cpu")
    b = StepBatcher(len(frames))
    C.reset_counts()
    got = run_many(hyb, frames, batcher=b)
    for (psdu, _xi), g, r in zip(caps, got, ref):
        bits = np.unpackbits(np.asarray(psdu), bitorder="little")
        np.testing.assert_array_equal(np.asarray(g.out_array(), np.uint8),
                                      bits)
        np.testing.assert_array_equal(np.asarray(g.out_array()),
                                      np.asarray(r.out_array()))
    assert max(b.group_sizes) == len(frames) and not C.DEMOTED


def test_batch_files_run_and_are_checked(tmp_path, hybrid_of):
    """--batch-input-files/--batch-output-files: each output file is
    its frame's lone run; the reference's checks and messages (both
    lists together, equal lengths, the hybrid backend only)."""
    from ziria_tpu_torch.runtime import cli
    from ziria_tpu_torch.runtime.buffers import (StreamSpec, read_stream,
                                                 write_stream)
    src = tmp_path / "p.zir"
    src.write_text(TAKE_BRANCH_SRC)
    frames = CASES["ragged"][1]
    ins, outs = [], []
    for k, f in enumerate(frames):
        ins.append(str(tmp_path / f"in{k}.dbg"))
        outs.append(str(tmp_path / f"out{k}.dbg"))
        write_stream(StreamSpec(ty="int32", path=ins[-1], mode="dbg"), f)
    base = [f"--src={src}", "--platform=cpu"]
    assert cli.main(base + [f"--batch-input-files={','.join(ins)}",
                            f"--batch-output-files={','.join(outs)}"]) == 0
    assert cli.LAST_RUN["frames"] == len(frames)
    assert cli.LAST_RUN["device_calls"] >= 1
    hyb = hybrid_of(TAKE_BRANCH_SRC)[1]
    for f, xs in zip(outs, frames):
        np.testing.assert_array_equal(
            read_stream(StreamSpec(ty="int32", path=f, mode="dbg")),
            np.asarray(run(hyb, list(xs)).out_array()))
    with pytest.raises(SystemExit, match="must be given together"):
        cli.main(base + ["--batch-input-files=a"])
    with pytest.raises(SystemExit, match="2 inputs but 1 outputs"):
        cli.main(base + ["--batch-input-files=a,b",
                         "--batch-output-files=c"])
    with pytest.raises(SystemExit, match="runs the hybrid backend"):
        cli.main(base + ["--backend=interp", "--batch-input-files=a",
                         "--batch-output-files=c"])


def test_a_failing_batched_step_raises(monkeypatch):
    """A fault inside a lane-batched step after the discovery pass
    reaches every frame of its group: the group's step runs once, it is
    never re-run lane by lane, and the machine is not demoted."""
    hyb = H.hybridize(compile_source(TAKE_BRANCH_SRC).comp, device="cpu")
    frames = CASES["lockstep"][1][:4]
    real = C._Machine._block
    calls = []

    def faulty(self, *a, **k):
        calls.append(1)
        raise RuntimeError("injected device fault")

    C.reset_counts()
    monkeypatch.setattr(C._Machine, "_block", faulty)
    with pytest.raises(RuntimeError, match="injected device fault"):
        run_many(hyb, frames, batcher=StepBatcher(len(frames)))
    monkeypatch.setattr(C._Machine, "_block", real)
    assert len(calls) == 1 and not C.DEMOTED
    b = StepBatcher(len(frames))
    got = run_many(hyb, frames, batcher=b)
    for g, xs in zip(got, frames):
        assert _same(g, run(hyb, list(xs)))
    assert b.device_calls >= 1 and not C.DEMOTED
