"""Checkpoint/resume of the port's stream state (ziria_tpu_torch/runtime/
state.py over ``run_jit_carry``'s carry), on the CPU: a stream fed in
pieces with the carry threaded through (optionally through an ``.npz``
checkpoint) equals the one-shot run and the JAX package's one-shot
output; the checkpoint keeps the reference's keys; a wrong program, a
dtype change, a narrowing chunk and a fingerprint mismatch are rejected
as ``tests/test_state.py`` has them rejected; and the CLI round-trips
``--state-out`` then ``--state-in``.
"""

import os

import numpy as np
import pytest

import ziria_tpu_torch as z
from test_torch_fleet import one_thread  # noqa: F401  (autouse)
from ziria_tpu_torch.backend.execute import run_jit, run_jit_carry
from ziria_tpu_torch.backend.lower import lower
from ziria_tpu_torch.frontend import compile_source
from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream, \
    write_stream
from ziria_tpu_torch.runtime.cli import main as cli_main
from ziria_tpu_torch.runtime.state import (load_state, program_fingerprint,
                                           save_state, tree_leaves)

CPU = dict(device="cpu")
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

SCRAMBLER = """
  let comp main = read[bit] >>> {
    var st : arr[7] bit := {'1,'0,'1,'1,'1,'0,'1};
    repeat {
      x <- take;
      var fb : bit := '0;
      do { fb := st[3] ^ st[0];
           st[0, 6] := st[1, 6];
           st[6] := fb };
      emit x ^ fb
    }
  } >>> write[bit]
"""

FFT = """
  ext fun v_fft(x: arr[64] complex16) : arr[64] complex16
  let comp main = read[complex16] >>>
    repeat { (s: arr[64] complex16) <- takes 64; emits v_fft(s) }
    >>> write[complex16]
"""


@pytest.fixture(scope="module")
def stream():
    """1024 random bits and the JAX package's one-shot scrambler output
    on them (the reference run once)."""
    from ziria_tpu.backend.execute import run_jit as ref_run_jit
    from ziria_tpu.frontend import compile_source as ref_compile

    xs = np.random.default_rng(0).integers(0, 2, 1024).astype(np.uint8)
    return xs, np.asarray(ref_run_jit(ref_compile(SCRAMBLER).comp, xs))


def test_split_run_equals_one_shot_and_reference(stream):
    """Split at (300, 700), (1, 1023) and 512: each equals the port's
    one-shot run and the reference's."""
    xs, ref = stream
    prog = compile_source(SCRAMBLER).comp
    want = run_jit(prog, xs, **CPU)
    np.testing.assert_array_equal(want, ref)
    for cuts in ((300, 700), (1, 1023), (512,)):
        outs, carry = [], None
        for lo, hi in zip((0,) + cuts, cuts + (len(xs),)):
            ys, carry = run_jit_carry(prog, xs[lo:hi], carry=carry, **CPU)
            outs.append(ys)
        np.testing.assert_array_equal(np.concatenate(outs), ref)
    # a cut inside a steady-state iteration rides in the leftover
    fft = compile_source(FFT).comp
    cs = np.random.default_rng(3).integers(-500, 500, (256, 2)) \
        .astype(np.int16)
    whole = run_jit(fft, cs, **CPU)
    y1, c = run_jit_carry(fft, cs[:100], **CPU)
    assert y1.shape[0] == 64 and c["leftover"].shape[0] == 36
    y2, c = run_jit_carry(fft, cs[100:129], carry=c, **CPU)
    y3, c = run_jit_carry(fft, cs[129:], carry=c, **CPU)
    np.testing.assert_array_equal(np.concatenate([y1, y2, y3]), whole)


def test_checkpoint_round_trips_through_disk(stream, tmp_path):
    """save_state, a fresh load_state against the pipeline's template,
    the resumed run: equal to the reference's one-shot output. The file
    holds the reference's keys."""
    xs, ref = stream
    prog = compile_source(SCRAMBLER).comp
    ys1, carry = run_jit_carry(prog, xs[:256], **CPU)
    ck = str(tmp_path / "ck.npz")
    fp = program_fingerprint(prog)
    save_state(ck, carry, fingerprint=fp)
    with np.load(ck) as f:
        n = int(f["n_leaves"])
        assert n == len(tree_leaves(carry["stages"])) >= 1
        assert set(f.files) == {"n_leaves", "leftover", "fingerprint",
                                *(f"leaf{i}" for i in range(n))}
    like = lower(prog, **CPU).init_carry
    carry2 = load_state(ck, like=like, fingerprint=fp)
    ys2, _ = run_jit_carry(prog, xs[256:], carry=carry2, **CPU)
    np.testing.assert_array_equal(np.concatenate([ys1, ys2]), ref)
    # the same program compiled again has the same fingerprint
    assert program_fingerprint(compile_source(SCRAMBLER).comp) == fp


def _reject(kind, tmp_path):
    prog = compile_source(SCRAMBLER).comp
    _, carry = run_jit_carry(prog, np.zeros(64, np.uint8), **CPU)
    ck = str(tmp_path / "ck.npz")
    save_state(ck, carry)
    if kind == "wrong_program":
        other = z.map_accum(lambda s, x: (s + x, s + x),
                            np.zeros((3,), np.float32), name="acc3")
        load_state(ck, like=lower(other, **CPU).init_carry)
    elif kind == "dtype":
        shapes = [np.shape(v) for v in tree_leaves(carry["stages"])]
        other = z.map_accum(lambda s, x: (s, x),
                            tuple(np.zeros(s, np.float32) for s in shapes),
                            name="floaty")
        load_state(ck, like=lower(other, **CPU).init_carry)
    elif kind in ("narrowing", "lossy_kind"):
        fft = compile_source(FFT).comp
        cs = np.random.default_rng(7).integers(-500, 500, (128, 2)) \
            .astype(np.int16)
        _, c = run_jit_carry(fft, cs[:100], **CPU)
        chunk = cs[100:].astype(np.int32) if kind == "narrowing" \
            else cs[100:].astype(np.float64) + 0.9
        run_jit_carry(fft, chunk, carry=c, **CPU)
    elif kind == "fingerprint":
        p1 = z.pipe(z.zmap(np.negative), z.zmap(np.abs))
        p2 = z.pipe(z.zmap(np.negative), z.zmap(np.exp))
        assert program_fingerprint(p1) != program_fingerprint(p2)
        assert program_fingerprint(z.pipe(z.zmap(lambda x: x + 1))) != \
            program_fingerprint(z.pipe(z.zmap(lambda x: x * 2)))
        fp = str(tmp_path / "s.npz")
        save_state(fp, {"stages": [], "leftover": np.empty(0)},
                   fingerprint="aaaabbbbccccdddd")
        load_state(fp, [], fingerprint="aaaabbbbccccdddd")   # loads
        load_state(fp, [])                                   # loads
        load_state(fp, [], fingerprint="0000111122223333")
    else:                                                    # malformed
        run_jit_carry(prog, np.zeros(8, np.uint8),
                      carry={"stage": None, "leftover": np.empty(0)},
                      **CPU)


def test_layout_mismatches_are_rejected(tmp_path):
    """A checkpoint loaded against another program's state (leaf count
    or shape, then dtype) and a malformed carry dict."""
    for kind, match in (("wrong_program", "wrong program|shape"),
                        ("dtype", "dtype"), ("malformed", "stages")):
        with pytest.raises(ValueError, match=match):
            _reject(kind, tmp_path)


def test_chunk_and_fingerprint_mismatches_are_rejected(tmp_path):
    """A resumed chunk that narrows (int32 into int16) or changes kind
    (float into int16), and a checkpoint of another program by its
    fingerprint."""
    for kind, match in (("narrowing", "losslessly"), ("lossy_kind", "dtype"),
                        ("fingerprint", "different program")):
        with pytest.raises(ValueError, match=match):
            _reject(kind, tmp_path)


def test_cli_state_roundtrip(tmp_path, capsys):
    """--state-out then --state-in through the port's CLI equals one
    shot (scrambler.zir), and --stats of a resumed run counts the
    checkpoint's leftover items (fft64.zir: 100 items = 1 iteration + 36
    left, then 156 more = 3 iterations)."""
    def run_cli(src, ty, arr, tag, extra):
        inf, outf = tmp_path / f"i{tag}.dbg", tmp_path / f"o{tag}.dbg"
        write_stream(StreamSpec(ty=ty, path=str(inf)), arr)
        rc = cli_main([f"--src={os.path.join(EXAMPLES, src)}",
                       "--input=file", f"--input-file-name={inf}",
                       "--output=file", f"--output-file-name={outf}",
                       "--platform=cpu", *extra])
        assert rc == 0
        return read_stream(StreamSpec(ty=ty, path=str(outf)))

    xs = np.random.default_rng(2).integers(0, 2, 512).astype(np.uint8)
    want = run_cli("scrambler.zir", "bit", xs, "all", [])
    ck = str(tmp_path / "cli_ck.npz")
    y1 = run_cli("scrambler.zir", "bit", xs[:256], "a", [f"--state-out={ck}"])
    y2 = run_cli("scrambler.zir", "bit", xs[256:], "b", [f"--state-in={ck}"])
    np.testing.assert_array_equal(np.concatenate([y1, y2]), want)

    cs = np.random.default_rng(8).integers(-500, 500, (256, 2)) \
        .astype(np.int16)
    ck2 = str(tmp_path / "ck2.npz")
    capsys.readouterr()
    run_cli("fft64.zir", "complex16", cs[:100], "c",
            ["--stats", f"--state-out={ck2}"])
    capsys.readouterr()
    run_cli("fft64.zir", "complex16", cs[100:], "d",
            ["--stats", f"--state-in={ck2}"])
    err = capsys.readouterr().err
    assert "remainder_iters=3" in err, err
    # another program's checkpoint is refused by its fingerprint
    with pytest.raises(ValueError, match="different program"):
        run_cli("scrambler.zir", "bit", xs, "e", [f"--state-in={ck2}"])
