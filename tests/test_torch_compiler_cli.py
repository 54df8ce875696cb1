"""The port's CLI (``python -m ziria_tpu_torch``), torch only.

Flags and subcommands of the reference's driver whose modules are not
ported exit non-zero naming their ROADMAP item (``lint`` names 4d;
``--ddump-vect``, ``--scan`` and the ``--batch-*`` files name item 6b;
``--sp``, ``--pp`` and ``--pp-costs`` name 5); ``--autolut``,
``--fxp-complex16``, ``--state-in``/``--state-out``, ``--profile`` and
``--profile-trace`` run, and the ``serve``, ``programs`` and
``autotune`` subcommands reach their own parsers; without a card the
driver raises unless ``--platform=cpu`` is given; a program the jit
backend cannot lower runs on the hybrid backend after a note on stderr,
and the driver reports the backend that ran; the Viterbi knobs are
scoped to the invocation.
"""

import os

import numpy as np
import pytest
import torch

from ziria_tpu_torch.runtime import cli
from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream, \
    write_stream

# a firing whose while loop runs a data-dependent number of times: no
# vmapped step can run it, so the jit backend refuses it
DYNAMIC = """
let comp main = read[int32] >>> repeat {
  x <- take;
  var i : int32 := 0;
  var acc : int32 := 0;
  do {
    while (i < x) { acc := acc + i; i := i + 1 }
  };
  emit acc
} >>> write[int32]
"""

STATIC = """
fun incr(x: int32) : int32 { return x * 3 - 1 }
let comp main = read[int32] >>> map incr >>> write[int32]
"""


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(tmp_path, src, xs):
    p = tmp_path / "prog.zir"
    p.write_text(src)
    inf = tmp_path / "in.dbg"
    write_stream(StreamSpec(ty="int32", path=str(inf), mode="dbg"), xs)
    return str(p), str(inf), str(tmp_path / "out.dbg")


def _argv(src, inf, outf, *extra):
    return [f"--src={src}", f"--input-file-name={inf}",
            f"--output-file-name={outf}", *extra]


@pytest.mark.parametrize("flag", sorted(cli.REFUSED_FLAGS))
def test_refused_flag_names_its_roadmap_item(flag, capsys):
    kind, item = cli.REFUSED_FLAGS[flag][1], cli.REFUSED_FLAGS[flag][2]
    argv = ["--src=x.zir", flag] + ([] if kind == "store_true" else ["v"])
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet (ROADMAP Queue 1 item {item})" in err


def test_scan_and_batch_files_name_item_6b(capsys):
    """They run framebatch.run_many and the chunked state machines (and
    --ddump-vect the vectorizer), which item 6b ports; the mesh flags
    name item 5 and lint 4d."""
    for flag in ("--scan", "--batch-input-files", "--batch-output-files",
                 "--ddump-vect"):
        assert cli.REFUSED_FLAGS[flag][2] == "6b"
    for flag in ("--sp", "--pp", "--pp-costs"):
        assert cli.REFUSED_FLAGS[flag][2] == "5"
    assert cli.REFUSED_SUBCOMMANDS == {"lint": "4d"}
    with pytest.raises(SystemExit) as e:
        cli.main(["--src=x.zir", "--scan"])
    assert e.value.code == 2
    assert "--scan is not ported yet (ROADMAP Queue 1 item 6b)" in \
        capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--autolut", "--fxp-complex16",
                                  "--state-in", "--state-out"])
def test_ported_flag_runs(flag, tmp_path):
    """The flags this driver once refused run a program: the output is
    the program's; --state-in resumes a --state-out checkpoint, and on
    the interpreter the --state-* flags exit naming the jit backend."""
    src, inf, outf = _files(tmp_path, STATIC, np.arange(8, dtype=np.int32))
    ck = str(tmp_path / "state.npz")
    extra = [flag] if not flag.startswith("--state") else [f"{flag}={ck}"]
    if flag == "--state-in":
        assert cli.main(_argv(src, inf, outf, "--platform=cpu",
                              f"--state-out={ck}")) == 0
    assert cli.main(_argv(src, inf, outf, "--platform=cpu", *extra)) == 0
    assert cli.LAST_RUN["backend"] == "jit"
    got = read_stream(StreamSpec(ty="int32", path=outf, mode="dbg"))
    np.testing.assert_array_equal(got, np.arange(8) * 3 - 1)
    assert getattr(cli.build_parser().parse_args(["--src=x.zir", *extra]),
                   flag[2:].replace("-", "_"))
    if flag.startswith("--state"):
        assert os.path.exists(ck)
        with pytest.raises(SystemExit, match="need --backend=jit"):
            cli.main(_argv(src, inf, outf, "--platform=cpu",
                           "--backend=interp", *extra))


@pytest.mark.parametrize("flag", ["--profile", "--profile-trace"])
def test_profile_flag_runs(flag, tmp_path):
    """The profile flags this driver once refused run the program: its
    output is the plain run's, with the stage rows or the trace file."""
    src, inf, outf = _files(tmp_path, STATIC, np.arange(8, dtype=np.int32))
    extra = [flag] if flag == "--profile" else \
        [f"{flag}={tmp_path / 'trace'}"]
    assert cli.main(_argv(src, inf, outf, "--platform=cpu", *extra)) == 0
    got = read_stream(StreamSpec(ty="int32", path=outf, mode="dbg"))
    np.testing.assert_array_equal(got, np.arange(8) * 3 - 1)
    if flag == "--profile":
        assert cli.LAST_RUN["backend"] == "profile"
        assert [r["backend"] for r in cli.LAST_RUN["profile"]] == ["jit"]
    else:
        assert os.path.exists(cli.LAST_RUN["profile_trace"])


@pytest.mark.parametrize("sub", ["serve", "programs", "autotune"])
def test_ported_subcommand_runs(sub, capsys):
    """Dispatched before the flags are parsed, to its own parser."""
    with pytest.raises(SystemExit) as e:
        cli.main([sub, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert f"ziria_tpu_torch {sub}" in out and "--platform" in out


@pytest.mark.parametrize("sub", sorted(cli.REFUSED_SUBCOMMANDS))
def test_refused_subcommand_names_its_roadmap_item(sub, capsys):
    assert cli.main([sub, "--help"]) == 2
    item = cli.REFUSED_SUBCOMMANDS[sub]
    assert f"`{sub}` subcommand is not ported yet (ROADMAP Queue 1 item " \
           f"{item})" in capsys.readouterr().err


def test_without_a_card_the_driver_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, inf, outf = _files(tmp_path, STATIC, np.arange(8, dtype=np.int32))
    with pytest.raises(RuntimeError, match="--platform=cpu"):
        cli.main(_argv(src, inf, outf))
    assert not os.path.exists(outf)
    assert cli.main(_argv(src, inf, outf, "--platform=cpu")) == 0
    got = read_stream(StreamSpec(ty="int32", path=outf, mode="dbg"))
    np.testing.assert_array_equal(got, np.arange(8) * 3 - 1)


def test_unlowerable_program_falls_back_to_hybrid(tmp_path, capsys):
    xs = np.array([0, 3, 7, 1, 5], np.int32)
    src, inf, outf = _files(tmp_path, DYNAMIC, xs)
    assert cli.main(_argv(src, inf, outf, "--platform=cpu",
                          "--backend=jit", "--stats")) == 0
    err = capsys.readouterr().err
    assert "falling back to --backend=hybrid" in err
    assert "data-dependent control flow" in err
    assert "run: backend=hybrid" in err
    assert cli.LAST_RUN["backend"] == "hybrid"
    got = read_stream(StreamSpec(ty="int32", path=outf, mode="dbg"))
    np.testing.assert_array_equal(got, [x * (x - 1) // 2 for x in xs])
    # a lowerable program stays on jit, and --ddump-hybrid dumps a plan
    src, inf, outf = _files(tmp_path, STATIC, xs)
    assert cli.main(_argv(src, inf, outf, "--platform=cpu",
                          "--ddump-hybrid", "--stats")) == 0
    err = capsys.readouterr().err
    assert "hybrid plan:" in err and "plan: width=" in err
    assert "falling back" not in err and cli.LAST_RUN["backend"] == "jit"


def test_viterbi_knobs_are_scoped_to_the_invocation(tmp_path, monkeypatch):
    monkeypatch.setenv("ZIRIA_VITERBI_WINDOW", "512")
    monkeypatch.delenv("ZIRIA_VITERBI_RADIX", raising=False)
    seen = {}
    real = cli._run_cmd

    def spy(args):
        seen.update({k: os.environ.get(k) for k in
                     ("ZIRIA_VITERBI_WINDOW", "ZIRIA_VITERBI_RADIX")})
        return real(args)

    monkeypatch.setattr(cli, "_run_cmd", spy)
    src, inf, outf = _files(tmp_path, STATIC, np.arange(4, dtype=np.int32))
    assert cli.main(_argv(src, inf, outf, "--platform=cpu",
                          "--viterbi-window=0", "--viterbi-radix=4")) == 0
    assert seen == {"ZIRIA_VITERBI_WINDOW": "0", "ZIRIA_VITERBI_RADIX": "4"}
    assert os.environ["ZIRIA_VITERBI_WINDOW"] == "512"
    assert "ZIRIA_VITERBI_RADIX" not in os.environ
