"""The port's `lint` (ziria_tpu_torch/analysis): the gate, zero
findings over ``ziria_tpu_torch/`` (every suppression a pragma with a
reason); the engine and the carried-over rules R4 and R5 against the
reference's on its own fixtures (the same findings, line, column and
message); port-only fixtures for the retargeted R2, R3 and R6; the
pragma grammar; the CLI (exit codes 0/1/2, JSON, --list-rules naming R1
as not run) and `python -m ziria_tpu_torch lint` without torch. Pure
AST, no torch or jax in the analysis itself."""

import json
import os
import subprocess
import sys

from test_lint import (R4_NEGATIVE, R4_TP_IMPORT_TIME, R4_TP_SCATTERED,
                       R4_TP_WRITE, R5_NEGATIVE, R5_TP_ANNOTATION,
                       R5_TP_CALLSITE, R5_TP_NESTED)
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.analysis import lint_source as jax_lint_source
from ziria_tpu.analysis.rules import RULES_BY_ID as JAX_RULES
from ziria_tpu_torch.analysis import NOT_RUN, lint_paths, lint_source
from ziria_tpu_torch.analysis.__main__ import main as lint_main
from ziria_tpu_torch.analysis.rules import RULES_BY_ID

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ziria_tpu_torch")


def _findings(src, rules=None, path="fixture.py"):
    objs = [RULES_BY_ID[r] for r in rules] if rules else None
    return lint_source(src, path, rules=objs).findings


def _rules_of(findings):
    return sorted({f.rule for f in findings})


R2_TP = '''
import torch
from ziria_tpu_torch.utils import dispatch

def decode(x):
    with dispatch.timed("rx.decode"):
        y = torch.cumsum(x, 0)
        n = int(y[-1])
        bits = y.cpu()
        torch.cuda.synchronize()
    return n, bits
'''

R2_NEGATIVE = '''
import numpy as np
import torch
from ziria_tpu_torch.utils import dispatch

def decode(x, table: np.ndarray):
    with dispatch.timed("rx.decode"):
        y = torch.cumsum(x, 0)
        k = table.item()              # numpy, not a tensor
    return int(y[-1]), y.cpu(), k     # after the timed region
'''

R3_TP = '''
from ziria_tpu_torch.ops import viterbi_cuda as vc
from ziria_tpu_torch.ops.viterbi_fused import fused_acs_rate

def decode(llr, data, gain, rate, nbits, mach):
    dec, m = vc.acs(llr)
    fused_acs_rate(data, gain, rate, nbits)
    node._machines[key].run([args])
    return vc.traceback(dec, m)
'''

R3_NEGATIVE = '''
from ziria_tpu_torch.ops import viterbi_cuda as vc
from ziria_tpu_torch.utils import dispatch

def decode(llr, node, key, args):
    with dispatch.timed("rx.decode"):
        dec, m = vc.acs(llr)
        bits = vc.traceback(dec, m)
        mach = node._machines[key]
        mach.run([args])
    return vc.acs_plain(llr), bits   # the plain version launches nothing
'''

R6_TP = '''
from ziria_tpu_torch.utils.dispatch import pow2_bucket

def stream(x, framebatch):
    r = framebatch.StreamReceiver(chunk_len=8192, frame_len=1 << 11)
    return r, pow2_bucket(len(x), 512)
'''

R6_NEGATIVE = '''
from ziria_tpu_torch.utils import geometry
from ziria_tpu_torch.utils.dispatch import pow2_bucket

def stream(x, framebatch, geo=geometry.Geometry()):
    r = framebatch.StreamReceiver(chunk_len=geo.chunk_len)
    return r, pow2_bucket(len(x), geo.min_bucket)
'''


def test_the_port_is_lint_clean():
    """The gate: zero findings over ziria_tpu_torch/, this slice's
    modules included; every suppression is a pragma with a reason."""
    res = lint_paths([PKG])
    assert res.files > 70
    rendered = "\n".join(f.render() for f in res.findings)
    assert not res.findings, (
        f"lint found {len(res.findings)} finding(s): fix them or add a "
        f"lint-ignore pragma whose reason is true:\n{rendered}")
    assert res.counts == {}


def test_r4_r5_and_the_engine_equal_the_references():
    """The reference's own R4/R5 fixtures, and its pragma cases: the
    same findings, in the same place, in the same words."""
    pragmas = [
        R4_TP_SCATTERED.replace(
            'os.environ.get("ZIRIA_STREAMING_RX") == "0":',
            'os.environ.get("ZIRIA_STREAMING_RX") == "0":  '
            '# ziria: lint-ignore[R4] fixture justification'),
        R4_TP_SCATTERED.replace('== "0":', '== "0":  # ziria: '
                                'lint-ignore[R4]'),
        '"""Suppress with `# ziria: lint-ignore-file[R4] reason`."""\n'
        + R4_TP_SCATTERED,
        "# ziria: lint-ignore-file[R4] fixture justification\n"
        + R4_TP_SCATTERED + R4_TP_WRITE.replace("import os\n", ""),
        "import os\n# ziria: lint-ignore[R4] justified once, fixed\n"
        "def env_window():\n    return os.environ.get('ZIRIA_WINDOW')\n",
        "def broken(:\n",
    ]
    cases = [(src, "R4") for src in (R4_TP_IMPORT_TIME, R4_TP_SCATTERED,
                                     R4_TP_WRITE, R4_NEGATIVE)]
    cases += [(src, "R5") for src in (R5_TP_ANNOTATION, R5_TP_NESTED,
                                      R5_TP_CALLSITE, R5_NEGATIVE)]
    cases += [(src, "R4") for src in pragmas]
    n_found = 0
    for src, rule in cases:
        got = lint_source(src, "f.py", rules=[RULES_BY_ID[rule]])
        want = jax_lint_source(src, "f.py", rules=[JAX_RULES[rule]])
        assert [tuple(vars(f).values()) for f in got.findings] == \
            [tuple(vars(f).values()) for f in want.findings], src
        assert got.suppressed == want.suppressed
        n_found += len(got.findings)
    assert n_found >= 8


def test_r2_r3_r6_retargeted_fixtures():
    f = _findings(R2_TP, rules=["R2"])
    assert _rules_of(f) == ["R2"] and len(f) == 3
    assert {m for x in f for m in ("'int'", "'.cpu()'",
                                   "'torch.cuda.synchronize()'")
            if m in x.message} == {"'int'", "'.cpu()'",
                                   "'torch.cuda.synchronize()'"}
    assert _findings(R2_NEGATIVE, rules=["R2"]) == []
    f = _findings(R3_TP, rules=["R3"])
    assert [x.line for x in f] == [6, 7, 8, 9]
    assert "chunk-machine step" in f[2].message
    assert _findings(R3_NEGATIVE, rules=["R3"]) == []
    # the wrappers' own module defines them; it launches nothing itself
    assert _findings(R3_TP, rules=["R3"],
                     path="ops/viterbi_cuda.py") == []
    f = _findings(R6_TP, rules=["R6"])
    assert len(f) == 3 and _rules_of(f) == ["R6"]
    assert _findings(R6_NEGATIVE, rules=["R6"]) == []
    assert _findings(R6_TP, rules=["R6"], path="utils/geometry.py") == []


def test_cli_exit_codes_json_and_rules(tmp_path, capsys):
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "ok.py").write_text(R4_NEGATIVE + R2_NEGATIVE)
    assert lint_main([str(clean)]) == 0
    for i, tp in enumerate([R2_TP, R3_TP, R4_TP_SCATTERED,
                            R5_TP_ANNOTATION, R6_TP]):
        d = tmp_path / f"tp{i}"
        d.mkdir()
        (d / "bad.py").write_text(tp)
        assert lint_main([str(d)]) == 1, f"fixture {i} must fail"
    capsys.readouterr()
    assert lint_main(["--json", str(tmp_path / "tp1")]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["version"] == 1 and doc["counts"] == {"R3": 4}
    assert set(doc["findings"][0]) == {"file", "line", "col", "rule",
                                       "message"}
    assert lint_main(["--rules", "R9", str(clean)]) == 2
    assert lint_main(["--rules", "R1", str(clean)]) == 2
    assert "no counterpart" in capsys.readouterr().err
    assert lint_main([str(tmp_path / "nope")]) == 2
    assert lint_main(["--rules", "R2,R3", str(clean)]) == 0
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert "R1" in out and "not run" in out and set(NOT_RUN) == {"R1"}
    for rid in ("R2", "R3", "R4", "R5", "R6"):
        assert rid in out


def test_the_subcommand_runs_without_torch():
    """`python -m ziria_tpu_torch lint PATH` exits 0 on a clean tree and
    never imports torch (the gate above lints the whole package)."""
    code = ("import runpy, sys\n"
            "sys.argv = ['ziria_tpu_torch', 'lint', "
            "'ziria_tpu_torch/analysis']\n"
            "try:\n"
            "    runpy.run_module('ziria_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "assert 'torch' not in sys.modules, 'lint imported torch'\n"
            "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "0 finding(s)" in proc.stderr
