"""The port's compiler against the committed golden files, on the CPU.

Every case of ``examples/make_golden.py`` (28 of them) runs through the
port's CLI (``python -m ziria_tpu_torch``'s ``main``, ``--platform=cpu``)
on the backend ``tests/test_golden.py`` gives it, with its flags
(``--fxp-complex16`` for the fixed-point cases, ``--autolut`` for the
AutoLUT ones), and its output must equal the committed
``.outfile.ground`` -- the reference oracle's own output -- under the
comparator and tolerances of ``tests/test_golden.py``. No JAX runs in
those cases. ``chip_smoke.py`` runs the same cases on the card from its
``COMPILER_CASES``, held to the generator's table below. One test holds
the port's AutoLUT tables to the JAX package's ``build_table``.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import chip_smoke
from ziria_tpu_torch.frontend import compile_file
from ziria_tpu_torch.runtime.buffers import StreamSpec, read_stream
from ziria_tpu_torch.runtime.cli import LAST_RUN, main as cli_main
from ziria_tpu_torch.utils.diff import stream_diff

HERE = os.path.dirname(__file__)
EXAMPLES = os.path.abspath(os.path.join(HERE, "..", "examples"))
GOLD = os.path.join(EXAMPLES, "golden")


def _generator_cases():
    """The (name, mode) table and case sets come from the generator, as
    tests/test_golden.py reads them."""
    spec = importlib.util.spec_from_file_location(
        "make_golden", os.path.join(EXAMPLES, "make_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return ([(name, mode) for name, _ty, _mk, mode in mod.CASES],
            mod.FXP_CASES, mod.INTERP_CASES, mod.AUTOLUT_CASES,
            mod.HYBRID_CASES)


_MODES, _FXP, _INTERP, _AUTOLUT, _HYBRID = _generator_cases()

# tests/test_golden.py's tolerances: quantized complex streams atol=1,
# float LLR outputs 1e-4, everything else exact
_ATOL = {"fft64": 1.0, "qam16": 1.0, "pilot_track": 1.0,
         "wifi_tx_full": 1.0,
         "demap_bpsk": 1e-4, "demap_qpsk": 1e-4,
         "demap_qam16": 1e-4, "demap_qam64": 1e-4}

CASES = [(name, mode,
          "interp" if name in _INTERP else
          "hybrid" if name in _HYBRID else "jit",
          _ATOL.get(name, 0.0),
          (("--fxp-complex16",) if name in _FXP else ())
          + (("--autolut",) if name in _AUTOLUT else ()))
         for name, mode in _MODES]


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread, as tests/test_torch_fleet.py does: the suite
    runs on several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_case_table_is_the_generators_and_chip_smokes():
    assert len(CASES) == 28
    assert tuple(CASES) == chip_smoke.COMPILER_CASES
    assert sum(b == "jit" for _n, _m, b, _a, _f in CASES) == 22
    assert sum("--fxp-complex16" in f for *_x, f in CASES) == 4
    assert sum("--autolut" in f for *_x, f in CASES) == 2


@pytest.mark.parametrize("name,mode,backend,atol,flags", CASES)
def test_golden_case_on_the_port(name, mode, backend, atol, flags,
                                 tmp_path):
    src = os.path.join(EXAMPLES, f"{name}.zir")
    infile = os.path.join(GOLD, f"{name}.infile")
    ground = os.path.join(GOLD, f"{name}.outfile.ground")
    outf = tmp_path / f"{name}.out"
    rc = cli_main([
        f"--src={src}", "--input=file", f"--input-file-name={infile}",
        f"--input-file-mode={mode}", "--output=file",
        f"--output-file-name={outf}", f"--output-file-mode={mode}",
        f"--backend={backend}", "--platform=cpu", *flags])
    assert rc == 0
    # the backend asked for is the one that ran (no jit -> hybrid step)
    assert LAST_RUN["backend"] == backend
    prog = compile_file(src, fxp_complex16="--fxp-complex16" in flags)
    got = read_stream(StreamSpec(ty=prog.out_ty, path=str(outf),
                                 mode=mode))
    want = read_stream(StreamSpec(ty=prog.out_ty, path=ground, mode=mode))
    if atol:
        rep = stream_diff(got.astype(np.float64), want.astype(np.float64),
                          atol=atol, name=name)
    else:
        rep = stream_diff(got, want, name=name)
    assert rep, rep.message
    if backend == "hybrid":
        # the flagship's heavy blocks ran as device blocks
        assert LAST_RUN["blocks_device"] > 0


def _maps(comp, ir):
    """Every Map node of a core-IR program, in walk order."""
    found = []

    def walk(c):
        if isinstance(c, ir.Map):
            found.append(c)
        return ir.map_children(c, lambda ch, _b: walk(ch))
    walk(comp)
    return found


@pytest.mark.parametrize("name", sorted(_AUTOLUT))
def test_autolut_tables_equal_the_references(name):
    """The tables the port's AutoLUT builds for the AutoLUT golden
    programs (a declared-domain map through core/autolut.build_table, an
    inferred packed-bits map through its lutinfer adapter) equal the
    JAX package's, value and dtype."""
    import jax  # noqa: F401  (the reference, on the CPU)
    from ziria_tpu.core import autolut as ref_autolut, ir as ref_ir
    from ziria_tpu.frontend import compile_file as ref_compile

    from ziria_tpu_torch.core import autolut, ir

    src = os.path.join(EXAMPLES, f"{name}.zir")
    ours = _maps(compile_file(src, autolut=True).comp, ir)
    refs = _maps(ref_compile(src, autolut=True).comp, ref_ir)
    assert [m.label() for m in ours] == [m.label() for m in refs]
    built = 0
    for m, r in zip(ours, refs):
        assert (m.in_domain, m.lut is None) == (r.in_domain, r.lut is None)
        if m.lut is not None:
            got, want = m.lut.build_table(), r.lut.build_table()
        elif m.in_domain is not None:
            got, want = autolut.build_table(m), ref_autolut.build_table(r)
        else:
            continue
        want = np.asarray(want)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)
        built += 1
    assert built >= 1
