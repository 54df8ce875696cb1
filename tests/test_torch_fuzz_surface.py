"""The reference's surface-language fuzzer (tests/test_fuzz_surface.py)
held across packages: its 20 seeded ``.zir`` function bodies (ifs,
small and large fors, bounded data-dependent whiles, local arrays with
dynamic indexes) run as ``map f``, its 8 bit-mixing programs (bit
operands against out-of-range constants, the C-promotion class) and
its 8 int8 programs that also run the ``--autolut`` rewrite. The
sources ``ziria_tpu_torch.tools.fuzz`` generates are asserted equal to
the reference's: to ``_gen_program`` for the 20, and for the other 16
to the (source, inputs) pairs the reference's two test functions make,
captured at their interpreter call with their compile, interpreter and
jit stubbed. The port's interpreter, ``run_jit`` and the AutoLUT
rewrite's ``run_jit`` each equal the reference's interpreter exactly.
Failures print the seed and the source."""

from types import SimpleNamespace

import numpy as np
import pytest

import test_fuzz_surface as ref
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_fuzz import check
from test_torch_fuzz_comp import same_case, zir_oracle
from ziria_tpu.core import autolut as jautolut
from ziria_tpu_torch.tools import fuzz


def reference_cases(test_fn, monkeypatch):
    """The (source, inputs) pairs reference test `test_fn` makes, in
    order, captured at its interpreter call (nothing of JAX runs)."""
    got = []

    class Stub:
        def out_array(self):
            return np.zeros(1)

    def run(src, xs):
        got.append((src, np.asarray(xs)))
        return Stub()
    monkeypatch.setattr(ref, "compile_source",
                        lambda src, **_k: SimpleNamespace(comp=src))
    monkeypatch.setattr(ref, "run", run)
    monkeypatch.setattr(ref, "run_jit", lambda comp, xs: np.zeros(1))
    monkeypatch.setattr(jautolut, "autolut", lambda comp: comp)
    test_fn()
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("seed", range(ref.N_CASES))
def test_fuzz_surface_equals_reference_interpreter(seed):
    assert fuzz.CASES["surface"] == ref.N_CASES
    src, xs = fuzz.surface_case(seed)
    same_case((src, xs), ref._gen_program(seed))
    outs = fuzz.run_case("surface", (src, xs), device="cpu")
    check("surface", seed, outs, zir_oracle(src, xs), src)


@pytest.mark.parametrize("family", ["bitmix", "int8_autolut"])
def test_fuzz_surface_bit_mixing_and_int8_autolut(family, monkeypatch):
    test_fn = {"bitmix": ref.test_fuzz_surface_bit_mixing_agreement,
               "int8_autolut": ref.test_fuzz_surface_int8_autolut_agreement
               }[family]
    want = reference_cases(test_fn, monkeypatch)
    assert len(want) == fuzz.CASES[family] == 8
    for seed, case in enumerate(want):
        src, xs = fuzz.case_of(family, seed)
        same_case((src, xs), case)
        outs = fuzz.run_case(family, (src, xs), device="cpu")
        check(family, seed, outs, zir_oracle(src, xs), src)
