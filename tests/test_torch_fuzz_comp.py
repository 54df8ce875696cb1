"""The reference's computation-level fuzzer (tests/test_fuzz_comp.py)
held across packages: its 16 seeded ``repeat`` bodies (take, takes,
emit, do and static for over stream-level state), whose source
``ziria_tpu_torch.tools.fuzz`` generates as the reference's
``_gen_program`` does (the text asserted equal for every seed), through
the port's interpreter and ``run_jit``. Each equals the reference's
interpreter exactly (whole iterations only). Failures print the seed
and the source."""

import numpy as np
import pytest

from test_fuzz_comp import N_CASES, _gen_program
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_fuzz import check
from ziria_tpu.frontend import compile_source as jcompile
from ziria_tpu.interp.interp import run as jrun
from ziria_tpu_torch.tools import fuzz


def zir_oracle(src, xs):
    """The reference interpreter's (outputs, terminated_by) of a .zir
    program."""
    r = jrun(jcompile(src).comp, list(xs))
    return np.asarray(r.out_array()), r.terminated_by


def same_case(got, want):
    """A generated (src, inputs) pair equal to the reference's."""
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert np.asarray(got[1]).dtype == np.asarray(want[1]).dtype


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_comp_equals_reference_interpreter(seed):
    assert fuzz.CASES["comp"] == N_CASES
    src, xs = fuzz.comp_case(seed)
    same_case((src, xs), _gen_program(seed))
    outs = fuzz.run_case("comp", (src, xs), device="cpu")
    check("comp", seed, outs, zir_oracle(src, xs), src)
