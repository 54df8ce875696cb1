"""The reference's pipeline fuzzer (tests/test_fuzz.py) held across
packages: its 24 seeded combinator programs, drawn by the reference's
own ``_rand_pipeline`` (the oracle's program) and as stage specs by
``ziria_tpu_torch.tools.fuzz`` with the same draws (the port's program,
built with torch lambdas), run through every port executor the
reference case runs: the interpreter, ``run_jit``, ``run_jit`` after
``fold``, ``stream_parallel`` over 8 virtual CPU entries and, with two
or more stages, ``auto_pipeline`` + ``lower_stage_parallel`` over 2.
The reference's interpreter (numpy) is the oracle: the port's
interpreter equals it exactly, ``run_jit`` is a prefix of it (the jit
tail policy drops sub-iteration remainders) and the other executors
equal ``run_jit`` (the stage pipeline on its exact-macro-chunk prefix).
Failures print the seed and the program."""

import numpy as np
import pytest

from test_fuzz import N_CASES, _rand_pipeline
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.core import ir as jir
from ziria_tpu.interp.interp import run as jrun
from ziria_tpu_torch.tools import fuzz


def oracle(comp, xs):
    """The reference interpreter's (outputs, terminated_by)."""
    r = jrun(comp, list(xs))
    return np.asarray(r.out_array()), r.terminated_by


def check(family, seed, outs, want, program):
    bad = fuzz.mismatches(family, outs, want)
    assert not bad, f"{family} seed {seed}: {bad}\n{program}"


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_executors_equal_reference_interpreter(seed):
    assert fuzz.CASES["pipeline"] == N_CASES
    ref_comp, ref_xs = _rand_pipeline(seed)
    specs, xs = fuzz.pipeline_case(seed)
    np.testing.assert_array_equal(xs, ref_xs)
    assert [s["name"] for s in specs] == \
        [s.label() for s in jir.pipeline_stages(ref_comp)], seed
    outs = fuzz.run_case("pipeline", (specs, xs), device="cpu")
    check("pipeline", seed, outs, oracle(ref_comp, xs), specs)
