"""The reference's fuzzer of the parallel seams (tests/test_fuzz_parallel
.py) held across packages: its 24 stream-split (sp), 16 stage-pipeline
(pp), 8 batched-stream (dp x sp), 24 chunk-machine and 10 frame-batch
cases at its seeds. The combinator programs are drawn by the
reference's own ``_gen_stage``/``_gen_pipeline`` with the harness's
draws (the oracle's program) and as stage specs by
``ziria_tpu_torch.tools.fuzz`` with the same draws (the port's program,
torch lambdas; the inputs asserted equal); the ``.zir`` sources are
asserted equal to ``_gen_chunk_program``'s. The port's executors run
on the CPU over its 8 virtual entries: ``stream_parallel`` (8 sp
entries), ``lower_stage_parallel`` (K pp entries, its carry handed to
``run_jit_carry`` for the ragged tail), ``stream_parallel_batched`` on
a (dp 2, sp 4) grid, ``hybridize`` (the chunk machines) and ``run_many``
with a ``StepBatcher``. The reference's interpreter is the oracle: the
port's interpreter and chunk-machine executors equal it exactly,
``terminated_by`` too; ``run_jit`` is a prefix of it and the sharded
executors equal ``run_jit``. Failures print the seed and the
program."""

import numpy as np
import pytest

import ziria_tpu as jz
from test_fuzz_parallel import (N_CHUNK, N_DPSP, N_FRAMEBATCH, N_PP, N_SP,
                                _gen_chunk_program, _gen_pipeline,
                                _gen_stage)
from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from test_torch_fuzz import check, oracle
from test_torch_fuzz_comp import same_case, zir_oracle
from ziria_tpu.core import ir as jir
from ziria_tpu_torch.tools import fuzz


def labels(comp):
    return [s.label() for s in jir.pipeline_stages(comp)]


@pytest.mark.parametrize("seed", range(N_SP))
def test_fuzz_sp_equals_reference_interpreter(seed):
    assert (N_SP, N_PP, N_DPSP, N_CHUNK, N_FRAMEBATCH) == tuple(
        fuzz.CASES[f] for f in ("sp", "pp", "dpsp", "chunked",
                                "framebatch"))
    rng = np.random.default_rng(1000 + seed)
    prog = _gen_pipeline(rng, int(rng.integers(1, 4)), fuzz.SP_POOL)
    n = int(rng.integers(50, 3000))
    ref_xs = rng.integers(-1000, 1000, size=n).astype(np.int32)
    specs, xs = fuzz.sp_case(seed)
    np.testing.assert_array_equal(xs, ref_xs)
    assert [s["name"] for s in specs] == labels(prog), seed
    outs = fuzz.run_case("sp", (specs, xs), device="cpu")
    check("sp", seed, outs, oracle(prog, xs), specs)


@pytest.mark.parametrize("seed", range(N_PP))
def test_fuzz_pp_equals_reference_interpreter(seed):
    case = fuzz.case_of("pp", seed, device="cpu")
    specs, width, M, r, xs = case
    rng = np.random.default_rng(2000 + seed)
    K = int(rng.choice([2, 4]))
    segs = [_gen_stage(rng, fuzz.SP_POOL) for _ in range(K)]
    assert int(rng.choice([1, 3])) == width
    take = (xs.shape[0] - r) // M
    assert (M, r) == (int(rng.integers(1, 7)), int(rng.integers(0, take)))
    np.testing.assert_array_equal(
        xs, rng.integers(-1000, 1000, size=M * take + r).astype(np.int32))
    seq = jz.pipe(*segs)
    assert [s["name"] for s in specs] == labels(seq), seed
    outs = fuzz.run_case("pp", case, device="cpu")
    check("pp", seed, outs, oracle(seq, xs),
          f"{specs} take={take} M={M} r={r}")


@pytest.mark.parametrize("seed", range(N_DPSP))
def test_fuzz_dp_x_sp_equals_reference_interpreter(seed):
    rng = np.random.default_rng(3000 + seed)
    prog = _gen_pipeline(rng, int(rng.integers(1, 4)), fuzz.DPSP_POOL)
    specs, width, batch = fuzz.dpsp_case(seed)
    assert int(rng.choice([4, 16])) == width
    B = int(rng.choice([2, 4]))
    N = 4 * width * int(rng.integers(1, 5))
    if rng.random() < 0.5:
        N += int(rng.integers(1, 4 * width))
    np.testing.assert_array_equal(
        batch, rng.integers(-1000, 1000, size=(B, N)).astype(np.int32))
    assert [s["name"] for s in specs] == labels(prog), seed
    outs = fuzz.run_case("dpsp", (specs, width, batch), device="cpu")
    check("dpsp", seed, outs, [oracle(prog, f) for f in batch],
          f"{specs} width={width}")


@pytest.mark.parametrize("seed", range(N_CHUNK))
def test_fuzz_chunked_loops_equal_reference_interpreter(seed):
    src, xs = fuzz.chunked_case(seed)
    same_case((src, xs), _gen_chunk_program(np.random.default_rng(
        4000 + seed)))
    outs = fuzz.run_case("chunked", (src, xs), device="cpu")
    check("chunked", seed, outs, zir_oracle(src, xs), src)


@pytest.mark.parametrize("seed", range(N_FRAMEBATCH))
def test_fuzz_framebatch_equals_reference_interpreter(seed):
    src, frames = fuzz.framebatch_case(seed)
    rng = np.random.default_rng(6000 + seed)
    assert _gen_chunk_program(rng)[0] == src
    n_frames = int(rng.integers(2, 7))
    assert len(frames) == n_frames
    for f in frames:
        np.testing.assert_array_equal(
            f, rng.integers(-500, 500, size=int(rng.integers(30, 400)))
            .astype(np.int32))
    outs = fuzz.run_case("framebatch", (src, frames), device="cpu")
    check("framebatch", seed, outs, [zir_oracle(src, f) for f in frames],
          src)
