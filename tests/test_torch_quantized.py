"""The port's integer metric modes (int16 and int8: quantization, the
scan decoders, the plain integer ACS sweeps and the batch decode)
against the JAX package's, on the CPU.

The Pallas integer kernels run in interpret mode, as the JAX package's
own tests run them, and the scan decoders directly. Tolerance is
bitwise everywhere: integer arithmetic is exact, so the same quantized
inputs give the same decisions, metrics and bits. (The int8 mode's BER
envelope is the reference's statement about raw inputs against the
float32 decode; it does not loosen port-versus-reference parity.)
Inputs come from numpy seeds: noisy soft pairs with an all-erasure lane
and erasure tails, and for int8 a lane of long +-15 runs that drives
metrics onto the -128 rail.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.ops import viterbi as jviterbi, viterbi_pallas as jvp
from ziria_tpu_torch.ops import viterbi, viterbi_cuda as vc

B, T = 4, 250                  # padded to 256 steps: 4 Pallas blocks


def t(x):
    return torch.from_numpy(np.array(x))


def _llrs(seed, b=B, n=T):
    """Noisy soft pairs (b, n, 2): lane 1 all erasures, lane 2 with an
    erasure tail."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(b, n, 2)) * 3.0).astype(np.float32)
    x[1] = 0.0
    x[2, n // 2:] = 0.0
    return x


def _rail_lane(n=T):
    """Quantized int8-level pairs: long runs of +-15 (the last lane
    erasures), whose losing states sink past the -128 rail (with no
    erasure tail: erasures at the end would even the metrics out)."""
    q = np.full((B, n, 2), 15, np.int16)
    q[0, 40:150] = -15
    q[1, :, 1] = -15
    q[2, 90:] *= -1
    q[3] = 0
    return q


def test_quantize_llrs_matches_reference():
    x = _llrs(0)
    x[3, :6] = [[127.0, 2.5], [-3.5, 0.5], [-0.5, 126.5],
                [1.5, -1.5], [-127.0, 4.5], [0.0, -2.5]]
    # lane 3's peak is 127, so its scale is 1.0 and the x.5 values are
    # exact rounding ties (half to even)
    x[3, 6:] = np.clip(x[3, 6:], -100, 100)
    for qmax in (viterbi.QUANT_MAX, viterbi.INT8_QUANT_MAX):
        for arr in (x, x[3], x[0].reshape(-1), np.zeros((2, 5, 2),
                                                        np.float32)):
            q, scale = viterbi.quantize_llrs(t(arr), qmax)
            jq, jscale = jviterbi.quantize_llrs(arr, qmax)
            assert q.dtype == torch.int16 and q.shape == jq.shape
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    q, _ = viterbi.quantize_llrs(t(x[3]))
    np.testing.assert_array_equal(q[:6].numpy(),
                                  [[127, 2], [-4, 0], [0, 126],
                                   [2, -2], [-127, 4], [0, -2]])
    assert (viterbi.QUANT_MAX, viterbi.I16_MIN, viterbi.I16_MAX,
            viterbi.INT8_QUANT_MAX, viterbi.I8_MIN, viterbi.I8_MAX) == \
        (jviterbi.QUANT_MAX, jviterbi.I16_MIN, jviterbi.I16_MAX,
         jviterbi.INT8_QUANT_MAX, jviterbi.I8_MIN, jviterbi.I8_MAX)


def test_scan_decoders_match_reference():
    x = _llrs(1, n=90)
    q16, _ = jviterbi.quantize_llrs(x)
    q8, _ = jviterbi.quantize_llrs(x, jviterbi.INT8_QUANT_MAX)
    rails = _rail_lane(90)
    for port, ref, q in ((viterbi.viterbi_decode_int16,
                          jviterbi.viterbi_decode_int16, np.asarray(q16)),
                         (viterbi.viterbi_decode_int8,
                          jviterbi.viterbi_decode_int8, np.asarray(q8)),
                         (viterbi.viterbi_decode_int8,
                          jviterbi.viterbi_decode_int8, rails)):
        want = np.stack([np.asarray(jax.jit(ref)(f)) for f in q])
        np.testing.assert_array_equal(port(t(q)).numpy(), want)
        np.testing.assert_array_equal(
            port(t(q.reshape(B, -1)), n_bits=80).numpy(), want[:, :80])
    for md in ("int16", "int8", "float32", None):
        want = np.stack([np.asarray(jviterbi.viterbi_decode(
            f, n_bits=84, metric_dtype=md)) for f in x])
        got = viterbi.viterbi_decode(t(x), n_bits=84, metric_dtype=md)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def inputs():
    """The quantized inputs of each metric mode, zero-padded to 256
    steps: int16 and int8 quantizations of the same soft pairs, and the
    int8 rail lanes."""
    x = _llrs(2)
    pad = ((0, 0), (0, 256 - T), (0, 0))
    return {"int16": np.pad(np.asarray(jvp._quantize_for("int16", x)), pad),
            "int8": np.pad(np.asarray(jvp._quantize_for("int8", x)), pad),
            "rail": _rail_lane(256)}


@pytest.mark.parametrize("md", ["int16", "int8"])
def test_plain_integer_acs_matches_pallas_kernels(inputs, md):
    """Both radixes of the metric's plain sweep against the Pallas
    kernels _acs_kernel_i16 (int16, radix 2) and the instances of
    _make_acs_kernel_int_lut: decisions, int32 metrics and bits."""
    cases = [inputs[md]] + ([inputs["rail"]] if md == "int8" else [])
    for q in cases:
        tiles, _ = jvp._to_tiles(q)
        for radix in (2, 4):
            dec, met = jvp._acs_tiles(tiles, True, md, radix)
            bits = jvp._traceback_tiles(dec, met, True)
            got_dec, got_met = vc.acs_plain(t(q), metric_dtype=md,
                                            radix=radix)
            assert got_met.dtype == torch.int32
            np.testing.assert_array_equal(
                got_dec.numpy(),
                np.asarray(dec)[0, ..., :B].transpose(2, 0, 1))
            np.testing.assert_array_equal(got_met.numpy(),
                                          np.asarray(met)[0, :, :B].T)
            np.testing.assert_array_equal(
                vc.traceback_plain(got_dec, got_met).numpy(),
                np.asarray(bits)[0, :, 0, :B].T)
    if md == "int8":
        # the rail lanes really reach the int8 rail, and the rail moves
        # decisions: the int16 sweep of the same integers differs
        rail = t(inputs["rail"])
        dec, met = vc.acs_plain(rail, metric_dtype="int8")
        assert (met == viterbi.I8_MIN).any()
        dec16, _met = vc.acs_plain(rail, metric_dtype="int16")
        assert not torch.equal(dec, dec16)


def test_batch_decode_integer_modes_match_reference():
    x = _llrs(2)
    for md in ("int16", "int8"):
        for radix in (2, 4):
            want = np.asarray(jvp.viterbi_decode_batch(
                x, interpret=True, metric_dtype=md, radix=radix))
            got = vc.viterbi_decode_batch(t(x), metric_dtype=md,
                                          radix=radix)
            np.testing.assert_array_equal(got.numpy(), want)
            # (B, 2T) input, n_bits and already-quantized input
            q = vc._quantize_for(md, t(x))
            np.testing.assert_array_equal(
                vc.viterbi_decode_batch(q.reshape(B, -1), n_bits=200,
                                        metric_dtype=md,
                                        radix=radix).numpy(),
                want[:, :200])
