"""``ext fun viterbi_soft`` in the port against the reference's (CPU).

A host value (numpy) decodes with the port's scan decoder on a CPU
tensor; its bits must equal the reference's host path (the native C
brick when built, else ``np_viterbi_decode``). A tensor decodes on its
device: by default the scan decoder, equal to the reference's traced
scan; under ``ZIRIA_VITERBI_WINDOW`` a frame longer than the window and
both overlaps goes through ``viterbi_cuda.viterbi_decode_batch_windowed``
with the arguments the reference passes to its windowed Pallas decode
(``tests/test_torch_windowed.py`` holds that function to the
reference's), while a shorter one keeps the scan decoder.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.frontend.externals import EXTERNALS as JAX_EXTERNALS
from ziria_tpu_torch.frontend import externals
from ziria_tpu_torch.ops import viterbi_cuda


def _frame(rng, npairs, snr_scale, size):
    """A `size`-double soft buffer: npairs noisy +-1 pairs (with punctured
    zeros and exact ties) in front, zeros after."""
    x = np.zeros(size, np.float32)
    body = (2.0 * rng.integers(0, 2, 2 * npairs) - 1.0
            + snr_scale * rng.standard_normal(2 * npairs))
    body[rng.random(2 * npairs) < 0.15] = 0.0
    x[: 2 * npairs] = body.astype(np.float32)
    return x


@pytest.mark.parametrize("npairs,nbits,size", [(24, 24, 64), (300, 300, 1024),
                                               (2000, 1990, 8192)])
def test_host_path_equals_the_references(npairs, nbits, size, monkeypatch):
    monkeypatch.delenv("ZIRIA_VITERBI_WINDOW", raising=False)
    rng = np.random.default_rng(npairs)
    for scale in (0.3, 0.9, 1.6):
        x = _frame(rng, npairs, scale, size)
        got = externals.EXTERNALS["viterbi_soft"](x, np.int32(npairs),
                                                  np.int32(nbits))
        want = JAX_EXTERNALS["viterbi_soft"](x, np.int32(npairs),
                                             np.int32(nbits))
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, np.asarray(want))


def test_device_path_default_is_the_references_traced_scan(monkeypatch):
    monkeypatch.delenv("ZIRIA_VITERBI_WINDOW", raising=False)
    rng = np.random.default_rng(7)
    npairs, nbits, size = 600, 590, 2048
    x = _frame(rng, npairs, 1.0, size)
    got = externals.EXTERNALS["viterbi_soft"](torch.from_numpy(x), npairs,
                                              nbits)
    want = jax.jit(lambda v: JAX_EXTERNALS["viterbi_soft"](v, npairs,
                                                           nbits))(x)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and the host path's bits
    np.testing.assert_array_equal(
        got.numpy(), externals.EXTERNALS["viterbi_soft"](x, npairs, nbits))


def test_windowed_device_path_passes_the_references_arguments(monkeypatch):
    calls = []
    real = viterbi_cuda.viterbi_decode_batch_windowed

    def spy(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    monkeypatch.setattr(viterbi_cuda, "viterbi_decode_batch_windowed", spy)
    monkeypatch.setenv("ZIRIA_VITERBI_WINDOW", "256")
    monkeypatch.setenv("ZIRIA_VITERBI_METRIC", "int16")
    monkeypatch.setenv("ZIRIA_VITERBI_RADIX", "4")
    rng = np.random.default_rng(9)
    npairs, nbits, size = 1500, 1490, 4096
    x = torch.from_numpy(_frame(rng, npairs, 0.5, size))
    externals.VITERBI_CALLS.update(scan=0, windowed=0, host=0)
    got = externals.EXTERNALS["viterbi_soft"](x, npairs, nbits)
    (args, kw), = calls
    assert len(args) == 1 and torch.equal(args[0], x[None, : 2 * npairs])
    assert kw == {"n_bits": nbits, "window": 256, "metric_dtype": "int16",
                  "radix": 4}
    want = real(x[None, : 2 * npairs], n_bits=nbits, window=256,
                metric_dtype="int16", radix=4)[0]
    assert got.shape == (size // 2,)
    assert torch.equal(got[:nbits], want) and not got[nbits:].any()
    # a frame within window + 2 * overlap keeps the scan decoder
    short = 256 + 2 * viterbi_cuda.DEFAULT_WINDOW_OVERLAP
    externals.EXTERNALS["viterbi_soft"](x, short, short)
    assert len(calls) == 1
    assert externals.VITERBI_CALLS == {"scan": 1, "windowed": 1, "host": 0}
