"""The port's sliding-window decode (ops/viterbi_cuda
``viterbi_decode_batch_windowed``) against the JAX package's, on the CPU.

The windowing math (window starts, zero erasures outside the frame, the
kept spans, the fall-through of short frames, quantizing each frame
before the windows are cut) is held with the decode injected through
``_decode`` on both sides, as tools/windowed_ber.py injects it in the
reference: the port's scan decoders and the reference's, which are held
bitwise equal in test_torch_viterbi.py and test_torch_quantized.py. That
is cheap, so random (T, window, overlap) values are fuzzed, including a
window shorter than its overlap, ragged tails and T <= window + 2 *
overlap. One small case runs the whole windowed decode, the Pallas
kernels in interpret mode on the reference side. Tolerance is bitwise.
"""

import jax
import numpy as np
import torch

from test_torch_fleet import one_thread  # noqa: F401 - autouse fixture
from ziria_tpu.ops import coding as jcoding, viterbi as jviterbi, \
    viterbi_pallas as jvp
from ziria_tpu_torch.ops import viterbi, viterbi_cuda as vc

# (T, window, overlap): window < overlap, ragged and whole tails,
# T <= ext, T just past ext
CASES = [(200, 24, 40), (137, 32, 8), (128, 32, 16), (60, 32, 16),
         (64, 32, 16), (65, 32, 16), (301, 50, 12), (97, 16, 3)]

_ENGINES = {
    "float32": (viterbi.viterbi_decode, jviterbi.viterbi_decode),
    "int16": (viterbi.viterbi_decode_int16, jviterbi.viterbi_decode_int16),
    "int8": (viterbi.viterbi_decode_int8, jviterbi.viterbi_decode_int8),
}


def _llrs(seed, b, n, noise=0.8):
    """Noisy soft pairs of zero-tailed coded random messages (so the
    survivors merge, as in a real decode), lane 0's last third
    erased."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, n, 2), np.float32)
    for k in range(b):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        bits[-6:] = 0
        coded = jcoding.np_conv_encode_ref(bits).astype(np.float32)
        out[k] = (2 * coded - 1 + rng.normal(0, noise, coded.size)
                  ).reshape(n, 2)
    out[0, 2 * n // 3:] = 0.0
    return out


def _both(x, md, window, overlap):
    port_scan, ref_scan = _ENGINES[md]
    ref_engine = jax.jit(jax.vmap(ref_scan))
    got = vc.viterbi_decode_batch_windowed(
        torch.from_numpy(x), window=window, overlap=overlap,
        metric_dtype=md, _decode=port_scan)
    want = jvp.viterbi_decode_batch_windowed(
        x, window=window, overlap=overlap, metric_dtype=md,
        _decode=ref_engine)
    return got.numpy(), np.asarray(want)


def test_windowing_math_equals_reference():
    rng = np.random.default_rng(0)
    cases = CASES + [(int(rng.integers(40, 320)), int(rng.integers(8, 64)),
                      int(rng.integers(1, 40))) for _ in range(4)]
    for k, (n, window, overlap) in enumerate(cases):
        x = _llrs(k, 3, n)
        got, want = _both(x, "float32", window, overlap)
        assert got.shape == want.shape == (3, n), (n, window, overlap)
        np.testing.assert_array_equal(got, want, err_msg=str(
            (n, window, overlap)))


def test_windowing_math_equals_reference_quantized():
    """int16 and int8: each frame is quantized before the windows are
    cut, so the windows slice the full decode's integers."""
    for k, (n, window, overlap) in enumerate(CASES[:5]):
        x = _llrs(10 + k, 2, n) * 7.0
        for md in ("int16", "int8"):
            got, want = _both(x, md, window, overlap)
            np.testing.assert_array_equal(got, want, err_msg=str(
                (md, n, window, overlap)))


def test_windowed_decode_equals_reference_pallas():
    x = _llrs(7, 2, 300)
    for md, radix in (("float32", 2), ("int16", 4)):
        want = np.asarray(jvp.viterbi_decode_batch_windowed(
            x, n_bits=290, window=64, overlap=16, interpret=True,
            metric_dtype=md, radix=radix))
        got = vc.viterbi_decode_batch_windowed(
            torch.from_numpy(x), n_bits=290, window=64, overlap=16,
            metric_dtype=md, radix=radix)
        np.testing.assert_array_equal(got.numpy(), want)


def test_mode_dispatch_and_short_frames():
    """``viterbi_decode_batch_opt`` runs the exact decode for window
    None or 0 and the windowed one otherwise; a frame no longer than
    window + 2 * overlap takes the exact decode; windows cut at clean
    inputs decode like the whole frame."""
    x = torch.from_numpy(_llrs(3, 3, 300, noise=0.3))
    exact = vc.viterbi_decode_batch(x)
    for window in (None, 0):
        assert torch.equal(vc.viterbi_decode_batch_opt(x, window=window),
                           exact)
    assert torch.equal(vc.viterbi_decode_batch_opt(x, window=300), exact)
    assert torch.equal(
        vc.viterbi_decode_batch_opt(x, n_bits=250, window=100),
        exact[:, :250])
    got = vc.viterbi_decode_batch_opt(x.reshape(3, -1), window=64,
                                      metric_dtype="int8", radix=4)
    assert torch.equal(got, vc.viterbi_decode_batch(x, metric_dtype="int8"))
