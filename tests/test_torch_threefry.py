"""The port's threefry (ziria_tpu_torch/utils/threefry.py) against
``jax.random``: keys, fold-in, split, bits, uniforms and randint equal
bit for bit over a grid of seeds, lanes and shapes; normals within
2 ulp (the erfinv's logarithm may round differently from XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ziria_tpu_torch.utils import threefry

SEEDS = (0, 1, 7, 20260803, 2 ** 31 - 1, 2 ** 32 - 1)
LANES = (0, 1, 5, 127, 0x6B01, 0x6B02, 2 ** 31 + 3)
SHAPES = ((), (1,), (7,), (3, 4), (33, 2))


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 units in the last place (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_partitionable_threefry_is_on():
    """The port computes the partitionable layout: a jax that turns it
    off draws other words, and this must fail loudly."""
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seeds", [SEEDS[0::3], SEEDS[1::3], SEEDS[2::3]])
def test_keys_fold_in_split_bits_bitwise(seeds):
    for seed in seeds:
        _keys_fold_in_split_bits(seed)


def _keys_fold_in_split_bits(seed):
    key = jax.random.PRNGKey(seed)
    kt = threefry.prng_key(seed)
    assert np.array_equal(_u32(key), kt.numpy())
    assert np.array_equal(_u32(jax.random.split(key, 5)),
                          threefry.split(kt, 5).numpy())
    lanes = torch.tensor(LANES)
    folded = threefry.fold_in(kt, lanes)
    for i, lane in enumerate(LANES):
        kj = jax.random.fold_in(key, lane)
        assert np.array_equal(_u32(kj), folded[i].numpy()), lane
        for shape in SHAPES:
            want = _u32(jax.random.bits(kj, shape))
            got = threefry.bits(folded[i:i + 1], shape)[0].numpy()
            assert got.shape == want.shape
            assert np.array_equal(got, want), (lane, shape)
        assert np.array_equal(np.asarray(jax.random.uniform(kj, (64,))),
                              threefry.uniform(folded[i:i + 1], (64,))[0]
                              .numpy())


def test_randint_bitwise():
    """Spans below and above 2^16 (where jax's uint32 multiplier wraps
    to zero), one, and maxval <= minval."""
    spans = (1, 2, 7, 96, 1200, 2000, 65535, 65536, 70001, 2 ** 31 - 1)
    for seed in SEEDS[:4]:
        keys = threefry.fold_in(threefry.prng_key(seed),
                                torch.arange(6))
        for i in range(6):
            kj = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            for hi in spans:
                for lo in (0, 3):
                    want = _u32(jax.random.randint(kj, (5,), lo, hi))
                    got = threefry.randint(keys[i:i + 1], (5,), lo, hi)
                    assert np.array_equal(got[0].numpy(), want), \
                        (seed, i, lo, hi)
            want = int(jax.random.randint(kj, (), 0, 1200))
            assert int(threefry.randint(keys[i:i + 1], (), 0, 1200)[0]) \
                == want
    # per-lane spans, as the burst graph draws them
    keys = threefry.fold_in(threefry.prng_key(3), torch.arange(4))
    spans_t = torch.tensor([1, 1200, 2000, 9])
    got = threefry.randint(keys, (), 0, spans_t)
    for i in range(4):
        kj = jax.random.fold_in(jax.random.PRNGKey(3), i)
        assert int(got[i]) == int(jax.random.randint(
            kj, (), 0, int(spans_t[i])))


def test_normal_within_two_ulp():
    """4 lanes x 50,000 x 2 normals: within 2 ulp everywhere, equal
    almost everywhere (the measured share of unequal values is about
    3e-5)."""
    keys = threefry.fold_in(threefry.prng_key(11), torch.arange(4))
    got = threefry.normal(keys, (50_000, 2)).numpy()
    unequal = 0
    for i in range(4):
        want = np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(11), i), (50_000, 2)))
        d = _ulps(got[i], want)
        assert d.max() <= 2, d.max()
        unequal += int((d > 0).sum())
    assert unequal <= 40, unequal
    # the erfinv alone, at the uniforms' extremes too
    u = np.concatenate([
        np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (20_000,),
                                      jnp.float32, -1.0, 1.0)),
        np.float32([0.0, 0.5, -0.5, 0.9999999, -0.99999994])])
    d = _ulps(threefry.erfinv(torch.from_numpy(u)).numpy(),
              np.asarray(jax.lax.erf_inv(jnp.asarray(u))))
    assert d.max() <= 2, d.max()


def normal_ulps_report(seed: int = 11, lanes: int = 4, n: int = 50_000):
    """Per lane: the largest ulp distance from ``jax.random.normal``, the
    value where it falls and the count of unequal values, for the port's
    ``normal`` and for ``torch.erfinv(u) * sqrt(2)`` on the same
    uniforms (why the port carries XLA's erfinv)."""
    keys = threefry.fold_in(threefry.prng_key(seed), torch.arange(lanes))
    u = threefry.uniform(keys, (n, 2), threefry._NORMAL_LO, 1.0)
    ways = {"threefry.normal": threefry.normal(keys, (n, 2)).numpy(),
            "torch.erfinv": (torch.erfinv(u) * threefry._SQRT2).numpy()}
    for i in range(lanes):
        want = np.asarray(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(seed), i), (n, 2)))
        for name, got in ways.items():
            d = _ulps(got[i], want)
            print(f"lane {i} {name}: max {d.max()} ulp at "
                  f"{want.flat[d.argmax()]}, {(d > 0).sum()} of "
                  f"{want.size} unequal")


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_threefry
    normal_ulps_report()
