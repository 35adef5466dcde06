"""The port's threefry generator (aha_tpu_torch/models/jax_random.py) against
jax.random on the CPU (jax_threefry_partitionable=True, jax's default):
keys, splits, random bits and randint bit-equal; uniform bit-equal; normal
within 3 f32 ulps (torch's log1p is not XLA's), one bf16 step after the
synthetic weights' * 0.02 and cast; any slab equal to the same range of the
whole draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng

from aha_tpu_torch.models import jax_random as jr

SHAPES = [(7,), (3, 5, 11), (1000, 37), (2, 129, 3)]


def _words(a) -> np.ndarray:
    return np.asarray(a).view(np.int32).ravel()


@pytest.fixture(autouse=True)
def _partitionable():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1, 2**32 + 5])
def test_prng_key_and_split_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(w) for w in np.asarray(key)) == jr.prng_key(seed)
    for num in (2, 3, 16):
        ref = [tuple(int(w) for w in row) for row in np.asarray(jax.random.split(key, num))]
        assert jr.split(jr.prng_key(seed), num) == ref


def test_threefry_carries_at_the_top_of_the_range():
    """Counter and key words at and near 2^32 - 1 and 2^31: every add wraps
    as uint32 does."""
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1], np.uint32)
    c0, c1 = np.meshgrid(edge, edge)
    for key in ((0, 0), (2**32 - 1, 2**32 - 1), (2**31, 1), (0x1BD11BDA, 0xFFFFFFFF)):
        ref = prng.threefry2x32_p.bind(jnp.uint32(key[0]), jnp.uint32(key[1]),
                                       jnp.asarray(c0.ravel()), jnp.asarray(c1.ravel()))
        got = jr.threefry_2x32(key, torch.from_numpy(c0.ravel().view(np.int32)),
                               torch.from_numpy(c1.ravel().view(np.int32)))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_words(r), g.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits_bit_equal(shape):
    for seed in (3, 40):
        ref = _words(jax.random.bits(jax.random.PRNGKey(seed), shape, jnp.uint32))
        np.testing.assert_array_equal(jr.random_bits(jr.prng_key(seed), shape).numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo, hi", [(-127, 128), (0, 256), (0, 1 << 20), (-5, 6)])
def test_randint_bit_equal(shape, lo, hi):
    """The int8 and packed-nibble ranges of the synthetic weights, and a span
    whose product with its multiplier wraps 32 bits."""
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax.random.randint(key, shape, lo, hi, jnp.int32)).ravel()
    got = jr.randint(jr.prng_key(11), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_uniform_bit_equal():
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    ref = np.asarray(jax.random.uniform(jax.random.PRNGKey(2), (50_000,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(jr.uniform(jr.prng_key(2), (50_000,), lo, 1.0).numpy(), ref)


def test_normal_within_three_ulps_and_one_bf16_step():
    """erfinv is XLA's polynomial with fused multiply-adds; log1p is torch's,
    which is not XLA's: measured up to 3 f32 ulps on about 1% of the values,
    and after the weights' 0.02 * and a bf16 cast at most one bf16 step (on
    about one value in a million)."""
    shape = (1_000_000,)
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(9), shape))
    got = jr.normal(jr.prng_key(9), shape).numpy()
    ulps = np.abs(got - ref) / np.spacing(np.abs(ref))
    assert ulps.max() <= 3 and (ulps > 0).mean() < 0.02
    rb = torch.from_numpy(np.float32(0.02) * ref).bfloat16().float()
    gb = torch.from_numpy(np.float32(0.02) * got).bfloat16().float()
    step = torch.from_numpy(np.spacing(np.abs(rb.numpy()))) * 2**16   # bf16 spacing
    assert ((gb - rb).abs() <= step).all()
    assert (gb != rb).sum() <= 5


@pytest.mark.parametrize("kind", ["bits", "randint", "normal"])
def test_slabs_equal_the_whole_draw(kind):
    shape, key = (13, 7, 29), jr.prng_key(21)
    draw = {"bits": lambda a, b: jr.random_bits(key, shape, a, b),
            "randint": lambda a, b: jr.randint(key, shape, -127, 128, a, b),
            "normal": lambda a, b: jr.normal(key, shape, a, b)}[kind]
    whole = draw(0, None)
    n = whole.numel()
    for a, b in ((0, 1), (0, n), (5, 400), (n - 3, n), (1000, 1000)):
        assert torch.equal(draw(a, b), whole[a:b])
    torch.testing.assert_close(torch.cat([draw(a, min(a + 100, n)) for a in range(0, n, 100)]),
                               whole, rtol=0, atol=0)
    with pytest.raises(ValueError, match="slab"):
        draw(0, n + 1)
