"""The part of ``jax.random`` that JAX's synthetic weights are drawn with,
on integer tensors of any device.

Counterpart of ``jax/_src/prng.py`` (threefry2x32 under
``jax_threefry_partitionable=True``, the default since jax 0.5) and of
``jax/_src/random.py``'s ``_randint``, ``_uniform`` and ``_normal_real``:

  * a key is a pair of 32-bit words, ``prng_key(n) = (0, n & 0xffffffff)``;
  * ``split(key, n)``: key i is the threefry hash of the counter pair (0, i);
  * the 32 random bits of element i (row-major flat index) of a draw are the
    xor of the two words of the hash of (i >> 32, i & 0xffffffff). So any flat
    range (a *slab*) of a leaf is drawn alone, bit-equal to the same range of
    the whole draw, and a leaf of 1.9e9 values never needs all its counters in
    memory at once;
  * ``randint``: two draws from ``split(key)``, combined in unsigned 32-bit
    arithmetic exactly as JAX does (bit-equal);
  * ``normal``: the uniform mantissa trick on (nextafter(-1, 0), 1), then
    ``sqrt(2) * erfinv(u)`` in f32, erfinv as XLA's polynomial (Giles,
    "Approximating the erfinv function") with fused multiply-adds. torch's
    ``log1p`` (here in f64) is not XLA's, so a normal value may differ from
    XLA:CPU's by up to three f32 ulps (about one in a hundred does; with
    ``torch.erfinv``, 91);
    after ``* 0.02`` and a bf16 cast, at most one bf16 step on rare values.

torch has no usable uint32 arithmetic, so the words live in int32 tensors:
adds wrap, and a right shift is made logical by a mask.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# the slab a leaf is drawn in when the caller does not say (values)
SLAB = 1 << 25


def _signed(w: int) -> int:
    """A 32-bit word as the int32 value with its bits."""
    w &= MASK32
    return w - (1 << 32) if w >= 1 << 31 else w


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry_2x32(key: tuple[int, int], c0: torch.Tensor, c1: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counter words (c0, c1) (int32 tensors of one
    shape) under ``key``: 20 rounds of add, rotate and xor, a key injection
    after every four (``prng.py::_threefry2x32_lowering``)."""
    k0, k1 = key[0] & MASK32, key[1] & MASK32
    ks = [k0, k1, k0 ^ k1 ^ 0x1BD11BDA]
    x0 = c0 + _signed(ks[0])
    x1 = c1 + _signed(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + _signed(ks[(i + 1) % 3])
        x1 = x1 + _signed(ks[(i + 2) % 3] + i + 1)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two words, with JAX's 64-bit mode
    off (the default): the seed is an int32, so its high word is 0."""
    return 0, seed & MASK32


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` (``_threefry_split_foldlike``)."""
    lo = torch.arange(num, dtype=torch.int64)
    w0, w1 = threefry_2x32(key, torch.zeros(num, dtype=torch.int32), _int32(lo))
    return [(int(a) & MASK32, int(b) & MASK32) for a, b in zip(w0.tolist(), w1.tolist())]


def _int32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an int64 tensor as int32 (bits kept)."""
    return (((x & MASK32) ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def _span(shape, start: int, stop: int | None) -> tuple[int, int]:
    n = math.prod(shape)
    stop = n if stop is None else stop
    if not 0 <= start <= stop <= n:
        raise ValueError(f"slab [{start}, {stop}) is not inside a draw of {n} values")
    return start, stop


def random_bits(key: tuple[int, int], shape, start: int = 0, stop: int | None = None,
                device="cpu") -> torch.Tensor:
    """The 32-bit draw of ``shape`` (``_threefry_random_bits_partitionable``),
    flat values ``start`` .. ``stop`` of it, as int32 holding the bits."""
    start, stop = _span(shape, start, stop)
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    w0, w1 = threefry_2x32(key, _int32(idx >> 32), _int32(idx))
    return w0 ^ w1


def randint(key: tuple[int, int], shape, minval: int, maxval: int, start: int = 0,
            stop: int | None = None, device="cpu") -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, jnp.int32)``, flat
    values ``start`` .. ``stop``, as int32; bit-equal."""
    if not -(1 << 31) <= minval < maxval <= (1 << 31) - 1:
        raise ValueError(f"randint: [{minval}, {maxval}) is not an int32 range")
    k_hi, k_lo = split(key)
    span = maxval - minval
    mult = (((1 << 16) % span) ** 2) % span
    hi = random_bits(k_hi, shape, start, stop, device).to(torch.int64) & MASK32
    lo = random_bits(k_lo, shape, start, stop, device).to(torch.int64) & MASK32
    # in uint32: (hi % span) * mult + lo % span < span ** 2 + span fits 32 bits
    # for the spans drawn here (JAX wraps the product; so does the mask)
    offset = (((hi % span) * mult) & MASK32) + (lo % span)
    return (minval + (offset & MASK32) % span).to(torch.int32)


def uniform(key: tuple[int, int], shape, minval: float, maxval: float, start: int = 0,
            stop: int | None = None, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` in f32: 23 random mantissa bits under exponent 0,
    minus one, scaled into [minval, maxval) and clamped below at minval. The
    scale and shift are one multiply-add rounded once, as XLA fuses them (the
    product is exact in f64)."""
    bits = random_bits(key, shape, start, stop, device)
    floats = (((bits >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    width = torch.tensor(maxval, dtype=torch.float32) - lo     # rounded in f32, as JAX
    return torch.maximum((floats.double() * width.item() + lo.item()).float(), lo.to(device))


# XLA's erfinv in f32 (Giles' single-precision polynomials): w = -log1p(-x^2),
# one polynomial in w - 2.5 below w = 5, one in sqrt(w) - 3 above
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """The inverse error function of an f32 tensor with XLA's polynomial. Each
    multiply-add of the polynomial is rounded once, as XLA's fused ones are (the
    product is exact in f64). log1p is taken in f64 and rounded to f32, so the
    card and the host give the same bits (their f32 log1p differ)."""
    w = -torch.log1p(-(x * x).double()).float()
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    f64 = dict(dtype=torch.float64, device=x.device)
    c = [torch.where(lt, torch.tensor(a, **f64), torch.tensor(b, **f64))
         for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = c[0].float()
    for ci in c[1:]:
        p = (ci.float().double() + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def normal(key: tuple[int, int], shape, start: int = 0, stop: int | None = None,
           device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in f32 (``_normal_real``), flat values
    ``start`` .. ``stop``."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, start, stop, device)
    return torch.tensor(math.sqrt(2), dtype=torch.float32).item() * erfinv(u)
