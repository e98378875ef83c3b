"""JAX's counter-based random numbers (raw threefry2x32 keys) in PyTorch.

Counterpart of the ``jax.random`` functions that ``repro.data.pipeline``
draws from, under jax's defaults: the ``threefry2x32`` implementation,
``jax_threefry_partitionable`` on, 32-bit seeds and 32-bit integer and
float draws.  Every function returns what its ``jax.random`` namesake
returns, bit for bit, on every input it accepts:

* a key is an int64 tensor of shape (2,) holding the two uint32 words of
  JAX's raw key (``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``);
* ``split(key, n)`` hashes the counters (0, i) of a 64-bit iota, and
  ``random_bits(key, shape)`` XORs the two words of each element's
  counter hash (the partitionable layout);
* ``randint`` draws two words per element from the two halves of
  ``split(key)`` and folds them through the span's multiplier in uint32
  arithmetic, as ``jax.random.randint`` does;
* ``uniform`` puts the top 23 bits of a draw into the mantissa of a float
  in [1, 2), subtracts 1 and scales with one fused multiply-add (XLA:CPU
  fuses JAX's ``floats * (maxval - minval) + minval``); ``bernoulli``
  compares the [0, 1) draw with p in float32;
* ``normal`` is ``sqrt(2) * erfinv(u)`` of a uniform draw on
  [nextafter(-1, 0), 1), with XLA's float32 ``erf_inv`` polynomial (its
  Horner steps fused multiply-adds, as XLA:CPU contracts them).  Its
  ``log1p`` is PyTorch's, not XLA's, so ``normal`` alone is not bitwise:
  about 1% of the float32 draws differ from ``jax.random.normal``'s, by at
  most 3 ulp (measured; with XLA's ``log1p`` values the polynomial is
  bitwise), and their bf16 roundings agree.

The arithmetic runs on the CPU in int64 tensors masked to 32 bits, with the
Threefry block of ``repro_torch.kernels.common``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import threefry2x32

__all__ = ["prng_key", "fold_in", "split", "random_bits", "randint",
           "uniform", "normal", "bernoulli"]

_M32 = 0xFFFFFFFF
_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def _key_words(key: torch.Tensor) -> tuple[int, int]:
    if key.shape != (2,):
        raise ValueError(f"a key has shape (2,), got {tuple(key.shape)}")
    return int(key[0]) & _M32, int(key[1]) & _M32


def _words(x0, x1) -> torch.Tensor:
    return torch.stack([torch.as_tensor(x0, dtype=torch.int64),
                        torch.as_tensor(x1, dtype=torch.int64)], dim=-1)


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (0, seed mod 2^32)."""
    return _words(0, int(seed) & _M32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key's hash of the counter
    (0, data); ``data`` must fit in uint32, as JAX requires."""
    data = int(data)
    if not 0 <= data <= _M32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    k0, k1 = _key_words(key)
    return _words(*threefry2x32(k0, k1, 0, data))


def _counters(n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of a 64-bit iota of length ``n``."""
    idx = torch.arange(n, dtype=torch.int64)
    return idx >> 32, idx & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys, row i the hash of
    the counter (0, i)."""
    k0, k1 = _key_words(key)
    hi, lo = _counters(int(num))
    return _words(*threefry2x32(k0, k1, hi, lo))


def random_bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` for uint32: int64 values in
    [0, 2^32), the XOR of the two words of each element's counter hash."""
    shape = tuple(shape)
    k0, k1 = _key_words(key)
    hi, lo = _counters(math.prod(shape))
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(shape)


def randint(key: torch.Tensor, shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` with the default
    int32 dtype: an int32 tensor of values in [minval, maxval) (``minval``
    where ``maxval <= minval``).  The bounds must fit in int32, as JAX
    requires of Python ints."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    for v in (minval, maxval):
        if not _I32_MIN <= v <= _I32_MAX:
            raise OverflowError(f"randint bound {v} out of bounds for int32")
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = maxval - minval if maxval > minval else 1
    # 2^32 mod span, squared mod span; the products wrap in uint32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span
    offset = (((higher % span) * mult + lower % span) & _M32) % span
    val = (minval + offset) & _M32
    return (val - ((val >> 31) << 32)).to(torch.int32)


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, _fma32(floats, hi - lo, lo))


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once, as XLA:CPU fuses it.  The
    product is exact in float64; the sum is rounded to odd there (TwoSum's
    error decides the nudge), so the final rounding to float32 is the one
    correct rounding."""
    p = a.double() * b.double()
    c = c.double().expand_as(p)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = (s.view(torch.int64) & 1) == 1
    nudge = (err != 0) & ~odd
    toward = torch.where(err > 0, torch.full_like(s, math.inf),
                         torch.full_like(s, -math.inf))
    s = torch.where(nudge, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float ``p`` (float32,
    JAX's default ``mode="low"``): a bool tensor."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32)


# XLA's float32 erf_inv: Horner coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: w = -log1p(-x^2), a degree-8 polynomial
    in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at x = +-1."""
    f32 = torch.float32
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=f32),
                           torch.tensor(_ERFINV_GE5[i], dtype=f32))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    return torch.where(x.abs() == 1, x * torch.finfo(f32).max, p * x)


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (module docstring: within
    3 ulp, not bitwise)."""
    # the float32 neighbour of -1 toward 0
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * _erf_inv(u)
