"""``jax.random``'s default generator in numpy, so that a seed names the
same initial model in the port as in the JAX package.

The JAX package draws its N(0, 1) init from ``jax.random.PRNGKey(seed)``
(cliora_tpu/models/params.py); this module keeps its own copy of what
``jax/_src/prng.py`` and ``jax/_src/random.py`` (jax 0.9.0) do for the
default implementation, threefry2x32 with
``jax_threefry_partitionable`` on (that release's default) and 64-bit
types off:

* :func:`PRNGKey` -- ``[0, seed mod 2**32]``;
* :func:`split` -- threefry2x32 of the (hi, lo) words of each flat index,
  both output words forming the new keys;
* :func:`bits` -- the same counters, the two output words XORed;
* :func:`uniform` -- 23 mantissa bits under the exponent of 1.0, minus 1,
  scaled into [minval, maxval), then max with minval
  (``random.py:_uniform``);
* :func:`normal` -- sqrt(2) * erf_inv(u) for u uniform in
  [nextafter(-1, 0), 1) (``random.py:_normal_real``), with ``erf_inv``
  the f32 polynomial of Giles that XLA lowers ``lax.erf_inv`` to.

Keys, bits and uniforms equal ``jax.random``'s bit for bit.  XLA's CPU
code contracts each polynomial step of ``erf_inv`` into one FMA; here a
step is an f64 multiply and add rounded to f32, and ``log1p`` is taken
in f64 and rounded to f32, so that the bits are the same on every host
(numpy's f32 SIMD paths are not).  Normals agree with ``jax.random``'s
within a few ulp, most of them bit for bit: the rest follow XLA's own
f32 ``log1p``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple, Union

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# elements a chunk of :func:`normal` works on, one thread each: large
# enough that numpy's loops, not the interpreter, hold the time
_CHUNK = 1 << 20
_THREADS = min(8, os.cpu_count() or 1)

# erf_inv's coefficients, highest power first (XLA's ErfInv32)
_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
           -4.39150654e-06, 0.00021858087, -0.00125372503,
           -0.00417768164, 0.246640727, 1.50140941)
_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
           -0.00367342844, 0.00573950773, -0.0076224613,
           0.00943887047, 1.00167406, 2.83297682)
_COEFFS = np.array([_W_LT_5, _W_GE_5], np.float32).astype(np.float64)
_SQRT2 = np.float32(np.sqrt(2))

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 -- jax.random's name
    """The raw key ``jax.random.PRNGKey(seed)`` gives with 64-bit types
    off: the low 32 bits of ``seed`` (two's complement), high word 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key``; ``prng.py:_threefry2x32_lowering``."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = np.asarray(x0, np.uint32) + np.uint32(ks[0])
    b = np.asarray(x1, np.uint32) + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a += b
            b = _rotl(b, r)
            b ^= a
        a += np.uint32(ks[(i + 1) % 3])
        b += np.uint32((ks[(i + 2) % 3] + i + 1) & 0xFFFFFFFF)
    return a, b


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(map(int, shape))


def _counters(start: int, stop: int) -> Tuple[np.ndarray, np.ndarray]:
    """The (hi, lo) words of the flat indices [start, stop), as
    ``prng.py:iota_2x32_shape`` gives them."""
    idx = np.arange(start, stop, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key, num: Shape = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: keys of shape ``(*num, 2)``."""
    shape = _shape(num)
    hi, lo = _counters(0, int(np.prod(shape, dtype=np.int64)))
    a, b = threefry2x32(key, hi, lo)
    return np.stack([a, b], axis=-1).reshape(*shape, 2)


def _bits(key, start: int, stop: int) -> np.ndarray:
    a, b = threefry2x32(key, *_counters(start, stop))
    a ^= b
    return a


def bits(key, shape: Shape) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 words."""
    shape = _shape(shape)
    return _bits(key, 0, int(np.prod(shape, dtype=np.int64))).reshape(shape)


def _unit(words: np.ndarray) -> np.ndarray:
    """Floats in [0, 1) from the top 23 bits of each word."""
    words >>= np.uint32(9)
    words |= np.uint32(0x3F800000)
    return words.view(np.float32) - np.float32(1)


def _scale(floats: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    """max(lo, floats * (hi - lo) + lo), the multiply and add one FMA."""
    out = (floats * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out, out=out)


def uniform(key, shape: Shape = (), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    shape = _shape(shape)
    lo, hi = np.float32(minval), np.float32(maxval)
    words = _bits(key, 0, int(np.prod(shape, dtype=np.int64)))
    return _scale(_unit(words), lo, hi).reshape(shape)


def _poly(coeffs, t: np.ndarray) -> np.ndarray:
    """Horner's rule in f32 on f64 ``t``, each step one FMA: the product
    of two f32 values is exact in f64, so the f64 multiply and add
    rounded to f32 is the f32 FMA, except where the rounded f64 sum
    lands on an f32 halfway point."""
    p = np.full(t.shape, coeffs[0], np.float32)
    acc = np.empty(t.shape, np.float64)
    for c in coeffs[1:]:
        np.multiply(p, t, out=acc)
        acc += c
        p[...] = acc
    return p


def erf_inv(x: np.ndarray) -> np.ndarray:
    """The f32 inverse error function as XLA computes it (Giles'
    polynomial; w = -log1p(-x**2), one coefficient set below w = 5 in
    w - 2.5, the other in sqrt(w) - 3), with each step an FMA; +-inf at
    |x| = 1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
        big = ~(w < np.float32(5))
        p = _poly(_COEFFS[0], (w - np.float32(2.5)).astype(np.float64))
        if big.any():
            wb = w[big]
            p[big] = _poly(_COEFFS[1], (np.sqrt(wb) - np.float32(3))
                           .astype(np.float64))
        out = p * x
    return np.where(np.abs(x) == np.float32(1), x * np.float32(np.inf), out)


def normal(key, shape: Shape = ()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``.  Chunks of the flat
    draw are independent, so they run on a pool of threads (numpy
    releases the GIL inside its loops); the bits do not depend on it."""
    shape = _shape(shape)
    n = int(np.prod(shape, dtype=np.int64))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    out = np.empty(n, np.float32)

    def fill(start):
        stop = min(start + _CHUNK, n)
        u = _scale(_unit(_bits(key, start, stop)), lo, np.float32(1))
        out[start:stop] = _SQRT2 * erf_inv(u)

    starts = range(0, n, _CHUNK)
    if len(starts) > 1:
        with ThreadPoolExecutor(min(_THREADS, len(starts))) as pool:
            list(pool.map(fill, starts))
    elif n:
        fill(0)
    return out.reshape(shape)
