"""JAX's default PRNG (threefry2x32, partitionable bit layout) in numpy.

The port's own copy of the draws ``vaegam_tpu`` makes at initialization, so
that a seed gives the port the JAX package's weights: ``prng_key``,
``split``, ``uniform`` and ``normal`` follow ``jax.random`` (jax 0.9,
``jax_threefry_partitionable``): keys and uniform draws are equal bit for
bit; normal draws go through XLA's float32 inverse-error-function
polynomial, whose log1p differs from numpy's in the last bit now and then,
and agree within 3 ulps.  Keys are uint32 arrays of shape (2,).
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x0, x1)."""
    k0, k1 = (np.asarray(key, np.uint32)[i] for i in (0, 1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a non-negative seed below 2**32."""
    return np.array([0, seed], np.uint32)


def _counts(shape):
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:
        raise ValueError("more than 2**32 draws from one key")
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, *_counts((num,)))
    return np.stack([b0, b1], axis=1)


def _bits(key: np.ndarray, shape) -> np.ndarray:
    b0, b1 = threefry2x32(key, *_counts(shape))
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: the 23 high random bits as the
    mantissa of a float in [1, 2), shifted and scaled to [minval, maxval)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mant = (_bits(key, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = mant.view(np.float32) - np.float32(1.0)
    # XLA fuses the scale and shift into one fused multiply-add: the float32
    # product is exact in float64, so this rounds once, as an FMA does
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo))
    return np.maximum(lo, scaled.astype(np.float32))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 inverse error function (Giles' polynomials)."""
    x = np.asarray(x, np.float32)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    w64 = w.astype(np.float64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # Horner steps as fused multiply-adds, as XLA emits them
        c = np.where(lt, np.float32(a), np.float32(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal`` in float32: sqrt(2) erfinv(u), u uniform on
    (-1, 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * _erfinv32(uniform(key, shape, lo, 1.0))
