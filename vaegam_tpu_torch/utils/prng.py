"""JAX's default PRNG (threefry2x32, partitionable bit layout) in numpy.

The port's own copy of the draws ``vaegam_tpu`` makes at initialization, so
that a seed gives the port the JAX package's weights: ``prng_key``,
``split``, ``uniform`` and ``normal`` follow ``jax.random`` (jax 0.9,
``jax_threefry_partitionable``): keys and uniform draws are equal bit for
bit; normal draws go through XLA's float32 inverse-error-function
polynomial, whose log1p differs from numpy's in the last bit now and then,
and agree within 3 ulps.  Keys are uint32 arrays of shape (2,).

A float64 draw (JAX under ``jax_enable_x64``) is not a float32 draw cast
up: it takes 64 random bits a value (the two threefry words, high and
low), 52 of them as the mantissa, and XLA's float64 inverse error function.
Its uniforms are equal bit for bit; its normals agree within a few ulps.
"""

from __future__ import annotations

from fractions import Fraction

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


def _bits64(key: np.ndarray, shape) -> np.ndarray:
    """64 random bits a value: the first threefry word high, the second low."""
    b0, b1 = threefry2x32(key, *_counts(shape))
    return ((b0.astype(np.uint64) << np.uint64(32)) | b1).reshape(shape)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """p + e == a * b exactly (Dekker's product; no overflow here)."""
    def split(x):
        c = 134217729.0 * x  # 2**27 + 1
        hi = c - (c - x)
        return hi, x - hi

    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a: np.ndarray, b: float, c: float) -> np.ndarray:
    """a * b + c rounded once, as the fused multiply-add XLA emits.

    Error-free transforms give the exact value as s + w + z; where the
    rounding of s + w could differ from the exact one (z nonzero and s + w
    within 2|z| of a tie) the value is recomputed in exact rationals.
    """
    p, e = _two_prod(a, np.float64(b))
    s, t = _two_sum(p, np.float64(c))
    w, z = _two_sum(t, e)
    r, q = _two_sum(s, w)
    gap = np.where(q > 0, np.nextafter(r, np.inf) - r, r - np.nextafter(r, -np.inf))
    near = (z != 0) & (np.abs(q) >= 0.5 * gap - 2 * np.abs(z))
    for i in np.flatnonzero(near):
        r.flat[i] = float(Fraction(float(a.flat[i])) * Fraction(b) + Fraction(c))
    return r


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0,
            dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform``: the high random bits (23 in float32, 52 in
    float64) as the mantissa of a float in [1, 2), shifted and scaled to
    [minval, maxval)."""
    if np.dtype(dtype) == np.float64:
        lo, hi = np.float64(minval), np.float64(maxval)
        mant = (_bits64(key, shape) >> np.uint64(12)) | np.float64(1.0).view(np.uint64)
        floats = mant.view(np.float64) - 1.0
        return np.maximum(lo, _fma64(floats, float(hi - lo), float(lo)))
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


# XLA's float64 inverse error function (Giles): one polynomial in w - 3.125
# for w < 6.25, one in sqrt(w) - 3.25 for w < 16, one in sqrt(w) - 5 above
_ERFINV64_LT6 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


# Cephes' log1p rational approximation, which XLA's CPU backend evaluates
# for |x| < sqrt(2) - 1 (log(1 + x) above): numerator and denominator,
# highest degree first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p64(x: np.ndarray) -> np.ndarray:
    """XLA's float64 log1p on the CPU (numpy's differs by up to ~100 ulps)."""
    def poly(coefs):
        out = np.zeros_like(x)
        for c in coefs:
            out = out * x + c
        return out

    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (poly(_LOG1P_P) / poly(_LOG1P_Q)))
    return np.where(np.abs(x) < 0.41421356237309504880, small, np.log(x + 1.0))


def _erfinv64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    w = -_log1p64(-x * x)
    lt6, lt16 = w < 6.25, w < 16.0
    sw = np.sqrt(w)
    w = np.where(lt6, w - 3.125, sw - np.where(lt16, 3.25, 5.0))
    p = np.zeros_like(w)
    for coefs, active in ((_ERFINV64_LT6, lt6), (_ERFINV64_LT16, lt16 & ~lt6),
                          (_ERFINV64_GE16, ~lt16)):
        q = np.full_like(w, coefs[0])
        for c in coefs[1:]:
            q = c + q * w
        p = np.where(active, q, p)
    return np.where(np.abs(x) == 1, x * np.inf, p * x)


def normal(key: np.ndarray, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal``: sqrt(2) erfinv(u), u uniform on (-1, 1)."""
    if np.dtype(dtype) == np.float64:
        lo = np.nextafter(-1.0, 0.0)
        return np.sqrt(2.0) * _erfinv64(uniform(key, shape, lo, 1.0, np.float64))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * _erfinv32(uniform(key, shape, lo, 1.0))
