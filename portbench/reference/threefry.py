"""The seeded draws of the MLP fit, worked out in NumPy: Threefry-2x32 and
the parts of ``jax.random`` the fit uses (``PRNGKey``, ``split``, the
scan's key chain, ``randint``, ``normal``), in JAX's partitionable
layout, with ``normal``'s ``erf_inv`` the float32 polynomial XLA lowers
it to. This is what ``bodywork_tpu_torch`` documents for its fit's He
init and minibatch indices; the reference computes it again here, in
uint32 NumPy arithmetic, with no code of the program.

Where XLA contracts a multiply and an add (``uniform``'s scale and shift,
each Horner step of ``erf_inv``), the float32 product is formed exactly
in float64 and the sum rounds once there and once to float32; ``log1p``
and ``sqrt`` run in float64 and round to float32.
"""
from __future__ import annotations

import numpy as np

_PARITY = np.uint32(0x1BD11BDA)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERF_INV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                  1.50140941)
_ERF_INV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                  2.83297682)


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` (uint32 arrays)
    under the key ``(k1, k2)``: 20 rounds, a key injection every four."""
    k1, k2 = np.asarray(k1, np.uint32), np.asarray(k2, np.uint32)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``(0, seed)``."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is not an int32")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _hash(key: np.ndarray, n: int):
    """The hash of the counters ``0..n-1`` under each key of ``key``
    (shape ``(..., 2)``), the result ``(..., n)``."""
    lo = np.arange(n, dtype=np.uint32)
    return threefry2x32(key[..., 0:1], key[..., 1:2], np.zeros_like(lo), lo)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    x0, x1 = _hash(key, num)
    return np.stack([x0, x1], axis=-1)


def bits(key: np.ndarray, n: int) -> np.ndarray:
    x0, x1 = _hash(key, n)
    return x0 ^ x1


def key_chain(key: np.ndarray, n: int) -> np.ndarray:
    """The keys a scan of ``key, sub = split(key)`` carries through ``n``
    steps: row ``t`` is the key step ``t`` splits."""
    chain = np.empty((n, 2), np.uint32)
    k1, k2 = key[0:1].copy(), key[1:2].copy()
    zero = np.zeros(1, np.uint32)
    for t in range(n):
        chain[t] = (k1[0], k2[0])
        k1, k2 = threefry2x32(k1, k2, zero, zero)
    return chain


def randint(key: np.ndarray, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval)`` in int32: two
    draws a value, folded with unsigned 32-bit ``rem`` and ``mul``."""
    span = np.uint32(maxval - minval if maxval > minval else 1)
    keys = split(key)
    higher = bits(keys[..., 0, :], n)
    lower = bits(keys[..., 1, :], n)
    multiplier = np.uint32((2**16) % int(span))
    multiplier = (multiplier * multiplier) % span
    offset = (higher % span) * multiplier + (lower % span)
    return minval + (offset % span).astype(np.int64)


def _uniform(b: np.ndarray, lo: np.float32, hi: np.float32) -> np.ndarray:
    scale = np.float64(hi - lo)
    floats = ((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    shifted = (floats.astype(np.float64) * scale + np.float64(lo)).astype(np.float32)
    return np.maximum(shifted, lo)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    w = (-np.log1p((x * -x).astype(np.float64))).astype(np.float32)
    small = w < np.float32(5.0)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w.astype(np.float64)).astype(np.float32) - np.float32(3.0))
    coef = [np.where(small, np.float32(a), np.float32(b))
            for a, b in zip(_ERF_INV_SMALL, _ERF_INV_LARGE)]
    w64 = w.astype(np.float64)
    p = coef[0]
    for c in coef[1:]:
        p = (c.astype(np.float64) + p.astype(np.float64) * w64).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out)


def normal(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)``, ``u``
    uniform on ``(nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _uniform(bits(key, n), lo, np.float32(1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.float32(np.sqrt(2.0)) * _erf_inv(u)
