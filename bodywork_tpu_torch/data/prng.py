"""Threefry-2x32 draws bit-identical to ``jax.random`` (the port's copy of
the parts of ``jax._src.prng`` and ``jax._src.random`` the generator uses).

The JAX package makes each simulated day a function of ``(seed, date)``
alone: ``fold_in(PRNGKey(seed), ordinal)``, ``split``, then ``uniform``
and ``normal`` (``bodywork_tpu/data/generator.py``). This module computes
the same bits in torch, on any device, so a day generated on the card,
on the CPU or by the JAX package is one and the same day.

It follows JAX's *partitionable* threefry layout, the default of
``jax_threefry_partitionable`` since JAX 0.5 (and never changed by the
JAX package): ``split`` and ``random_bits`` hash a 64-bit iota given as
(high, low) 32-bit counter words and take the two output words (split)
or their xor (32-bit bits). ``tests/test_torch_prng.py`` pins that flag.

Unsigned 32-bit words are carried in ``int64`` tensors and masked with
``& 0xFFFFFFFF`` after every add and shift. Every float step is its own
elementwise op, the same on every device: no fused multiply-add that a
compiler may or may not form changes a bit. Where XLA contracts a
multiply and an add into one (``uniform``'s scale and shift, each Horner
step of ``erf_inv``), the port computes both in float64, where a float32
product is exact, and rounds to float32 once the sum is formed.

``normal`` is ``sqrt(2) * erf_inv(u)`` of a uniform on
``(nextafter(-1, 0), 1)``, with ``erf_inv`` the float32 polynomial that
XLA lowers ``lax.erf_inv`` to (:func:`erf_inv`) rather than
``torch.erfinv``, which differs in the last bits. XLA's own ``log1p``
is not correctly rounded, so ``normal`` still differs from
``jax.random.normal`` by a few ulps on about 1% of draws (the bar and
its measurement are in ``tests/test_torch_prng.py``).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "erf_inv", "fold_in", "normal", "normal_from_bits", "random_bits",
           "split", "threefry2x32", "uniform", "uniform_from_bits"]

_MASK = 0xFFFFFFFF
#: the Threefry key-schedule parity constant
_PARITY = 0x1BD11BDA
#: rotation distances of the two alternating groups of four rounds
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: 20 rounds with a key injection every four (JAX's
    ``_threefry2x32_lowering``). Words are uint32 values in ``int64``
    tensors; ``k1``/``k2`` are 0-d tensors or ints. Returns two words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The raw key ``jax.random.PRNGKey(seed)`` makes with 64-bit types off
    (the JAX package's setting): the seed as an int32, bit-cast to the
    word pair ``(0, seed mod 2**32)``. A (2,) ``int64`` tensor."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} does not fit the int32 seed JAX takes")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _hash_counters(key: torch.Tensor, n: int):
    """The partitionable layout's hash of the 64-bit iota ``0..n-1`` under
    each key of ``key`` (shape ``(..., 2)``; the result ``(..., n)``): the
    counters' high words are 0 below 2**32."""
    if n >= 2**32:
        raise ValueError(f"{n} draws exceed the 32-bit counter words")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[..., 0:1], key[..., 1:2], torch.zeros_like(lo), lo)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the key hashed over the counter pair
    ``(0, data)`` (``threefry_seed`` of a 32-bit datum)."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data {data} is not a 32-bit word")
    counter = torch.tensor([data], dtype=torch.int64, device=key.device)
    bits1, bits2 = threefry2x32(key[0], key[1], torch.zeros_like(counter), counter)
    return torch.cat([bits1, bits2])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: a (num, 2) tensor of keys, key ``i`` the two
    output words of the hash of counter ``i``."""
    bits1, bits2 = _hash_counters(key, num)
    return torch.stack([bits1, bits2], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` 32-bit draws (``jax.random.bits``): the xor of the two output
    words of each counter's hash, as uint32 values in an ``int64`` tensor.
    A stack of keys (``(k, 2)``) draws ``(k, n)`` in one pass, each row
    what its key alone draws."""
    bits1, bits2 = _hash_counters(key, n)
    return bits1 ^ bits2


def _f32(value) -> np.float32:
    return np.float32(value)


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (:func:`uniform_from_bits` of
    :func:`random_bits`)."""
    return uniform_from_bits(random_bits(key, n), minval, maxval)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``'s float32 from 32-bit draws: 23 random
    mantissa bits under the exponent of 1.0 give a float in [1, 2); minus
    1, scaled to the range and shifted as one fused multiply-add (as XLA
    contracts it: the float32 product is exact in float64, the sum rounds
    there and then to float32), and held at ``minval`` from below."""
    lo, hi = _f32(minval), _f32(maxval)
    scale = float(hi - lo)  # rounded in float32, as the JAX program does
    bits = (bits >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    shifted = (floats.double() * scale + float(lo)).float()
    return torch.clamp_min(shifted, float(lo))


#: XLA's float32 ``ErfInv`` (Giles' single-precision approximation):
#: polynomial coefficients in ``w - 2.5`` where ``w = -log1p(-x*x) < 5``,
#: and in ``sqrt(w) - 3`` beyond, highest power first
_ERF_INV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                  0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                  1.50140941)
_ERF_INV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                  0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                  2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function, step for step as XLA expands
    ``lax.erf_inv``: ``w = -log1p(x * -x)``, a degree-8 Horner polynomial
    in ``w - 2.5`` or ``sqrt(w) - 3`` (by ``w < 5``) times ``x``, and
    ``±inf`` at ``|x| == 1``.

    Three steps run in float64 and round to float32, so that every device
    gets the same bits: ``log1p``, whose float32 versions differ between
    libraries (float64's are within an ulp of float64, which rounds to
    the nearest float32); ``sqrt``, whose float32 version on the card
    differed from the CPU's on about 0.7% of inputs (H100, CUDA 12.8; a
    float64 square root rounds to the correctly rounded float32 one); and
    each Horner step, which XLA contracts into a fused multiply-add (a
    float32 product is exact in float64)."""
    w = -torch.log1p((x * -x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    coef = [torch.where(small, torch.tensor(_f32(a), device=x.device),
                        torch.tensor(_f32(b), device=x.device))
            for a, b in zip(_ERF_INV_SMALL, _ERF_INV_LARGE)]
    w64 = w.double()
    p = coef[0]
    for c in coef[1:]:
        # one Horner step as a fused multiply-add, as XLA contracts it:
        # the float32 product is exact in float64, the sum rounds once
        # there and once more to float32
        p = (c.double() + p.double() * w64).float()
    result = p * x
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), result)


def normal(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.normal`` in float32 (:func:`normal_from_bits` of
    :func:`random_bits`)."""
    return normal_from_bits(random_bits(key, n))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s float32 from 32-bit draws: ``sqrt(2) *
    erf_inv(u)`` with ``u`` uniform on ``(nextafter(-1, 0), 1)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform_from_bits(bits, float(lo), 1.0)
    return float(_f32(np.sqrt(2.0))) * erf_inv(u)
