"""Synthetic drift-data generator on torch (the port of
``bodywork_tpu.data.generator``).

The behavioural spec is the reference's (``stage_3_synthetic_data_generation.py:28-43``)::

    y = alpha(d) + beta * X + sigma * eps
    X ~ U(0, 100), eps ~ N(0, 1), n = 24*60 rows/day, keep y >= 0
    alpha(d) = kappa + A * sin(2*pi*f*(d-1)/364)      # d = day of year

Each day is a function of ``(cfg.seed, date)`` alone, drawn as the JAX
package draws it: ``key_for_date = fold_in(PRNGKey(seed), ordinal)``,
``split`` into ``(kx, ke)``, ``uniform(kx)`` and ``normal(ke)``, through
the port's threefry (:mod:`bodywork_tpu_torch.data.prng`) on the device
it is given. ``X`` and the kept-row mask are bit-identical to the JAX
package's and the same on every device; ``eps`` and ``y`` are within the
few ulps that XLA's own ``log1p`` and ``sin`` put between them (measured
in ``tests/test_torch_prng.py``). :func:`_sample_day` is the sampler's
algebra as a pure function of the draws, so tests feed both packages the
same numpy draws.
"""
from __future__ import annotations

import math
from datetime import date

import numpy as np
import torch

from bodywork_tpu_torch.data import prng
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.utils.dates import day_of_year

__all__ = ["DriftConfig", "alpha", "generate_day", "key_for_date"]


def alpha(day, cfg: DriftConfig = DriftConfig()) -> torch.Tensor:
    """Drifting intercept for a given day-of-year (``stage_3:31-33``), in
    float32 like the JAX version. It is computed in float64 and rounded
    once, so it is the same float32 on every device (float32 ``sin``
    differs between libraries in the last bit)."""
    day = torch.as_tensor(day, dtype=torch.float64)
    return (cfg.kappa + cfg.amplitude * torch.sin(
        2.0 * math.pi * cfg.freq * (day - 1.0) / 364.0
    )).to(torch.float32)


def key_for_date(d: date, cfg: DriftConfig = DriftConfig(), device=None) -> torch.Tensor:
    """The day's threefry key, ``fold_in(PRNGKey(seed), ordinal)``, as the
    JAX package's ``key_for_date`` makes it."""
    return prng.fold_in(prng.PRNGKey(cfg.seed, device=device), d.toordinal())


def _sample_day(x: torch.Tensor, eps: torch.Tensor, day,
                cfg: DriftConfig) -> torch.Tensor:
    """One (3, n) tensor stacking (X, y, valid_mask) from the draws ``x``
    (uniform on [x_low, x_high)) and ``eps`` (standard normal)."""
    a = alpha(day, cfg).to(x.device)
    if cfg.hetero:
        # heteroscedastic scenario: noise scale ramps linearly with x
        span = max(cfg.x_high - cfg.x_low, 1e-9)
        scale = cfg.sigma * (1.0 + cfg.hetero * (x - cfg.x_low) / span)
        y = a + cfg.beta * x + scale * eps
    else:
        y = a + cfg.beta * x + cfg.sigma * eps
    return torch.stack([x, y, (y >= 0.0).to(x.dtype)])


def generate_day(
    d: date, cfg: DriftConfig = DriftConfig(), device=None
) -> tuple[np.ndarray, np.ndarray]:
    """Generate one simulated day's data on ``device`` (the card unless
    asked for the CPU); returns host float32 arrays (X, y). Rows with
    ``y < 0`` are dropped, as in the reference's ``query('y >= 0')``."""
    dev = resolve_device(device)
    # kx's and ke's draws in one pass of the hash (one row each)
    bits = prng.random_bits(prng.split(key_for_date(d, cfg, device=dev)), cfg.n_samples)
    x = prng.uniform_from_bits(bits[0], cfg.x_low, cfg.x_high)
    eps = prng.normal_from_bits(bits[1])
    stacked = _sample_day(x, eps, day_of_year(d), cfg).cpu().numpy()
    x, y, mask = stacked[0], stacked[1], stacked[2] > 0.0
    return x[mask], y[mask]
