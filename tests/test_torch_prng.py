"""The port's threefry draws (``bodywork_tpu_torch.data.prng``) against
``jax.random`` on the same seeds and dates.

The words of the hash, ``PRNGKey``, ``fold_in``, ``split``, the 32-bit
draws and ``uniform`` are bit-identical. ``normal`` runs XLA's float32
``erf_inv`` polynomial, but XLA's ``log1p`` is its own: measured over
the 5 x 200000 draws below and the 365 x 1440 of 2026, at most 3 ulps
apart on under 1% of the draws (``torch.erfinv`` instead: 90 ulps, on
59% of them). ``y`` adds XLA's float32 ``sin`` in the intercept: at most
7.63e-6 apart, one ulp of 64 (bar: two). The generated ``X`` and the
kept-row mask are bit-identical for every date of 2026."""
from datetime import date, timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jax_prng

from bodywork_tpu.data.generator import _sample_day as jax_sample_day
from bodywork_tpu.data.generator import generate_day as jax_generate_day
from bodywork_tpu.data.generator import key_for_date as jax_key_for_date
from bodywork_tpu.utils.dates import day_of_year
from bodywork_tpu_torch.data import prng
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.data.generator import _sample_day, generate_day, key_for_date

torch.set_num_threads(1)

#: ``normal`` against ``jax.random.normal``: the most ulps apart, and the
#: largest share of draws that differ at all (measured: 3 and 0.96%)
NORMAL_ULPS = 3
NORMAL_SHARE = 0.015
#: ``y`` against the JAX package's: two ulps of 64 (measured: one)
Y_ATOL = 2 * float(np.spacing(np.float32(64.0)))

SEEDS = [0, 1, 42, 2**31 - 1, -1, -(2**31)]
DATES_2026 = [date(2026, 1, 1) + timedelta(days=i) for i in range(365)]


def _words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """ulps between float32 arrays of one sign pattern (the draws here)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_the_port_follows_the_partitionable_threefry_layout():
    """JAX 0.5+ defaults ``jax_threefry_partitionable`` to True and the
    JAX package never sets it: the port computes that layout."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_is_jaxs(seed):
    assert prng.PRNGKey(seed).tolist() == _words(jax.random.PRNGKey(seed)).tolist()


def test_prng_key_refuses_seeds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        prng.PRNGKey(2**31)


def test_threefry_words_are_jaxs():
    rng = np.random.default_rng(0)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    count = rng.integers(0, 2**32, 64, dtype=np.uint32)
    want = jax_prng.threefry_2x32(jnp.asarray(key), jnp.asarray(count))
    # threefry_2x32 hashes the counts' first half against their second
    half = torch.from_numpy(count.astype(np.int64)).view(2, 32)
    k = torch.from_numpy(key.astype(np.int64))
    got = torch.cat(prng.threefry2x32(k[0], k[1], half[0], half[1]))
    assert got.tolist() == _words(want).tolist()


@pytest.mark.parametrize("seed", [0, 42, -1])
@pytest.mark.parametrize("data", [0, 1, 739798, 2**32 - 1])
def test_fold_in_is_jaxs(seed, data):
    got = prng.fold_in(prng.PRNGKey(seed), data)
    want = jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data))
    assert got.tolist() == _words(want).tolist()


@pytest.mark.parametrize("num", [2, 3, 7])
def test_split_is_jaxs(num):
    key = prng.fold_in(prng.PRNGKey(42), 5)
    want = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(42), 5), num)
    assert prng.split(key, num).tolist() == _words(want).tolist()


@pytest.mark.parametrize("n", [1, 2, 1000, 1441])
def test_random_bits_are_jaxs(n):
    got = prng.random_bits(prng.PRNGKey(7), n)
    want = jax.random.bits(jax.random.PRNGKey(7), (n,), dtype=jnp.uint32)
    assert got.tolist() == _words(want).tolist()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 100.0), (-3.5, 2.25),
                                   (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)])
def test_uniform_is_bit_identical(lo, hi):
    for s in range(3):
        key = prng.fold_in(prng.PRNGKey(42), s)
        got = prng.uniform(key, 20000, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(42), s), (20000,), minval=lo, maxval=hi))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_normal_within_the_measured_ulp_bar():
    worst, share = 0, 0.0
    for s in range(5):
        key = prng.fold_in(prng.PRNGKey(42), s)
        got = prng.normal(key, 200000).numpy()
        want = np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(42), s),
                                            (200000,)))
        ulps = _ulps(got, want)
        worst, share = max(worst, int(ulps.max())), max(share, float((ulps > 0).mean()))
    assert worst <= NORMAL_ULPS, worst
    assert share <= NORMAL_SHARE, share


def test_erf_inv_is_xlas_polynomial():
    x = np.concatenate([np.linspace(-1, 1, 4001, dtype=np.float32),
                        np.float32([0.0, -0.0, 0.999999, -0.99999994])])
    got = prng.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    assert np.isposinf(got[x == 1.0]).all() and np.isneginf(got[x == -1.0]).all()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert _ulps(got[finite], want[finite]).max() <= NORMAL_ULPS


def test_key_for_date_is_jaxs():
    for d in (date(2026, 1, 1), date(2026, 7, 1), date(2030, 12, 31)):
        assert key_for_date(d).tolist() == _words(jax_key_for_date(d)).tolist()


@pytest.mark.parametrize("d", [date(2026, 1, 1), date(2026, 7, 1), date(2026, 12, 31)])
def test_generated_day_is_jaxs(d):
    x, y = generate_day(d, device="cpu")
    want_x, want_y = jax_generate_day(d)
    np.testing.assert_array_equal(x.view(np.int32), want_x.view(np.int32))
    np.testing.assert_allclose(y, want_y, rtol=0, atol=Y_ATOL)


def test_kept_rows_are_jaxs_for_every_date_of_2026():
    """The sampler's (X, y, mask) from the port's draws against the JAX
    package's jitted sampler, for all 365 dates."""
    cfg = DriftConfig()
    for d in DATES_2026:
        want = np.asarray(jax_sample_day(jax_key_for_date(d), day_of_year(d), cfg))
        kx, ke = prng.split(key_for_date(d, cfg))
        x = prng.uniform(kx, cfg.n_samples, cfg.x_low, cfg.x_high)
        got = _sample_day(x, prng.normal(ke, cfg.n_samples), day_of_year(d), cfg).numpy()
        np.testing.assert_array_equal(got[0], want[0], err_msg=str(d))
        np.testing.assert_array_equal(got[2], want[2], err_msg=str(d))
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=Y_ATOL, err_msg=str(d))


def test_a_stack_of_keys_draws_each_keys_bits():
    keys = prng.split(prng.PRNGKey(42), 3)
    stacked = prng.random_bits(keys, 500)
    assert stacked.shape == (3, 500)
    for i in range(3):
        assert torch.equal(stacked[i], prng.random_bits(keys[i], 500))
