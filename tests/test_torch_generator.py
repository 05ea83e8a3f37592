"""The port's drift generator and dataset I/O against the JAX package's.

The sampler's ALGEBRA is held equal on shared numpy draws, and the
generated days are held to the same distribution by statistical bands.
The draws themselves are jax.random's threefry bits
(``tests/test_torch_prng.py`` holds them to the JAX package's)."""
from datetime import date, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bodywork_tpu.data import Dataset as JaxDataset
from bodywork_tpu.data import generate_day as jax_generate_day
from bodywork_tpu.data import load_dataset as jax_load_dataset
from bodywork_tpu.data import persist_dataset as jax_persist_dataset
from bodywork_tpu.data.generator import DriftConfig as JaxDriftConfig
from bodywork_tpu.data.generator import alpha as jax_alpha
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.data import Dataset, load_dataset, load_latest_dataset, persist_dataset
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.data.generator import _sample_day, alpha, generate_day
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.utils.dates import day_of_year

torch.set_num_threads(1)

DATES = [date(2026, 1, 1) + timedelta(days=12 * i) for i in range(30)]


def test_alpha_matches_jax_for_30_dates():
    days = [day_of_year(d) for d in DATES]
    got = alpha(torch.tensor(days)).numpy()
    want = np.asarray(jax_alpha(jnp.asarray(days)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_drift_config_is_the_same_dataclass():
    assert DriftConfig().__dict__ == JaxDriftConfig().__dict__


def _jnp_sample(x, eps, day, cfg):
    """The JAX sampler's algebra (``generator.py:70-79``) on given draws."""
    a = jax_alpha(day, cfg)
    if cfg.hetero:
        span = max(cfg.x_high - cfg.x_low, 1e-9)
        scale = cfg.sigma * (1.0 + cfg.hetero * (x - cfg.x_low) / span)
        y = a + cfg.beta * x + scale * eps
    else:
        y = a + cfg.beta * x + cfg.sigma * eps
    return jnp.stack([x, y, (y >= 0.0).astype(x.dtype)])


@pytest.mark.parametrize("hetero", [0.0, 1.5], ids=["homoscedastic", "hetero"])
@pytest.mark.parametrize("day", [1, 91, 200, 365])
def test_sample_day_algebra_matches_jax(hetero, day):
    rng = np.random.default_rng(day)
    x = rng.uniform(0, 100, 1440).astype(np.float32)
    eps = rng.normal(size=1440).astype(np.float32)
    got = _sample_day(torch.from_numpy(x), torch.from_numpy(eps), day,
                      DriftConfig(hetero=hetero)).numpy()
    want = np.asarray(_jnp_sample(jnp.asarray(x), jnp.asarray(eps), day,
                                  JaxDriftConfig(hetero=hetero)))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    # the y >= 0 mask may only differ where y sits within rounding of 0
    differ = got[2] != want[2]
    assert np.all(np.abs(want[1][differ]) < 1e-5)


def test_generated_day_is_deterministic_per_date():
    x1, y1 = generate_day(date(2026, 7, 1), device="cpu")
    x2, y2 = generate_day(date(2026, 7, 1), device="cpu")
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)
    x3, _ = generate_day(date(2026, 7, 2), device="cpu")
    assert not np.array_equal(x1[:100], x3[:100])
    assert x1.dtype == y1.dtype == np.float32


def test_generated_days_match_jax_in_distribution():
    """Over 10 dates: the kept-row count (y >= 0 filter) within 15 rows of
    the JAX package's mean (binomial sd ~3 on a 10-day mean), X inside
    [0, 100), and the residual y - alpha - 0.5 x within 0.5 in mean and
    0.4 in std (4 standard errors of a 10-day mean at sigma = 10)."""
    stats = {"port": [], "jax": []}
    for d in DATES[:10]:
        a = float(jax_alpha(day_of_year(d)))
        for name, (x, y) in (("port", generate_day(d, device="cpu")),
                             ("jax", jax_generate_day(d))):
            assert x.min() >= 0.0 and x.max() < 100.0
            assert y.min() >= 0.0
            r = y - a - 0.5 * x
            stats[name].append((len(x), r.mean(), r.std()))
    port, ref = np.mean(stats["port"], axis=0), np.mean(stats["jax"], axis=0)
    assert abs(port[0] - ref[0]) < 15
    assert abs(port[1] - ref[1]) < 0.5
    assert abs(port[2] - ref[2]) < 0.4


def test_jax_written_csv_reads_back_bit_exact_in_the_port(tmp_path):
    d = date(2026, 7, 1)
    X, y = jax_generate_day(d)
    jax_persist_dataset(JaxStore(tmp_path), JaxDataset(X, y, d))
    ds = load_dataset(FilesystemStore(tmp_path), "datasets/regression-dataset-2026-07-01.csv")
    assert ds.date == d
    np.testing.assert_array_equal(ds.X[:, 0], X)
    np.testing.assert_array_equal(ds.y, y)


def test_port_written_csv_reads_back_bit_exact_in_jax(tmp_path):
    d = date(2026, 7, 2)
    X, y = generate_day(d, device="cpu")
    key = persist_dataset(FilesystemStore(tmp_path), Dataset(X, y, d))
    ds = jax_load_dataset(JaxStore(tmp_path), key)
    np.testing.assert_array_equal(ds.X[:, 0], X)
    np.testing.assert_array_equal(ds.y, y)


def test_port_writes_the_same_csv_bytes_as_pandas(tmp_path):
    """The same float32 rows serialise to the same file in both packages
    (header ``date,y,X``, shortest float32 decimals)."""
    d = date(2026, 7, 3)
    X, y = generate_day(d, device="cpu")
    a, b = JaxStore(tmp_path / "a"), FilesystemStore(tmp_path / "b")
    key = jax_persist_dataset(a, JaxDataset(X, y, d))
    assert persist_dataset(b, Dataset(X, y, d)) == key
    assert b.get_bytes(key) == a.get_bytes(key)


def test_multi_feature_dataset_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(20, 3)).astype(np.float32)
    y = rng.normal(size=20).astype(np.float32)
    store = FilesystemStore(tmp_path)
    key = persist_dataset(store, Dataset(X, y, date(2026, 7, 4)))
    assert store.get_text(key).splitlines()[0] == "date,y,X,X2,X3"
    back = load_dataset(store, key)
    np.testing.assert_array_equal(back.X, X)
    jax_back = jax_load_dataset(JaxStore(tmp_path), key)
    np.testing.assert_array_equal(jax_back.X, X)


def test_load_latest_dataset_picks_the_newest_day(tmp_path):
    store = FilesystemStore(tmp_path)
    for day in (3, 1, 2):
        d = date(2026, 7, day)
        persist_dataset(store, Dataset(np.full(4, day, np.float32), np.ones(4, np.float32), d))
    latest = load_latest_dataset(store)
    assert latest.date == date(2026, 7, 3)
    assert float(latest.X[0, 0]) == 3.0
