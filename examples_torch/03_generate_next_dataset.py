"""Simulate the next day's drifting data (reference
``notebooks/3-generate-next-dataset.ipynb`` / ``stage_3``), on the
PyTorch/CUDA port (``examples/03_generate_next_dataset.py`` is the JAX
version).

The generative model is the reference's, exactly (SURVEY.md §2 behavioral
spec), sampled on the card with the port's threefry under the JAX
package's per-day PRNG key, so any simulated day is bit-reproducible and
``X`` is bit-equal to the JAX package's day:

    y = alpha(d) + 0.5 * X + 10 * eps,   X ~ U(0, 100), eps ~ N(0, 1)
    alpha(d) = 1 + 0.5 * sin(2 pi * 6 * (d - 1) / 364)   # concept drift
    n = 24 * 60 rows/day, rows with y < 0 dropped
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

from datetime import date, timedelta

from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
from bodywork_tpu_torch.data.generator import DriftConfig, alpha, day_of_year
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-example-store"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--store", default=DEFAULT_STORE)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args()

    configure_logger()
    store = open_store(args.store)
    hist = store.history(DATASETS_PREFIX)
    target = (hist[-1][1] + timedelta(days=1)) if hist else date.today()

    cfg = DriftConfig()
    X, y = generate_day(target, cfg, device=args.device)
    key = persist_dataset(store, Dataset(X, y, target))
    a = float(alpha(day_of_year(target), cfg))
    print(f"generated {len(y)} rows for {target} (alpha = {a:.4f}) -> {key}")


if __name__ == "__main__":
    main()
