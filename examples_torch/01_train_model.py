"""Train a regressor on all dataset history to date (reference
``notebooks/1-train-model.ipynb`` / ``stage_1_train_model.py``), on the
PyTorch/CUDA port (``examples/01_train_model.py`` is the JAX version).

Downloads nothing: history lives in the artefact store on the host
filesystem. The fit runs on the card (closed-form OLS for the linear
model); metrics (MAPE / R^2 / max residual) come back from one fused
predict+metrics pass. ``--device cpu`` runs it on the CPU instead.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

from datetime import date

from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
from bodywork_tpu_torch.train import train_on_history
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-example-store"


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--store", default=DEFAULT_STORE)
    p.add_argument("--model", default="linear", choices=["linear", "mlp"])
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args()

    configure_logger()
    store = open_store(args.store)
    if not store.history(DATASETS_PREFIX):
        # bootstrap day 0, as the reference does by hand-running the
        # stage-3 notebook before the first deployment
        d0 = date.today()
        X, y = generate_day(d0, device=args.device)
        persist_dataset(store, Dataset(X, y, d0))

    result = train_on_history(store, args.model, device=args.device)
    print(f"trained on {result.n_rows} rows to {result.data_date}")
    print(f"metrics: {result.metrics}")
    print(f"model checkpoint: {result.model_artefact_key}")


if __name__ == "__main__":
    main()
