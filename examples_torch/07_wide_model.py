"""The wide workload: a (1024, 1024, 1024) MLP lifecycle (beyond-reference),
on the PyTorch/CUDA port (``examples/07_wide_model.py`` is the JAX
version).

The reference's only model is a 1-feature OLS. This example runs the
framework's wide configuration (bench config 6) — 32 features, kilowide
hidden layers — through the full lifecycle on the card: fused fit+eval,
date-keyed checkpoint, batch serving through the shape-bucketed predictor
on ``auto`` (the fused CUDA kernel at this width), and a cross-check of
the hand-written kernels (``kernel``, f32; ``kernel-bf16``, bf16 operands
on the tensor cores) against the plain f32 apply.

There is no interpreter switch: the kernels run where ``--device`` says,
the card by default (a CPU tensor runs each kernel's plain version).
"""
import argparse
import sys
from datetime import date
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # repo-root run

import numpy as np
import torch

from bodywork_tpu_torch.models import MLPConfig, MLPRegressor, load_model, mlp_apply, save_model
from bodywork_tpu_torch.ops import make_kernel_mlp_apply
from bodywork_tpu_torch.serve import build_predictor, create_app
from bodywork_tpu_torch.store import open_store
from bodywork_tpu_torch.utils.logging import configure_logger

DEFAULT_STORE = "/tmp/bodywork-tpu-torch-wide-example"


def main() -> dict:
    """Returns the serving engine ``auto`` picked, the 8 checked rows and,
    per kernel, its apply and answers (for a caller that holds them to
    the kernels' plain versions)."""
    p = argparse.ArgumentParser()
    p.add_argument("--store", default=DEFAULT_STORE)
    p.add_argument("--rows", type=int, default=1024)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args()

    configure_logger()
    store = open_store(args.store)

    rng = np.random.default_rng(7)
    d = 32
    X = rng.uniform(-1.0, 1.0, (args.rows, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (X @ w + 0.1 * rng.normal(size=args.rows)).astype(np.float32)

    cfg = MLPConfig(
        hidden=(args.hidden,) * 3, batch_size=min(256, args.rows),
        n_steps=args.steps, learning_rate=1e-3,
    )
    split = int(args.rows * 0.8)
    model, metrics = MLPRegressor(cfg).fit_and_evaluate(
        X[:split], y[:split], X[split:], y[split:], device=args.device
    )
    print(f"trained {model.info}: MAPE={metrics['MAPE']:.4f} "
          f"r2={metrics['r_squared']:.4f}")

    key = save_model(store, model, date(2026, 1, 1))
    clone, model_date = load_model(store, device=args.device)
    print(f"checkpoint round-trip: {key} ({model_date})")

    predictor = build_predictor(clone, "auto", buckets=(64,))
    app = create_app(clone, model_date, predictor=predictor, warmup=False)
    body = app.test_client().post(
        "/score/v1/batch",
        json={"X": [[float(v) for v in row] for row in X[:8]]},
    ).get_json()
    print(f"served {body['n']} rows via /score/v1/batch "
          f"({body['model_info']})")

    rows = torch.as_tensor(X[:8], device=clone.device)
    kernel_apply = make_kernel_mlp_apply(clone.params, clone.device)
    f32 = clone.predict(X[:8])
    answers = {"kernel": kernel_apply(rows)}
    delta = np.max(np.abs(answers["kernel"].cpu().numpy() - f32))
    print(f"kernel-vs-torch max abs delta on 8 rows: {delta:.5f} "
          f"({'CUDA kernel' if rows.is_cuda else 'plain version'})")

    # bf16 (an opt-in precision/throughput trade) agrees with the f32
    # apply to bf16's ~3 significant digits, on both engines
    scale = np.max(np.abs(f32)) or 1.0
    with torch.no_grad():
        b16 = mlp_apply(clone.params, rows, compute_dtype="bfloat16").cpu().numpy()
    bf16_apply = make_kernel_mlp_apply(clone.params, clone.device, compute_dtype="bfloat16")
    answers["kernel-bf16"] = bf16_apply(rows)
    k16 = answers["kernel-bf16"].cpu().numpy()
    print(f"torch-bf16  max rel delta vs f32: {np.max(np.abs(b16 - f32)) / scale:.5f}")
    print(f"kernel-bf16 max rel delta vs f32: {np.max(np.abs(k16 - f32)) / scale:.5f}")
    return {"engine": predictor.engine, "rows": rows, "applies": {"kernel": kernel_apply, "kernel-bf16": bf16_apply},
            "answers": answers}


if __name__ == "__main__":
    main()
