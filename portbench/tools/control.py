"""The controls and planted faults behind each limit of ``correct``, on
the card at each cell's own sizes; the benchmark's runs do not run them.

    python3 portbench/tools/control.py --workload <cell> --seeds 11,12,13

Serving cells: the plain reference with its products in TF32 (the
precision below the configuration's float32) put in the program's
place, over every request body of a run of that seed, read as the run
reads ``answer_gap``. Training cells: the reference in TF32 against the
reference in IEEE float32, read as the run reads its four gaps
(``train_fits.judge``), and the fault of half of each minibatch left out
(the mean over the rest) planted in the reference; the program's own
fits of that seed, the set-up's and the window's first, judged as the
run judges them (the sound readings); and the program's whole fit with
Adam's bias correction taking the step count as 1 from step 4 on
(``late_count``, a fault the first three steps cannot show). A step that returns its state
unchanged reads ``change_gap`` 1 by its definition and needs no run.
Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import spec  # noqa: E402
from portbench.reference import compare  # noqa: E402
from portbench.reference import mlp as reference  # noqa: E402


def serve_control(cfg: dict, trf: dict, seed: int, device: str) -> dict:
    """The widest ``answer_gap`` of the TF32 reference over every body
    the run of ``seed`` sends."""
    import torch

    from portbench.drivers.serve_closed_loop import make_layers
    from portbench.drivers.shard import pool_rows

    widths = (cfg["features"], *cfg["hidden"], 1)
    layers = [(w.to(device), b.to(device)) for w, b in make_layers(seed, widths)]
    scaler = {k: torch.tensor(float(v), device=device) for k, v in cfg["scaler"].items()}
    gap = 0.0
    for shard in range(trf["shards"]):
        for X in pool_rows(seed, shard, trf["pool"], trf["rows"], cfg["features"],
                           cfg["x_range"]):
            X = torch.as_tensor(X, device=device)
            with reference.precision(tf32=False):
                want = reference.apply(layers, scaler, X).double().cpu().numpy()
            with reference.precision(tf32=True):
                got = reference.apply(layers, scaler, X).double().cpu().numpy()
            gap = max(gap, compare.answer_gap(got, want))
    return {"answer_gap_tf32": gap}


def _late_count_fit(mlp_cfg, X, y, seed: int, device) -> tuple:
    """``(final loss, leaves)`` of the program's whole fit with Adam's
    bias correction taking the step count as 1 from step 4 on."""
    from bodywork_tpu_torch.models import mlp
    from portbench.drivers import train_fits

    update = mlp._adam_update

    def late(params, grads, mu, nu, count, lr):
        update(params, grads, mu, nu, count if count <= 3 else 1, lr)

    mlp._adam_update = late
    try:
        fitted = mlp.MLPRegressor(mlp_cfg).fit(X, y, seed=seed, device=device)
        return fitted.final_loss, train_fits.fit_leaves(fitted)
    finally:
        mlp._adam_update = update


def train_readings(cfg: dict, trf: dict, seed: int, device: str) -> dict:
    """The four gaps of the program's fits, of the TF32 reference and of
    the half-batch fault, each against the IEEE float32 reference, for
    the fit a run of ``seed`` checks."""
    import numpy as np

    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor
    from portbench.drivers import train_fits

    rng = np.random.default_rng(seed % 2**64)
    X, y = train_fits.datasets(rng, trf, cfg["features"])[0]
    fit_seed = int(rng.integers(0, 2**31, size=4096)[0])
    mlp_cfg = MLPConfig(hidden=tuple(cfg["hidden"]), learning_rate=cfg["learning_rate"],
                        batch_size=cfg["batch_size"], n_steps=cfg["n_steps"])
    checked = train_fits.checked_steps(mlp_cfg, X, y, fit_seed, device)
    fitted = MLPRegressor(mlp_cfg).fit(X, y, seed=fit_seed, device=device)
    program = (checked, (fitted.final_loss, train_fits.fit_leaves(fitted)))
    late = (checked, _late_count_fit(mlp_cfg, X, y, fit_seed, device))
    del fitted
    ref = train_fits.reference_fit(cfg, X, y, fit_seed, device)
    out = {}
    for name, run in (("program", program), ("late_count", late),
                      ("tf32", train_fits.reference_fit(cfg, X, y, fit_seed, device,
                                                        tf32=True)),
                      ("half_batch", train_fits.reference_fit(
                          cfg, X, y, fit_seed, device, keep=cfg["batch_size"] // 2))):
        if isinstance(run, dict):  # a reference run in the program's place
            last = max(run["params"])
            run = ([(loss, None) for loss in run["losses"][:train_fits.CHECK_STEPS - 1]]
                   + [(run["losses"][train_fits.CHECK_STEPS - 1],
                       run["params"][train_fits.CHECK_STEPS])],
                   (run["losses"][last - 1], run["params"][last]))
        gaps, _counted = train_fits.judge(*run, ref)
        out.update({f"{k}_{name}": v for k, v in gaps.items()})
    return out


def readings(workload: str, seed: int, device: str = "cuda") -> dict:
    bench = spec.with_parked(spec.load_benchmark())
    cell = spec.cell(bench, workload)
    cfg, trf = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    if trf["driver"] == "serve_closed_loop":
        return serve_control(cfg, trf, seed % 2**64, device)
    return train_readings(cfg, trf, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated run seeds")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **readings(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
