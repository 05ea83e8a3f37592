#!/usr/bin/env python3
"""How the benchmark's check of a fit reads each way of computing the
trainer's products: ``loss_gap`` and ``change_gap`` over Adam's first three
steps, against the plain reference.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/train_gemm_gaps.py --seeds 2600000011,2600000012 [--variants plain,program]

For each run seed, the benchmark cell ``train-mlp32x1024-b32768``'s
checked fit (``portbench/drivers/train_fits.py``: data set 0 and the first
fit seed drawn from the run seed; the fit run for 1, 2 and 3 steps through
``MLPRegressor.fit``) is judged against ``portbench``'s plain reference run
for 3 steps, as the benchmark judges it (``reference.compare``). Each
variant swaps the dense layers' products (``models.mlp.train_product``)
for the duration of its fits, in the layers whose weight gradient takes
the kernel (``ops.train_gemm.kernel_layers``). A product is float64
(``(a.double() @ b.double()).float()``) or ``torch.matmul``, chosen for
the forward ``h @ w``, the input gradient ``dY @ w.T`` and the weight
gradient ``h.T @ dY`` apart:

- ``plain``: every product ``torch.matmul`` (the parent commit's step);
- ``program``: ``ops.train_gemm.train_product`` as the trainer runs it,
  its weight gradients on the kernel;
- ``exact-all``, ``exact-forward``, ``exact-weight-grad``: float64
  products for all three, or for one.

Prints one JSON line a seed and variant: ``loss_gaps`` (steps 1-3, each
relative), ``change_gap`` (after step 3) and the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: variant -> the way of each product: (forward, input gradient, weight gradient)
VARIANTS = {
    "plain": ("torch", "torch", "torch"),
    "program": None,
    "exact-all": ("exact", "exact", "exact"),
    "exact-forward": ("exact", "torch", "torch"),
    "exact-weight-grad": ("torch", "torch", "exact"),
}


def product_function(ways):
    """``train_product``'s stand-in computing each product its way."""
    import torch

    def one(way, a, b):
        return a @ b if way == "torch" else (a.double() @ b.double()).float()

    class Product(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, w):
            ctx.save_for_backward(h, w)
            return one(ways[0], h, w)

        @staticmethod
        def backward(ctx, grad):
            h, w = ctx.saved_tensors
            grad_h = one(ways[1], grad, w.t()) if ctx.needs_input_grad[0] else None
            grad_w = one(ways[2], h.t(), grad) if ctx.needs_input_grad[1] else None
            return grad_h, grad_w

    return Product.apply


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True, help="comma-separated run seeds")
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from bodywork_tpu_torch.models import mlp
    from portbench.drivers import train_fits
    from portbench.harness import spec
    from portbench.reference import compare

    bench = spec.load_benchmark()
    cell = spec.cell(bench, "train-mlp32x1024-b32768")
    cfg, trf = spec.config(bench, cell["config"]), spec.traffic(cell["traffic"])
    mlp_cfg = mlp.MLPConfig(hidden=tuple(cfg["hidden"]), learning_rate=cfg["learning_rate"],
                            batch_size=cfg["batch_size"], n_steps=cfg["n_steps"])
    steps = train_fits.CHECK_STEPS
    card = torch.cuda.get_device_name(0)
    program = mlp.train_product
    for seed in (int(s) for s in args.seeds.split(",")):
        rng = np.random.default_rng(seed)
        X, y = train_fits.datasets(rng, trf, cfg["features"])[0]
        fit_seed = int(rng.integers(0, 2**31, size=4096)[0])
        with train_fits.reference.precision(tf32=False):
            ref = train_fits.reference.fit_steps(
                X, y, fit_seed, tuple(cfg["hidden"]), cfg["learning_rate"], cfg["batch_size"],
                steps, "cuda", record=(steps,))
        leaves = compare.counted_leaves(ref["grad_norms"])
        for name in args.variants.split(","):
            ways = VARIANTS[name]
            mlp.train_product = program if ways is None else product_function(ways)
            try:
                checked = train_fits.checked_steps(mlp_cfg, X, y, fit_seed, "cuda")
            finally:
                mlp.train_product = program
            gaps = [abs(c[0] - r) / abs(r) for c, r in zip(checked, ref["losses"][:steps])]
            print(json.dumps({
                "seed": seed, "variant": name, "loss_gaps": gaps, "loss_gap": max(gaps),
                "change_gap": compare.change_gap(checked[-1][1], ref["params"][steps],
                                                 ref["init"], leaves),
                "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
