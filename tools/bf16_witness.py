#!/usr/bin/env python3
"""Where the bf16 kernel's distance to its plain version comes from.

Run on a machine with a CUDA card, from the repository root::

    python3 tools/bf16_witness.py [--seeds 8] [--out FILE]

``kernel-bf16`` (``ops/csrc/mlp_bf16_tc.cu``) computes
``h = bf16(h) . W + b`` per layer with f32 accumulation on the tensor
cores; its plain version (``mlp_stack_plain``) computes the same with
IEEE f32 products and sums. This script holds both, and two more
versions of the same function, against an exact witness, the same
bf16-rounded operands with float64 products and sums, rounded once to
f32 per layer:

- ``plain``: the plain version (cuBLAS SGEMM, TF32 off);
- ``plain-permuted``: the plain version with each layer's K order
  shuffled, i.e. another legitimate f32 summation order;
- ``library-tc``: cuBLAS's bf16 tensor-core GEMM with f32 output
  (``torch.mm(..., out_dtype=torch.float32)``), where this PyTorch has it;
  this and the witness are ``chip_smoke.py``'s ``bf16_library`` and
  ``bf16_exact``;
- ``kernel``: the port's bf16 kernel.

Two readings per version, as max|version - witness| / max(1, max|witness|)
over 4096 rows of uniform [0, 100) inputs:

1. ``stack``: the served 1 -> 1024 -> 1024 -> 1024 -> 1 stack, for each
   of ``--seeds`` seeded He inits (the served checkpoint's is seed 0),
   with the scaler of three generated days, and the served checkpoint's
   ``serve-graph`` 4096-row bucket input as ``chip_smoke.py`` draws it;
2. ``dot``: a 1 -> 1024 -> 1 stack, whose output is one 1024-long dot
   product after the one bf16 rounding both sides share, so the whole
   error is the accumulation's: its RMS and its mean signed toward zero
   (negative: the sum comes out smaller in magnitude), in units of 2^-24
   of the sum of |terms|.

Prints one JSON line per reading and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import date

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = (1, 1024, 1024, 1024, 1)
ROWS = 4096


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "bf16_witness.json"))
    parser.add_argument("--device", default="cuda",
                        help="cpu runs the kernel's plain version in its place (a dry run)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bf16_witness: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from bodywork_tpu_torch.data import generate_day
    from bodywork_tpu_torch.models.mlp import _masked_stats, fit_keys, init_mlp_params
    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply, mlp_stack_plain
    from chip_smoke import bf16_exact, bf16_library, rel_err

    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)

    days = [generate_day(d, device=dev) for d in
            (date(2026, 7, 1), date(2026, 7, 2), date(2026, 7, 3))]
    X_hist = torch.as_tensor(np.concatenate([X for X, _ in days]), device=dev)
    y_hist = torch.as_tensor(np.concatenate([y for _, y in days]), device=dev)
    ones = torch.ones(X_hist.shape[0], device=dev)
    x_mean, x_std = _masked_stats(X_hist, ones)
    y_mean, y_std = _masked_stats(y_hist, ones)
    scaler = {"x_mean": x_mean[None], "x_std": x_std[None], "y_mean": y_mean, "y_std": y_std}

    def params(seed, widths):
        return {"net": init_mlp_params(fit_keys(seed)[0], widths, device=dev), "scaler": scaler}

    def permuted(layers, X):
        h = X.to(torch.float32)
        for i, layer in enumerate(layers):
            perm = torch.randperm(h.shape[1], generator=gen).to(dev)
            h = h.to(torch.bfloat16).float()[:, perm] @ layer["w"].float()[perm] + layer["b"]
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h[:, 0]

    def versions(apply, X):
        layers = apply.layers
        out = {"plain": mlp_stack_plain(layers, X, "bfloat16"),
               "plain-permuted": permuted(layers, X), "kernel": apply(X)}
        library = bf16_library(torch, layers, X)
        if library is not None:
            out["library-tc"] = library
        return out

    def rel(got, want):
        return rel_err(got, want)[1]

    lines = []

    def emit(**line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    cases = []
    for seed in range(args.seeds):
        X = np.random.default_rng(100 + seed).uniform(0, 100, (ROWS, 1)).astype(np.float32)
        cases.append((f"seed-{seed}", seed, X))
    # chip_smoke's serve-graph bucket draw for kernel-bf16 (seed 1: the
    # 256- and 512-row buckets first, then the 4096-row bucket)
    rng = np.random.default_rng(1)
    rng.uniform(0, 100, (256, 1))
    rng.uniform(0, 100, (512, 1))
    cases.append(("serve-graph-4096", 0, rng.uniform(0, 100, (ROWS, 1)).astype(np.float32)))
    for name, seed, Xn in cases:
        apply = make_kernel_mlp_apply(params(seed, WIDTHS), dev, compute_dtype="bfloat16")
        X = torch.as_tensor(Xn, device=dev)
        want = bf16_exact(torch, apply.layers, X)
        got = versions(apply, X)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        emit(reading="stack", case=name, seed=seed, rows=ROWS,
             vs_witness={k: rel(v, want) for k, v in got.items()},
             kernel_vs_plain=rel(got["kernel"], got["plain"]),
             permuted_vs_plain=rel(got["plain-permuted"], got["plain"]))

    for seed in range(args.seeds):
        apply = make_kernel_mlp_apply(params(seed, (1, 1024, 1)), dev, compute_dtype="bfloat16")
        Xn = np.random.default_rng(200 + seed).uniform(0, 100, (ROWS, 1)).astype(np.float32)
        X = torch.as_tensor(Xn, device=dev)
        layers = apply.layers
        h = X.to(torch.bfloat16).float() @ layers[0]["w"].float() + layers[0]["b"]
        h = torch.relu(h).to(torch.bfloat16).double()
        terms = (h * layers[1]["w"].double()[:, 0]).abs().sum(1)
        want = bf16_exact(torch, layers, X).double()
        unit = terms * 2.0 ** -24
        line = {}
        for k, v in versions(apply, X).items():
            signed = (v.double() - want) * torch.sign(want) / unit
            line[k] = {"rms_units": float(signed.pow(2).mean().sqrt()),
                       "mean_toward_zero_units": float(signed.mean()),
                       "max_units": float(signed.abs().max())}
        emit(reading="dot", seed=seed, rows=ROWS, widths=[1, 1024, 1], **line)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
