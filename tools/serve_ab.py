#!/usr/bin/env python3
"""Concurrent single-row serving of two trees of the port, in turns.

Run on a machine with a CUDA card, from the repository root, with the
other tree's ``bodywork_tpu_torch/`` unpacked under a directory (for
example ``git archive <commit> bodywork_tpu_torch | tar -x -C build/parent``)::

    python3 tools/serve_ab.py --parent build/parent [--out FILE]

Each turn is a process of its own, in the order parent, this tree, this
tree, parent, and measures the served 1024-wide MLP (hidden (1024, 1024,
1024), seeded He init) on ``auto`` (-> ``kernel``), coalescer off:

- ``dispatch``: ``KernelMLPPredictor.predict`` of one row, 300 in turn on
  one thread, then 16 threads x 200 at once (closed loop);
- ``http``: ``serve_model`` on the thread front end, 300 single rows in
  turn on one keep-alive connection, then 16 keep-alive clients x 100 at
  once (the JAX benchmark's config 7 shape, ``bench.py:646``, four times
  as long).

For each: p50 and p99 (nearest rank, ms) and requests/s of the
concurrent part. Prints one JSON line per turn and a summary line, and
writes them to ``--out``.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import threading
import time
from datetime import date

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (1024, 1024, 1024)
SEQUENTIAL = 300
CLIENTS = 16
DISPATCH_PER_THREAD = 200
HTTP_PER_CLIENT = 100


def _nearest_rank(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(int(round(q / 100.0 * (len(ordered) - 1))), len(ordered) - 1)]


def _summary(sequential, concurrent, wall) -> dict:
    return {"sequential_p50_ms": 1e3 * _nearest_rank(sequential, 50),
            "sequential_p99_ms": 1e3 * _nearest_rank(sequential, 99),
            "concurrent_p50_ms": 1e3 * _nearest_rank(concurrent, 50),
            "concurrent_p99_ms": 1e3 * _nearest_rank(concurrent, 99),
            "requests_per_s": len(concurrent) / wall}


def _closed_loop(n_threads: int, per_thread, call) -> tuple[list, float]:
    """``n_threads`` threads each run ``call(i, x)`` over their inputs,
    started together; each call's seconds and the wall time."""
    out = [[] for _ in range(n_threads)]
    start = threading.Barrier(n_threads + 1)

    def worker(i):
        setup = call(i, None)  # one untimed call (a connection, a warm path)
        start.wait()
        for x in per_thread[i]:
            t0 = time.perf_counter()
            call(i, x, setup)
            out[i].append(time.perf_counter() - t0)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return [s for per in out for s in per], time.perf_counter() - t0


def one(root: str, label: str, device: str) -> dict:
    import http.client

    import numpy as np
    import torch

    sys.path.insert(0, os.path.abspath(root))
    import bodywork_tpu_torch
    from bodywork_tpu_torch.models import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.models.mlp import fit_keys, init_mlp_params
    from bodywork_tpu_torch.serve import serve_model
    from bodywork_tpu_torch.serve.predictor import KernelMLPPredictor

    dev = torch.device(device)
    params = {
        "net": init_mlp_params(fit_keys(0)[0], (1, *HIDDEN, 1), device=dev),
        "scaler": {"x_mean": torch.full((1,), 50.0, device=dev),
                   "x_std": torch.full((1,), 29.0, device=dev),
                   "y_mean": torch.tensor(26.0, device=dev),
                   "y_std": torch.tensor(15.0, device=dev)},
    }
    model = MLPRegressor(MLPConfig(hidden=HIDDEN), params)
    rng = np.random.default_rng(7)
    seq_x = [round(float(x), 3) for x in rng.uniform(0, 100, SEQUENTIAL)]
    disp_x = [[float(x) for x in rng.uniform(0, 100, DISPATCH_PER_THREAD)]
              for _ in range(CLIENTS)]
    http_x = [[round(float(x), 3) for x in rng.uniform(0, 100, HTTP_PER_CLIENT)]
              for _ in range(CLIENTS)]

    predictor = KernelMLPPredictor(model)
    predictor.warmup()
    for x in seq_x[:20]:
        predictor.predict(np.array([[x]], dtype=np.float32))
    seq = []
    for x in seq_x:
        t0 = time.perf_counter()
        predictor.predict(np.array([[x]], dtype=np.float32))
        seq.append(time.perf_counter() - t0)

    def dispatch(i, x, setup=None):
        return predictor.predict(np.array([[50.0 if x is None else x]], dtype=np.float32))

    conc, wall = _closed_loop(CLIENTS, disp_x, dispatch)
    result = {"turn": label, "root": root, "package": os.path.dirname(bodywork_tpu_torch.__file__),
              "engine": predictor.engine, "dispatch": _summary(seq, conc, wall)}

    kwargs = {}
    if "batch_window_ms" in inspect.signature(serve_model).parameters:
        kwargs["batch_window_ms"] = 0
    handle = serve_model(model, date(2026, 7, 3), "127.0.0.1", 0, block=False,
                         engine="auto", **kwargs)
    try:
        port = int(handle.base_url.rsplit(":", 1)[1])

        def score(conn, x):
            conn.request("POST", "/score/v1", body=json.dumps({"X": x}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            if resp.status != 200:
                raise RuntimeError(f"{label}: status {resp.status}")

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        for x in seq_x[:20]:
            score(conn, x)
        seq = []
        for x in seq_x:
            t0 = time.perf_counter()
            score(conn, x)
            seq.append(time.perf_counter() - t0)
        conn.close()

        def client(i, x, conn=None):
            if x is None:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
                score(conn, 50.0)
                return conn
            score(conn, x)

        conc, wall = _closed_loop(CLIENTS, http_x, client)
    finally:
        handle.stop()
    result["http"] = _summary(seq, conc, wall)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="the directory holding the other tree's package")
    parser.add_argument("--one", help=argparse.SUPPRESS)
    parser.add_argument("--label", default="change", help=argparse.SUPPRESS)
    parser.add_argument("--out", default=os.path.join(ROOT, "build", "serve_ab.json"))
    parser.add_argument("--device", default="cuda", help="cpu: a dry run of the script")
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(one(args.one, args.label, args.device)), flush=True)
        return 0
    if not args.parent or not os.path.isdir(os.path.join(args.parent, "bodywork_tpu_torch")):
        parser.error("--parent must hold a bodywork_tpu_torch/ directory")
    turns = []
    for label, root in (("parent", args.parent), ("change", ROOT), ("change", ROOT),
                        ("parent", args.parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                               "--label", label, "--device", args.device], capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"serve_ab: the {label} turn exited {proc.returncode}")
        turns.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    summary = {}
    for level in ("dispatch", "http"):
        for key in ("requests_per_s", "concurrent_p50_ms", "concurrent_p99_ms",
                    "sequential_p50_ms"):
            summary[f"{level}_{key}"] = {
                label: [t[level][key] for t in turns if t["turn"] == label]
                for label in ("parent", "change")}
    print(json.dumps({"summary": summary}), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"turns": turns, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
