"""Batched scoring through the split service (``cli serve --frontends N``)
under a closed loop of spawned client shards.

Set-up: the served checkpoint is made from the run's seed (He-normal
weights from a ``torch.Generator`` on the host, the final layer's draw
halved, zero biases; the configuration's scaler), written with its
registry record through the port's own API (``save_model``,
``register_candidate`` with the prediction-sanity band, ``promote``),
then served by ``drivers/serve_launch.py serve`` with ``frontends`` front
ends, the ``server_engine`` HTTP engine, ``/metrics``, the ``transport``
row queue and the watcher off. The weights are made on the host so that
the dispatcher is the one process on the card. ``shards`` client shards
(``drivers/shard.py``) of ``connections`` connections each warm up;
``setup_s`` ends where the window starts.

The window: every connection sends its next request of ``rows`` rows as
soon as the last is answered, for ``seconds``: a closed loop runs the
service at its capacity. ``score_rows_per_s`` is the rows answered with
a 200 and a correct body within the window over its seconds. At
capacity a request's latency is the queue's (16 in flight over the
rate): its 95th percentile is printed with the notes and is no metric.

With ``--trace 1`` the service's ``/metrics`` is read before and after
the window, the card's utilization counter is sampled through it
(``harness.gpustat``: ``busy_s``, since the dispatcher has no profiler
hook of its own, and a profile started from outside it slowed its
dispatches five-fold and recorded no kernel), and once the service has
stopped the f32 kernel is launched alone at the requests' bucket on the
served weights under a device trace.

After the window: the service is stopped and its processes checked
gone; the plain reference computes every distinct answer's rows again on
the card and the widest gap is held to the configuration's limit.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from datetime import date
from pathlib import Path

import numpy as np

from portbench.drivers import shard as shard_mod
from portbench.harness import Outcome, card_power_limit, procs
from portbench.harness.devtrace import DeviceTrace
from portbench.harness.gpustat import UtilizationSampler
from portbench.harness.yardstick import bound, f32_accurate_peak, forward_macs, peaks, percentile
from portbench.reference import compare
from portbench.reference import mlp as reference

#: seconds the service may take to come up (the first run in a checkout
#: builds the kernel library)
BOOT_TIMEOUT_S = 900.0
#: seconds the service's processes flush their metrics within
FLUSH_WAIT_S = 0.6
#: the served checkpoint's date (any fixed date: its key)
MODEL_DATE = date(2026, 7, 1)
LAUNCHER = Path(__file__).resolve().parent / "serve_launch.py"
#: the kernel launches timed alone under the device trace
KERNEL_LAUNCHES = 30
#: the supervisor's log line naming the front ends' and the dispatcher's pids
PIDS = re.compile(r"pids \[([\d, ]*)\]\); dispatcher pid\(s\) \[(\d+)\]")


def make_layers(seed: int, widths: tuple) -> list:
    """He-normal weights from ``seed`` (the final layer's halved, which
    keeps the outputs inside the sanity band), zero biases: float32 on
    the host."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    layers = []
    for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
        w = torch.randn(fan_in, fan_out, generator=gen) * (2.0 / fan_in) ** 0.5
        if i == len(widths) - 2:
            w = w * 0.5
        layers.append((w, torch.zeros(fan_out)))
    return layers


def sanity_band(seed: int, x_range) -> dict:
    """The train stage's band (the label range widened by half the range
    on each side) over a day of labels of the drift generator's form,
    ``1 + 0.5 x + 10 N(0, 1)``."""
    rng = np.random.default_rng([seed, 2**31])
    x = rng.uniform(*x_range, 1440)
    y = 1.0 + 0.5 * x + 10.0 * rng.normal(size=1440)
    lo, hi = float(y.min()), float(y.max())
    return {"lo": lo - 0.5 * (hi - lo), "hi": hi + 0.5 * (hi - lo)}


def served_params(layers: list, cfg: dict, device: str = "cpu") -> dict:
    """The served model's parameters in the port's layout: the layers and
    the configuration's scaler."""
    import torch

    s, n = cfg["scaler"], cfg["features"]
    return {"net": {"layers": [{"w": w.to(device), "b": b.to(device)} for w, b in layers]},
            "scaler": {"x_mean": torch.full((n,), s["x_mean"], device=device),
                       "x_std": torch.full((n,), s["x_std"], device=device),
                       "y_mean": torch.tensor(s["y_mean"], device=device),
                       "y_std": torch.tensor(s["y_std"], device=device)}}


def write_checkpoint(store_dir: Path, layers: list, cfg: dict, band: dict) -> str:
    from bodywork_tpu_torch.models.checkpoint import save_model, save_model_bytes
    from bodywork_tpu_torch.models.mlp import MLPConfig, MLPRegressor
    from bodywork_tpu_torch.registry.manager import ModelRegistry
    from bodywork_tpu_torch.registry.records import register_candidate
    from bodywork_tpu_torch.store import open_store

    model = MLPRegressor(MLPConfig(hidden=tuple(cfg["hidden"])), served_params(layers, cfg))
    store = open_store(str(store_dir))
    data = save_model_bytes(model)
    key = save_model(store, model, MODEL_DATE, data=data)
    register_candidate(store, key, day=MODEL_DATE, model_bytes=data, prediction_bounds=band)
    ModelRegistry(store).promote(key, day=MODEL_DATE)
    return key


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def scrape(port: int) -> dict:
    """``/metrics`` as ``{name: value}``, each name's label sets summed."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        text = r.read().decode()
    out: dict = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, _sep, value = line.rpartition(" ")
        name = name_labels.split("{", 1)[0]
        try:
            out[name] = out.get(name, 0.0) + float(value)
        except ValueError:
            continue
    return out


def healthy(port: int) -> bool:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
            return r.status == 200
    except OSError:
        return False


def log_json(log_text: str, marker: str) -> dict | None:
    """The JSON document after the last ``marker`` in the service's log."""
    at = log_text.rfind(marker)
    if at < 0:
        return None
    line = log_text[at + len(marker):].split("\n", 1)[0]
    try:
        return json.loads(line)
    except ValueError:
        return None


def bucket_rows(rows: int) -> int:
    """The rows the kernel runs for a request of ``rows`` rows: the
    smallest bucket of the ladder the service warms (the port's
    default, which the cell does not change) that holds them."""
    from bodywork_tpu_torch.serve.predictor import DEFAULT_BUCKETS

    return next((b for b in DEFAULT_BUCKETS if b >= rows), max(DEFAULT_BUCKETS))


def kernel_seconds(layers: list, cfg: dict, bucket: int, X) -> tuple[float, str]:
    """The port's f32 kernel alone at ``bucket`` rows on the served
    weights: its device seconds a launch over 30 launches under a device
    trace, after 3 untraced, and the kernel's name. The request's rows
    fill the bucket, repeated."""
    import torch

    from bodywork_tpu_torch.ops.mlp_kernel import make_kernel_mlp_apply

    apply = make_kernel_mlp_apply(served_params(layers, cfg, "cuda"), "cuda")
    rows = torch.as_tensor(X).reshape(-1, cfg["features"])
    Xb = rows.repeat((bucket + len(rows) - 1) // len(rows), 1)[:bucket].contiguous().cuda()
    for _ in range(3):
        apply.launch(Xb)
    torch.cuda.synchronize()
    trace = DeviceTrace().start()
    for _ in range(KERNEL_LAUNCHES):
        apply.launch(Xb)
    trace.stop()
    events = [e for e in trace.events if e[2] > trace.t0]
    names = {e[0] for e in events}
    if len(events) != KERNEL_LAUNCHES or len(names) != 1:
        raise RuntimeError(f"the trace of {KERNEL_LAUNCHES} kernel launches holds "
                           f"{len(events)} device events of {sorted(names)}")
    return sum(e[2] - e[1] for e in events) / KERNEL_LAUNCHES, names.pop()


def run(ctx) -> Outcome:
    run_dir = Path(tempfile.mkdtemp(prefix="portbench-serve-"))
    try:
        return _run(ctx, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _start_service(ctx, run_dir: Path, port: int):
    trf = ctx.traffic
    env = dict(os.environ)
    (run_dir / "tmp").mkdir()
    env.update({"TMPDIR": str(run_dir / "tmp"), procs.RUN_ENV: str(os.getpid())})
    cmd = [sys.executable, str(LAUNCHER), "serve", "--store", str(run_dir / "store"),
           "--host", "127.0.0.1", "--port", str(port), "--engine", ctx.config["engine"],
           "--frontends", str(trf["frontends"]), "--server-engine", trf["server_engine"],
           "--metrics", "--transport", trf["transport"], "--reload-interval", "0",
           "--device", ctx.device]
    log = open(run_dir / "serve.log", "wb")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                            cwd=run_dir)
    log.close()
    deadline = time.monotonic() + BOOT_TIMEOUT_S
    while not (PIDS.search((run_dir / "serve.log").read_text(errors="replace"))
               and healthy(port)):
        if proc.poll() is not None or time.monotonic() > deadline:
            text = (run_dir / "serve.log").read_text(errors="replace")
            _stop_service(proc)
            procs.check_processes()
            raise RuntimeError(f"the service did not come up:\n{text[-4000:]}")
        time.sleep(0.1)
    return proc


def _stop_service(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=30)


def _run(ctx, run_dir: Path) -> Outcome:
    import torch

    cfg, trf = ctx.config, ctx.traffic
    widths = (cfg["features"], *cfg["hidden"], 1)
    marks = {"imports": time.monotonic() - ctx.start}
    layers = make_layers(ctx.seed, widths)
    band = sanity_band(ctx.seed, cfg["x_range"])
    write_checkpoint(run_dir / "store", layers, cfg, band)
    port = free_port()
    marks["checkpoint"] = time.monotonic() - ctx.start
    # the shards start and draw their bodies while the service boots
    shards = []
    mp = multiprocessing.get_context("spawn")
    for i in range(trf["shards"]):
        parent_end, child_end = mp.Pipe()
        params = {"host": "127.0.0.1", "port": port, "path": trf["path"],
                  "seed": ctx.seed, "shard": i, "pool": trf["pool"], "rows": trf["rows"],
                  "features": cfg["features"], "x_range": cfg["x_range"],
                  "connections": trf["connections"], "warmup": trf["warmup"]}
        p = mp.Process(target=shard_mod.shard_main, args=(child_end, params), daemon=True)
        p.start()
        child_end.close()
        shards.append((p, parent_end))
    fault = None
    results = []
    proc = None
    try:
        proc = _start_service(ctx, run_dir, port)
        marks["service"] = time.monotonic() - ctx.start
        log_text = (run_dir / "serve.log").read_text(errors="replace")
        pids = PIDS.search(log_text)
        frontends = [int(p) for p in pids.group(1).split(",") if p.strip()]
        dispatcher = int(pids.group(2))
        ready = log_json(log_text, "dispatcher ready: ") or {}
        for _p, pipe in shards:
            pipe.send("connect")
        for _p, pipe in shards:
            if not pipe.poll(300):
                raise RuntimeError("a client shard did not warm up in 300 s")
            msg = pipe.recv()
            if msg != "ready":
                raise RuntimeError(f"client shard failed: {msg}")
        marks["shards"] = time.monotonic() - ctx.start
        before = sampler = None
        if ctx.trace:
            sampler = UtilizationSampler().start()
            time.sleep(FLUSH_WAIT_S)
            before = scrape(port)
        watched = {"supervisor": [proc.pid], "dispatcher": [dispatcher],
                   "frontends": frontends}
        t_start = time.monotonic() + 0.2
        t_end = t_start + ctx.seconds
        setup_s = t_start - ctx.start
        for _p, pipe in shards:
            pipe.send((t_start, t_end))
        time.sleep(max(0.0, t_start - time.monotonic()))
        cpu0 = {k: [procs.cpu_seconds(p) for p in v] for k, v in watched.items()}
        time.sleep(max(0.0, t_end - time.monotonic()))
        cpu1 = {k: [procs.cpu_seconds(p) for p in v] for k, v in watched.items()}
        if sampler is not None:
            sampler.stop()
        for _p, pipe in shards:
            if not pipe.poll(shard_mod.DRAIN_S + 30):
                raise RuntimeError("a client shard sent no result")
            msg = pipe.recv()
            if "error" in msg:
                raise RuntimeError(f"client shard failed: {msg['error']}")
            results.append(msg)
        time.sleep(FLUSH_WAIT_S)
        after = scrape(port)
    finally:
        code = _stop_service(proc) if proc is not None else None
        for p, pipe in shards:
            pipe.close()  # a shard still waiting on the driver ends
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        left = procs.check_processes()
    log_text = (run_dir / "serve.log").read_text(errors="replace")
    exiting = log_json(log_text, "dispatcher exiting: ") or {}
    if left:
        fault = "processes left behind: " + "; ".join(
            f"{p['pid']} {p['cmdline']}" for p in left)
    if ctx.device != "cpu":
        launched = (exiting.get("launches", {}).get("kernel", 0)
                    - ready.get("launches", {}).get("kernel", 0))
        if launched <= 0:
            fault = fault or "the dispatcher launched no f32 kernel: not the kernel path"

    # every distinct answer, judged by the reference on the card
    device = ctx.device
    ref_layers = [(w.to(device), b.to(device)) for w, b in layers]
    s = cfg["scaler"]
    scaler = {k: torch.tensor(float(v), device=device) for k, v in s.items()}
    gaps, judged = [], []
    pool_rows_0 = shard_mod.pool_rows(ctx.seed, 0, trf["pool"], trf["rows"], cfg["features"],
                                      cfg["x_range"])[0]
    with reference.precision(tf32=False):
        for i, res in enumerate(results):
            pool = shard_mod.pool_rows(ctx.seed, i, trf["pool"], trf["rows"], cfg["features"],
                                       cfg["x_range"])
            ok = []
            for body, payload in res["answers"]:
                try:
                    pred = np.asarray(json.loads(payload)["predictions"], np.float64)
                except (ValueError, KeyError):
                    pred = np.full(1, np.nan)
                X = torch.as_tensor(pool[body], device=device)
                ref = reference.apply(ref_layers, scaler, X).double().cpu().numpy()
                gap = compare.answer_gap(pred, ref)
                gaps.append(gap if np.isfinite(gap) else float("inf"))
                ok.append(gap <= cfg["limits"]["serve_closed_loop"]["answer_gap"])
            judged.append(np.array(ok + [False], dtype=bool))  # id -1: no answer

    sends = np.concatenate([r["send"] for r in results])
    dones = np.concatenate([r["done"] for r in results])
    statuses = np.concatenate([r["status"] for r in results])
    correct = np.concatenate([j[r["answer"]] for j, r in zip(judged, results)])
    in_window = dones <= t_end
    rows_ok = int(trf["rows"] * np.count_nonzero(correct & in_window))
    latency_ms = np.where(correct, (dones - sends) * 1e3, np.inf)
    name = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    card = peaks(name)
    limit = cfg["limits"]["serve_closed_loop"]["answer_gap"]
    checks = {
        "answer_gap": {"value": max(gaps) if gaps else float("inf"), "limit": limit},
        "wrong_answers": {"value": int(np.count_nonzero((statuses == 200) & ~correct)),
                          "limit": 0},
        "unanswered": {"value": int(np.count_nonzero(statuses != 200)), "limit": 0},
    }
    cpu = {k: sum((b or 0.0) - (a or 0.0) for a, b in zip(cpu0[k], cpu1[k])) for k in cpu0}
    cpu["shards"] = sum(r["cpu_s"] for r in results)
    bucket = bucket_rows(trf["rows"])
    layer = {"kind": "serve", "window_s": ctx.seconds, "rows_ok": rows_ok,
             "macs_per_row": forward_macs(1, widths), "peak_flops": f32_accurate_peak(card),
             "kernel_bound_s": bound(bucket, widths, "kernel", card)[0] / 1e3,
             "metrics_before": before, "metrics_after": after, "cpu_s": cpu}
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": name, "count": 1,
           "memory_peak_bytes": int(exiting.get("max_memory_allocated", 0))}
    sanity = after.get("bodywork_tpu_serve_sanity_violations_total", 0.0)
    notes = [
        f"machine: cpu_count {os.cpu_count()}; card {name}; power limit "
        f"{card_power_limit() if device != 'cpu' else 'n/a'}",
        f"window: {len(sends)} requests of {trf['rows']} rows, {rows_ok} rows answered "
        f"correctly in {ctx.seconds} s; setup {setup_s:.3f} s; kernel bucket {bucket}; "
        f"service exit {code}; p95 latency "
        f"{percentile(latency_ms.tolist(), 95.0):.3f} ms",
        "set-up, seconds from the process's start to the end of each step: " + ", ".join(
            f"{k} {v:.3f}" for k, v in marks.items()),
        "cpu seconds over the window: " + ", ".join(
            f"{k} {v:.3f} ({v / ctx.seconds:.3f} of a core)" for k, v in cpu.items()),
        "requests answered in each second of the window: " + " ".join(
            str(int(n)) for n in np.histogram(dones - t_start, bins=int(ctx.seconds),
                                              range=(0, int(ctx.seconds)))[0]),
        f"bodywork_tpu_serve_sanity_violations_total {sanity} (band {band['lo']:.3f} .. "
        f"{band['hi']:.3f})",
    ]
    if ctx.trace:
        utilization = sampler.between(t_start, t_end)
        if device != "cpu" and not utilization:
            fault = fault or "no utilization sample of the card arrived in the window"
        busy = (sum(utilization) / len(utilization) / 100.0 if utilization else 0.0)
        dev["busy_s"], dev["window_s"] = busy * ctx.seconds, float(ctx.seconds)
        if device != "cpu":
            layer["kernel_s"], kernel_name = kernel_seconds(layers, cfg, bucket, pool_rows_0)
            notes.append(f"kernel alone at {bucket} rows, device-traced: {kernel_name} "
                         f"{layer['kernel_s']!r} s a launch")
    return Outcome(
        e2e={"score_rows_per_s": rows_ok / ctx.seconds, "setup_s": setup_s},
        layer=layer, attempted=len(sends),
        failed=int(np.count_nonzero(~correct)), checks=checks, device=dev,
        notes=notes, fault=fault)
