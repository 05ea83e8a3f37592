"""The port's ``serve`` command line against the JAX package's: the same
argv and environment parse to the same coalescer, front-end, admission
and bucket values; the serve stage reads the same pod knobs; an explicit
``--batch-window-ms 0`` turns coalescing off; and SIGTERM drains a live
service to exit 143."""
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from datetime import date
from pathlib import Path
from unittest.mock import patch

import numpy as np
import pytest
import torch

from bodywork_tpu.cli import build_parser as jax_build_parser
from bodywork_tpu.pipeline import stages as jax_stages
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.pipeline import stages
from bodywork_tpu_torch.utils.shutdown import SIGTERM_EXIT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SHARED = ("buckets", "batch_window_ms", "batch_max_rows", "server_engine", "max_pending",
          "retry_after_max_s", "dtype", "host", "port", "mesh_data", "mesh_model")
ENV = ("BODYWORK_TPU_BATCH_WINDOW_MS", "BODYWORK_TPU_BATCH_MAX_ROWS",
       "BODYWORK_TPU_SERVER_ENGINE", "BODYWORK_TPU_MAX_PENDING",
       "BODYWORK_TPU_RETRY_AFTER_MAX_S", "BODYWORK_TPU_SERVE_DTYPE", "BODYWORK_TPU_BUCKETS",
       "BODYWORK_TPU_MESH_DATA", "BODYWORK_TPU_MESH_MODEL")


def _parse(build, argv, env):
    clean = {k: v for k, v in os.environ.items() if k not in ENV}
    with patch.dict(os.environ, {**clean, **env}, clear=True):
        try:
            args = build().parse_args(["serve", "--store", "/tmp/s", *argv])
        except SystemExit as exc:
            return ("exit", exc.code)
    return {k: getattr(args, k) for k in SHARED}


@pytest.mark.parametrize("argv,env", [
    ([], {}),
    (["--batch-window-ms", "1.5", "--batch-max-rows", "32"], {}),
    (["--batch-window-ms", "0"], {"BODYWORK_TPU_BATCH_WINDOW_MS": "2.5"}),
    (["--batch-window-ms", "-1"], {}),
    ([], {"BODYWORK_TPU_BATCH_WINDOW_MS": "2.5", "BODYWORK_TPU_BATCH_MAX_ROWS": "48"}),
    ([], {"BODYWORK_TPU_BATCH_WINDOW_MS": "2ms", "BODYWORK_TPU_BATCH_MAX_ROWS": "-5"}),
    ([], {"BODYWORK_TPU_BATCH_WINDOW_MS": "nan"}),
    (["--batch-max-rows", "0"], {}),
    (["--server-engine", "aio", "--max-pending", "8", "--retry-after-max-s", "4"], {}),
    ([], {"BODYWORK_TPU_SERVER_ENGINE": "aio", "BODYWORK_TPU_MAX_PENDING": "16",
          "BODYWORK_TPU_RETRY_AFTER_MAX_S": "2.5"}),
    ([], {"BODYWORK_TPU_SERVER_ENGINE": "uvloop", "BODYWORK_TPU_MAX_PENDING": "0",
          "BODYWORK_TPU_RETRY_AFTER_MAX_S": "0.5"}),
    (["--server-engine", "thread"], {"BODYWORK_TPU_SERVER_ENGINE": "aio"}),
    (["--server-engine", "gevent"], {}),
    (["--max-pending", "0"], {}),
    (["--buckets", "1,8,64"], {}),
    (["--buckets", "64, 8"], {"BODYWORK_TPU_BUCKETS": "1,2"}),
    (["--buckets", "0,8"], {}),
    (["--buckets", "a,b"], {}),
    (["--dtype", "int8", "--host", "127.0.0.1", "--port", "5999"], {}),
    ([], {"BODYWORK_TPU_SERVE_DTYPE": "bfloat16"}),
    (["--mesh-data", "4", "--mesh-model", "2"], {}),
    ([], {"BODYWORK_TPU_MESH_DATA": "4", "BODYWORK_TPU_MESH_MODEL": "2"}),
    ([], {"BODYWORK_TPU_MESH_DATA": "0", "BODYWORK_TPU_MESH_MODEL": "-2"}),
    (["--mesh-data", "2"], {"BODYWORK_TPU_MESH_DATA": "two", "BODYWORK_TPU_MESH_MODEL": "x"}),
])
def test_serve_parses_like_jax(argv, env):
    # repr: a NaN window compares equal to itself
    assert repr(_parse(cli.build_parser, argv, env)) == repr(_parse(jax_build_parser, argv, env))


@pytest.mark.parametrize("env", [
    {},
    {"BODYWORK_TPU_SERVER_ENGINE": "aio", "BODYWORK_TPU_MAX_PENDING": "9",
     "BODYWORK_TPU_RETRY_AFTER_MAX_S": "3", "BODYWORK_TPU_SERVE_DTYPE": "int8"},
    {"BODYWORK_TPU_SERVER_ENGINE": "nope", "BODYWORK_TPU_MAX_PENDING": "x",
     "BODYWORK_TPU_RETRY_AFTER_MAX_S": "0.2", "BODYWORK_TPU_SERVE_DTYPE": "fp4"},
    {"BODYWORK_TPU_MAX_PENDING": "0", "BODYWORK_TPU_RETRY_AFTER_MAX_S": "nan"},
    {"BODYWORK_TPU_BATCH_WINDOW_MS": "0", "BODYWORK_TPU_BATCH_MAX_ROWS": "32",
     "BODYWORK_TPU_BUCKETS": "1,8"},
    {"BODYWORK_TPU_BATCH_WINDOW_MS": "-1", "BODYWORK_TPU_BATCH_MAX_ROWS": "0",
     "BODYWORK_TPU_BUCKETS": "1,-8"},
    {"BODYWORK_TPU_BATCH_WINDOW_MS": "2.5", "BODYWORK_TPU_BUCKETS": " 4096 ,256,"},
    {"BODYWORK_TPU_MESH_DATA": "4", "BODYWORK_TPU_MESH_MODEL": "2"},
    {"BODYWORK_TPU_MESH_DATA": "0", "BODYWORK_TPU_MESH_MODEL": "-2"},
    {"BODYWORK_TPU_MESH_DATA": "two", "BODYWORK_TPU_MESH_MODEL": "x"},
])
def test_the_serve_stage_reads_the_pod_knobs_like_jax(env):
    clean = {k: v for k, v in os.environ.items() if k not in ENV}
    with patch.dict(os.environ, {**clean, **env}, clear=True):
        assert repr(stages._serve_env_knobs()) == repr(jax_stages._serve_env_knobs())
        assert (repr(stages._serve_tuned_env_knobs())
                == repr(jax_stages._serve_tuned_env_knobs()[:3]))


@pytest.mark.parametrize("argv,want_window", [
    ([], None), (["--batch-window-ms", "0"], 0.0), (["--batch-window-ms", "-3"], None),
    (["--batch-window-ms", "2"], 2.0),
])
def test_cmd_serve_hands_the_knobs_to_the_service(monkeypatch, argv, want_window):
    """None unset, 0 off (explicit), negative degrades to unset; the rest
    pass through to ``serve_latest_model``."""
    seen = {}
    monkeypatch.setattr("bodywork_tpu_torch.serve.serve_latest_model",
                        lambda store, **kw: seen.update(kw))
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    rc = cli.main(["serve", "--store", "/tmp/s", "--device", "cpu", "--server-engine", "aio",
                   "--max-pending", "8", "--batch-max-rows", "16", *argv])
    assert rc == 0
    assert seen["batch_window_ms"] == want_window and seen["batch_max_rows"] == 16
    assert seen["server_engine"] == "aio" and seen["max_pending"] == 8
    assert seen["block"] is True and seen["device"] == "cpu"


def _store_with_a_model(root: Path) -> None:
    from bodywork_tpu_torch.models import LinearRegressor, save_model
    from bodywork_tpu_torch.store import FilesystemStore

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 100, 300).astype(np.float32)
    model = LinearRegressor().fit(X, (1.0 + 0.5 * X).astype(np.float32), device="cpu")
    save_model(FilesystemStore(root), model, date(2026, 7, 1))


@pytest.mark.parametrize("engine", ["thread", "aio"])
def test_sigterm_drains_a_live_service_and_exits_143(tmp_path, engine):
    """``cli serve`` in a subprocess: it answers, then SIGTERM closes
    admission, flushes the coalescer and exits 143 well inside the grace
    deadline."""
    _store_with_a_model(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "bodywork_tpu_torch.cli", "serve", "--store", str(tmp_path),
         "--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--server-engine", engine,
         "--batch-window-ms", "2", "--max-pending", "16"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout],
                     daemon=True).start()
    try:
        url, seen = None, []
        deadline = time.monotonic() + 90
        while url is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                continue
            seen.append(line)
            if "listening on http://" in line:
                url = line.rsplit("listening on ", 1)[1].strip()
        assert url, "".join(seen)
        req = urllib.request.Request(url, data=b'{"X": 50}', method="POST",
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert json.loads(resp.read())["prediction"] == pytest.approx(26.0, abs=0.5)
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        assert time.monotonic() - t0 < 15
        time.sleep(0.2)  # the reader thread drains the pipe
        while not lines.empty():
            seen.append(lines.get())
        assert proc.returncode == SIGTERM_EXIT, "".join(seen)
        assert "draining scoring service" in "".join(seen)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- cli trace, against dumps the JAX package wrote ------------------------------

def _jax_dumps(root) -> list[dict]:
    """Two flight-record dumps written by the JAX package: the traces of
    sampled requests through its app (the second dump holds them all)."""
    from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
    from bodywork_tpu.obs import tracing as jax_tracing
    from bodywork_tpu.serve import create_app as jax_create_app
    from bodywork_tpu.store import FilesystemStore as JaxStore

    X = np.linspace(0, 100, 50, dtype=np.float32)
    app = jax_create_app(JaxLinearRegressor().fit(X, 2 * X), date(2026, 7, 1),
                         buckets=(1, 8), model_key="models/m.npz")
    with jax_tracing.configured_tracing(1.0, seed=4) as tracer:
        client = app.test_client()
        for i in range(3):
            client.post("/score/v1", json={"X": i})
        client.post("/score/v1/batch", json={"X": [1.0, 2.0]})
        traces = tracer.recorder.snapshot()
    store = JaxStore(root)
    for n, verdict in ((2, "abort"), (4, "promote")):
        jax_tracing.write_flight_record(store, jax_tracing.flight_record_doc(
            traces[:n], verdict, "slo", canary_key="models/c.npz"))
    return traces


def _both_clis(argv, capsys) -> tuple:
    """``argv`` through the port's cli and the JAX package's: (code, stdout)
    of each."""
    from bodywork_tpu.cli import main as jax_main

    code = cli.main(argv)
    out = capsys.readouterr().out
    jax_code = jax_main(argv)
    return (code, out), (jax_code, capsys.readouterr().out)


def test_cli_trace_show_and_tail_read_jax_dumps_as_jax_does(tmp_path, capsys):
    traces = _jax_dumps(tmp_path / "s")
    store = str(tmp_path / "s")
    for argv in (["trace", "show", "--store", store, traces[3]["trace_id"][:10]],
                 ["trace", "show", "--store", store, traces[0]["trace_id"]],
                 ["trace", "tail", "--store", store],
                 ["trace", "tail", "--store", store, "-n", "1", "--traces", "2"]):
        port, ref = _both_clis(argv, capsys)
        assert port == ref and port[0] == 0, argv
    shown = json.loads(_both_clis(["trace", "show", "--store", store,
                                   traces[1]["trace_id"]], capsys)[0][1])
    assert shown["trace"] == traces[1] and shown["dump"].startswith("obs/flightrec/flight-")


def test_cli_trace_export_renders_jax_dumps_as_jax_does(tmp_path, capsys):
    traces = _jax_dumps(tmp_path / "s")
    store = str(tmp_path / "s")
    for extra in ([], ["--trace-id", traces[2]["trace_id"][:8]]):
        out = {}
        for name in ("port", "jax"):
            path = tmp_path / f"{name}{len(extra)}.json"
            argv = ["trace", "export", "--store", store, "--chrome", str(path), *extra]
            if name == "port":
                assert cli.main(argv) == 0
            else:
                from bodywork_tpu.cli import main as jax_main

                assert jax_main(argv) == 0
            out[name] = path.read_bytes()
            assert capsys.readouterr().out.strip() == str(path)
        assert out["port"] == out["jax"]
        events = json.loads(out["port"])["traceEvents"]
        assert {"parse", "device-dispatch", "serialize"} <= {e["name"] for e in events}


@pytest.mark.parametrize("argv_tail,want", [
    (["show", "f" * 32], 9), (["tail"], 9), (["export", "--chrome", "OUT"], 9),
])
def test_cli_trace_exit_codes_are_jaxs(tmp_path, capsys, argv_tail, want):
    empty = str(tmp_path / "empty")
    argv = ["trace", *[a.replace("OUT", str(tmp_path / "o.json")) for a in argv_tail],
            "--store", empty]
    port, ref = _both_clis(argv, capsys)
    assert port[0] == ref[0] == want
    # a store path that is a file is an error (1), not an absent trace
    blocker = tmp_path / "file"
    blocker.write_text("x")
    argv = ["trace", *[a.replace("OUT", str(tmp_path / "o.json")) for a in argv_tail],
            "--store", str(blocker)]
    assert _both_clis(argv, capsys)[0][0] == 1
    if argv_tail[0] == "export":  # and a dump missing the asked-for trace is absent
        _jax_dumps(tmp_path / "s")
        argv = ["trace", "export", "--chrome", str(tmp_path / "o.json"), "--trace-id",
                "f" * 32, "--store", str(tmp_path / "s")]
        port, ref = _both_clis(argv, capsys)
        assert port[0] == ref[0] == 9
