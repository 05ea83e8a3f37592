"""The pod entry points of the port's CLI (``run-stage``, ``wait-for``,
``deploy``, ``--spec``) against the JAX commands, and a 2-day linear loop
run as the k8s manifests run it: every stage its own ``run-stage``
process, gated by ``wait-for``, the test stage scoring a ``run-stage``
serve process over HTTP."""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from datetime import date, timedelta
from pathlib import Path

import pytest
import torch
import yaml

from bodywork_tpu_torch import cli
from bodywork_tpu_torch.pipeline import default_pipeline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
_ENV = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _jax_main(argv):
    from bodywork_tpu.cli import main

    return main(argv)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _port_cli(*argv, **kw) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "bodywork_tpu_torch.cli", *argv], cwd=ROOT,
                          env=_ENV, capture_output=True, text=True, timeout=300, **kw)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_deploy_writes_manifests_and_refuses_unbuildable_tags(tmp_path, package, capsys):
    main = cli.main if package == "port" else _jax_main
    out = tmp_path / "k8s"
    # derived per-stage tags without their build contexts: refused before
    # anything is written, unless forced
    assert main(["deploy", "--out", str(out)]) == 1
    assert not out.exists()
    assert main(["deploy", "--out", str(out), "--force"]) == 0
    assert (out / "00-namespace.yaml").exists()
    out2 = tmp_path / "k8s2"
    assert main(["deploy", "--out", str(out2), "--emit-images", str(tmp_path / "img")]) == 0
    files = sorted(p.name for p in out2.iterdir())
    assert "00-namespace.yaml" in files and any("cronjob" in f for f in files)
    assert (tmp_path / "img" / "build.sh").exists()
    printed = capsys.readouterr().out.split()
    assert {str(p) for p in out2.iterdir()} <= set(printed)


def test_deploy_writes_the_same_files_as_the_jax_command_and_they_load_back(tmp_path):
    from bodywork_tpu_torch.pipeline import _yaml, generate_manifests

    for package, main in (("port", cli.main), ("jax", _jax_main)):
        assert main(["deploy", "--out", str(tmp_path / package), "--model", "mlp",
                     "--emit-images", str(tmp_path / f"{package}-img")]) == 0
    port_files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_files == sorted(p.name for p in (tmp_path / "jax").iterdir())
    docs = generate_manifests(default_pipeline("mlp"))
    for name in port_files:
        text = (tmp_path / "port" / name).read_text()
        assert _yaml.load(text) == yaml.safe_load(text) == docs[name]
    assert sorted(p.name for p in (tmp_path / "port-img").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax-img").iterdir())


def test_deploy_spec_file_precedence(tmp_path):
    """An explicit --spec wins over --model/--mode, for deploy and for the
    pods' run-stage."""
    spec_file = tmp_path / "pipeline.yaml"
    spec_file.write_text(default_pipeline(model_type="mlp").to_yaml())
    out = tmp_path / "k8s"
    assert cli.main(["deploy", "--out", str(out), "--spec", str(spec_file), "--model", "linear",
                     "--emit-images", str(tmp_path / "images")]) == 0
    cm = yaml.safe_load((out / "00-pipeline-spec-configmap.yaml").read_text())
    assert "model_type: mlp" in cm["data"]["pipeline.yaml"]
    for command in ("run-stage", "run-day", "run-sim"):
        argv = [command, "--store", str(tmp_path / "s"), "--spec", str(spec_file),
                "--mlp-hidden", "8", "--model", "linear"]
        argv += {"run-stage": ["--stage", "stage-1-train-model"], "run-sim": ["--days", "1"]
                 }.get(command, [])
        args = cli.build_parser().parse_args(argv)
        spec = cli._pipeline_spec(args)
        assert spec.stages["stage-1-train-model"].args == {"model_type": "mlp"}


def test_spec_file_round_trips_nondefault_choices(tmp_path):
    out = tmp_path / "k8s"
    assert cli.main(["deploy", "--out", str(out), "--model", "mlp", "--mode", "single",
                     "--emit-images", str(tmp_path / "images")]) == 0
    from bodywork_tpu_torch.pipeline import PipelineSpec

    cm = yaml.safe_load((out / "00-pipeline-spec-configmap.yaml").read_text())
    loaded = PipelineSpec.from_yaml(cm["data"]["pipeline.yaml"])
    assert loaded.stages["stage-1-train-model"].args["model_type"] == "mlp"
    assert loaded.stages["stage-4-test-model-scoring-service"].args["mode"] == "single"


def test_run_stage_single_stage_matches_the_jax_command(tmp_path):
    """The generate stage writes tomorrow's dataset, the JAX command's day
    (``X`` bit-equal, ``y`` within the few ulps XLA's ``log1p`` and
    ``sin`` put between them, tests/test_torch_prng.py); an unknown stage
    exits 1."""
    import numpy as np

    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX

    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["run-stage", "--stage", "stage-3-generate-next-dataset", "--date", "2026-01-01"]
    assert cli.main([*argv, "--store", port, "--device", "cpu"]) == 0
    assert _jax_main([*argv, "--store", jax]) == 0
    history = open_store(port).history(DATASETS_PREFIX)
    assert [d for _k, d in history] == [date(2026, 1, 2)]
    key = history[0][0]
    ours, theirs = (np.loadtxt(Path(root) / key, delimiter=",", skiprows=1,
                               usecols=(1, 2)) for root in (port, jax))
    assert ours.shape == theirs.shape and np.array_equal(ours[:, 1], theirs[:, 1])
    np.testing.assert_allclose(ours[:, 0], theirs[:, 0], rtol=1e-6, atol=1e-5)
    assert cli.main(["run-stage", "--stage", "stage-9-nope", "--store", port,
                     "--device", "cpu"]) == 1
    assert _jax_main(["run-stage", "--stage", "stage-9-nope", "--store", jax]) == 1


def test_run_stage_refuses_a_device_stage_without_a_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["run-stage", "--stage", "stage-3-generate-next-dataset",
                  "--store", str(tmp_path / "s"), "--date", "2026-01-01"])


def test_wait_for_gates_as_the_jax_command_does(tmp_path, capsys):
    """The same store, the same gates, the same exit codes and output in
    both packages (tests/test_cli.py:194, tests/test_pipeline.py:717)."""
    store = str(tmp_path / "s")
    fast = ["--timeout", "0.2", "--poll-interval", "0.05"]

    def result(out: str) -> list[str]:
        # the JAX logger writes to stdout, the port's to stderr
        return [line for line in out.splitlines() if " - ERROR - " not in line]

    def both(*argv):
        capsys.readouterr()
        got = cli.main(["wait-for", "--store", store, *argv])
        port_out = capsys.readouterr().out
        want = _jax_main(["wait-for", "--store", store, *argv])
        assert got == want and result(port_out) == result(capsys.readouterr().out)
        return got

    assert both("--model", *fast) == 1
    assert both("--dataset", *fast) == 1
    assert cli.main(["generate", "--store", store, "--date", "2026-01-01", "--device", "cpu"]) == 0
    assert both("--dataset", "--timeout", "5") == 0
    assert cli.main(["train", "--store", store, "--device", "cpu"]) == 0
    assert both("--model", "--dataset", "--timeout", "5") == 0
    assert both("--dataset-newer-than-model", *fast) == 1
    assert cli.main(["generate", "--store", store, "--date", "2026-01-02", "--device", "cpu"]) == 0
    assert both("--dataset-newer-than-model", "--timeout", "5") == 0
    capsys.readouterr()
    # a health URL: nobody listening -> timeout; a live one -> open
    dead = f"http://127.0.0.1:{_free_port()}/healthz"
    assert both("--service-url", dead, *fast) == 1


def test_wait_for_service_url_opens_on_a_live_service_and_imports_no_torch(tmp_path):
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    import threading

    codes = {"/healthz": 200, "/down": 503}

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(codes.get(self.path, 404))
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        code = ("import sys; from bodywork_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
                "sys.exit(rc if 'torch' not in sys.modules else 99)")
        for path, rc in (("/healthz", 0), ("/down", 1)):
            proc = subprocess.run(
                [sys.executable, "-c", code, "wait-for", "--store", str(tmp_path / "s"),
                 "--service-url", base + path, "--timeout", "0.3", "--poll-interval", "0.05"],
                cwd=ROOT, env=_ENV, capture_output=True, text=True, timeout=120)
            assert proc.returncode == rc, proc.stderr
            assert ("conditions met" in proc.stdout) == (rc == 0)
    finally:
        server.shutdown()


def test_run_stage_tags_actual_stage_name(tmp_path, monkeypatch):
    import types

    calls = []
    fake = types.ModuleType("sentry_sdk")
    fake.init = lambda dsn, **kw: calls.append(("init", dsn))
    fake.set_tag = lambda k, v: calls.append(("tag", k, v))
    monkeypatch.setitem(sys.modules, "sentry_sdk", fake)
    monkeypatch.setenv("SENTRY_DSN", "https://fake@sentry.invalid/1")
    assert cli.main(["run-stage", "--store", str(tmp_path / "s"), "--stage",
                     "stage-3-generate-next-dataset", "--date", "2026-01-01",
                     "--device", "cpu"]) == 0
    assert ("init", "https://fake@sentry.invalid/1") in calls
    tags = [c for c in calls if c[0] == "tag" and c[1] == "stage"]
    assert tags[0] == ("tag", "stage", "cli-run-stage")
    assert tags[-1] == ("tag", "stage", "stage-3-generate-next-dataset")


def test_error_monitoring_is_a_no_op_without_a_dsn(monkeypatch):
    from bodywork_tpu_torch.utils.errors import init_error_monitoring, tag_stage

    monkeypatch.delenv("SENTRY_DSN", raising=False)
    monkeypatch.setitem(sys.modules, "sentry_sdk", None)  # importing it would fail
    assert init_error_monitoring("x") is False
    tag_stage("x")
    monkeypatch.setenv("SENTRY_DSN", "https://fake@sentry.invalid/1")
    assert init_error_monitoring("x") is False  # set, but no sentry_sdk


# -- the pods' loop ----------------------------------------------------------


def _healthz(url: str) -> dict | None:
    import json

    try:
        with urllib.request.urlopen(url, timeout=2) as resp:
            return json.loads(resp.read())
    except OSError:
        return None


def _start_serve(store: str, spec_file: Path, day: date, port: int) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "bodywork_tpu_torch.cli", "run-stage", "--store", store,
         "--stage", "stage-2-serve-model", "--spec", str(spec_file), "--date", str(day),
         "--device", "cpu"],
        cwd=ROOT, env=_ENV, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def test_a_two_day_loop_of_stage_processes_equals_run_sim(tmp_path):
    """Each day as the manifests run it: train, then the serve Deployment's
    process (gated on a model), generate (gated on /healthz), test (gated
    on the new dataset) scoring the serve process over HTTP; the serve
    process is stopped with SIGTERM, as k8s stops it. The store then holds
    the same keys as ``run-sim`` of the same dates, byte-equal outside
    ``chaos.sim``'s comparison exclusions, its snapshot (written by the
    compaction CronJob's ``compact``) covering the same days.
    ``registry/`` is compared by its
    records' model keys: the stage pods run no promotion gate (the k8s
    topology runs it only inside the daily ``run-day``), so their records
    stay candidates and no alias document is written."""
    from bodywork_tpu_torch.chaos.sim import compare_stores
    from bodywork_tpu_torch.registry import ModelRegistry
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.store.schema import AUDIT_DIGESTS_PREFIX, REGISTRY_PREFIX

    start = date(2026, 3, 1)
    pods, sim = str(tmp_path / "pods"), str(tmp_path / "sim")
    port = _free_port()
    spec_file = tmp_path / "pipeline.yaml"
    spec_file.write_text(default_pipeline("linear", "batch", port=port).to_yaml())
    url = f"http://127.0.0.1:{port}"
    # the operator's seed day
    assert _port_cli("generate", "--store", pods, "--date", str(start),
                     "--device", "cpu").returncode == 0
    common = ["--store", pods, "--spec", str(spec_file), "--device", "cpu"]
    for day in (start, start + timedelta(days=1)):
        assert _port_cli("wait-for", "--store", pods, "--dataset").returncode == 0
        train = _port_cli("run-stage", "--stage", "stage-1-train-model", "--date", str(day),
                          *common)
        assert train.returncode == 0, train.stderr[-2000:]
        assert _port_cli("wait-for", "--store", pods, "--model").returncode == 0
        serve = _start_serve(pods, spec_file, day, port)
        try:
            gate = _port_cli("wait-for", "--store", pods, "--service-url", url + "/healthz",
                             "--poll-interval", "0.2", "--timeout", "120")
            assert gate.returncode == 0, serve.stderr.read() if serve.poll() is not None else ""
            gen = _port_cli("run-stage", "--stage", "stage-3-generate-next-dataset",
                            "--date", str(day), *common)
            assert gen.returncode == 0, gen.stderr[-2000:]
            assert _port_cli("wait-for", "--store", pods,
                             "--dataset-newer-than-model").returncode == 0
            test = _port_cli("run-stage", "--stage", "stage-4-test-model-scoring-service",
                             "--date", str(day), "--scoring-url", url + "/score/v1",
                             "--store", pods, "--spec", str(spec_file))
            assert test.returncode == 0, test.stderr[-2000:]
            health = _healthz(url + "/healthz")
            assert health["model_key"] == f"models/regressor-{day}.npz"
        finally:
            serve.send_signal(signal.SIGTERM)
            rc = serve.wait(timeout=30)
        # no SIGTERM handler, as in the JAX command: the signal ends it
        assert rc == -signal.SIGTERM
    # the compaction CronJob's command, after the day loop
    assert _port_cli("compact", "--store", pods).returncode == 0
    assert cli.main(["run-sim", "--store", sim, "--days", "2", "--date", str(start),
                     "--model", "linear", "--device", "cpu"]) == 0
    pods_store, sim_store = open_store(pods), open_store(sim)
    registry = (REGISTRY_PREFIX, AUDIT_DIGESTS_PREFIX + REGISTRY_PREFIX)
    comparison = compare_stores(sim_store, pods_store, extra_excluded=registry)
    assert comparison["ok"], comparison
    assert comparison["matched"] >= 14
    keys = lambda store: sorted(r["model_key"] for r in ModelRegistry(store).records())
    assert keys(pods_store) == keys(sim_store) == [
        f"models/regressor-{start}.npz", f"models/regressor-{start + timedelta(days=1)}.npz"]


def test_a_serve_stage_process_exits_under_sigterm_as_the_jax_commands_does(tmp_path):
    """Both packages' ``run-stage`` of the serve stage, stopped with
    SIGTERM once serving: the same way out (no handler: the signal)."""
    store = str(tmp_path / "s")
    assert cli.main(["generate", "--store", store, "--date", "2026-01-01", "--device", "cpu"]) == 0
    assert cli.main(["train", "--store", store, "--device", "cpu"]) == 0
    codes = {}
    for package in ("bodywork_tpu_torch", "bodywork_tpu"):
        port = _free_port()
        spec_file = tmp_path / f"{package}.yaml"
        if package == "bodywork_tpu":
            from bodywork_tpu.pipeline import default_pipeline as jax_pipeline

            spec_file.write_text(jax_pipeline(port=port).to_yaml())
        else:
            spec_file.write_text(default_pipeline(port=port).to_yaml())
        argv = [sys.executable, "-m", f"{package}.cli", "run-stage", "--store", store,
                "--stage", "stage-2-serve-model", "--spec", str(spec_file)]
        if package == "bodywork_tpu_torch":
            argv += ["--device", "cpu"]
        proc = subprocess.Popen(argv, cwd=ROOT, env=_ENV, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            deadline = time.monotonic() + 120
            while _healthz(f"http://127.0.0.1:{port}/healthz") is None:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.2)
        finally:
            proc.send_signal(signal.SIGTERM)
            codes[package] = proc.wait(timeout=30)
    assert codes["bodywork_tpu_torch"] == codes["bodywork_tpu"] == -signal.SIGTERM
