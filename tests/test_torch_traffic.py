"""The port's open-loop traffic harness (``bodywork_tpu_torch.traffic``) and
binary row framing against the JAX package's: the same seeded request logs
and log files for Poisson and MMPP arrivals, the same framing bytes and
parses, the same report from canned transports, the same report keys from
a drive of each package's server, JSON and binary answers byte-identical,
and ``cli traffic run`` with the JAX command's flags and exit codes."""
import asyncio
import json
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu import traffic as jax_traffic
from bodywork_tpu.serve import wire as jax_wire
from bodywork_tpu.traffic import runner as jax_runner
from bodywork_tpu_torch import cli, traffic
from bodywork_tpu_torch.serve import wire
from bodywork_tpu_torch.traffic import runner
from bodywork_tpu_torch.traffic.generator import ARRIVAL_PROCESSES, LOG_SCHEMA, TRANSPORTS

torch.set_num_threads(1)

DAY = date(2026, 7, 1)


def _configs():
    for arrival in ("poisson", "mmpp"):
        for seed in (0, 3, 17):
            yield {"rate_rps": 300.0, "duration_s": 1.5, "arrival": arrival,
                   "batch_fraction": 0.2, "batch_rows": 5, "seed": seed}


@pytest.mark.parametrize("knobs", list(_configs()),
                         ids=lambda k: f"{k['arrival']}-seed{k['seed']}")
def test_request_logs_and_their_files_equal_jaxs(knobs, tmp_path):
    config = traffic.TrafficConfig(**knobs)
    jax_config = jax_traffic.TrafficConfig(**knobs)
    log = traffic.generate_request_log(config)
    jax_log = jax_traffic.generate_request_log(jax_config)
    assert [(r.t_s, r.route, r.x) for r in log] == [(r.t_s, r.route, r.x) for r in jax_log]
    assert [r.payload() for r in log] == [r.payload() for r in jax_log]
    assert [r.payload_binary() for r in log] == [r.payload_binary() for r in jax_log]
    traffic.write_request_log(tmp_path / "port.jsonl", config, log)
    jax_traffic.write_request_log(tmp_path / "jax.jsonl", jax_config, jax_log)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    # each package reads the other's file back to the same requests
    back_config, back = traffic.read_request_log(tmp_path / "jax.jsonl")
    assert back == log and back_config == config
    _, jax_back = jax_traffic.read_request_log(tmp_path / "port.jsonl")
    assert [(r.t_s, r.route, r.x) for r in jax_back] == [(r.t_s, r.route, r.x) for r in log]


def test_constants_and_choices_equal_jaxs():
    from bodywork_tpu.traffic.generator import ARRIVAL_PROCESSES as JAX_ARRIVALS
    from bodywork_tpu.traffic.generator import LOG_SCHEMA as JAX_SCHEMA
    from bodywork_tpu.traffic.generator import TRANSPORTS as JAX_TRANSPORTS

    assert (ARRIVAL_PROCESSES, TRANSPORTS, LOG_SCHEMA) == (JAX_ARRIVALS, JAX_TRANSPORTS,
                                                           JAX_SCHEMA)
    assert (wire.BINARY_CONTENT_TYPE, wire.WIRE_SCHEMA_VERSION) == (
        jax_wire.BINARY_CONTENT_TYPE, jax_wire.WIRE_SCHEMA_VERSION)
    run = cli.build_parser()._subparsers._group_actions[0].choices["traffic"]
    run = run._subparsers._group_actions[0].choices["run"]
    choices = {a.dest: tuple(a.choices) for a in run._actions if a.choices}
    assert choices == {"arrival": ARRIVAL_PROCESSES, "transport": TRANSPORTS}


@pytest.mark.parametrize("X", [
    [50.0], [1.5, 2.5, 3.5], [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]], 7.0,
    np.random.default_rng(3).uniform(0, 100, 64),
])
def test_binary_framing_bytes_and_parses_equal_jaxs(X):
    body = wire.encode_binary_rows(X)
    assert body == jax_wire.encode_binary_rows(X)
    got, message = wire.parse_binary_rows(body)
    want, jax_message = jax_wire.parse_binary_rows(body)
    assert message is None and jax_message is None
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    # the binary twin parses to the JSON body's array
    json_X, _ = wire.parse_features({"X": np.asarray(X).tolist()})
    assert got.tobytes() == np.asarray(json_X, np.float32).reshape(got.shape).tobytes()


@pytest.mark.parametrize("body", [
    b"", b"\x01\x00\x00\x00", wire._BINARY_HEADER.pack(0, 1),
    wire._BINARY_HEADER.pack(2, 1) + np.float32(1.0).tobytes(),
    wire._BINARY_HEADER.pack(1, 1) + np.float32(np.nan).tobytes(),
])
def test_malformed_binary_bodies_answer_jaxs_messages(body):
    assert wire.parse_binary_rows(body) == jax_wire.parse_binary_rows(body)


def _canned(statuses, model_keys=None):
    counter = {"i": 0}

    async def transport(req):
        i = counter["i"]
        counter["i"] += 1
        await asyncio.sleep(0)
        status = statuses[i % len(statuses)]
        if status == -1:
            raise ConnectionResetError("canned transport failure")
        key = model_keys[i % len(model_keys)] if model_keys else None
        return status, (3.0 if status == 429 else None), key, None

    return transport


def test_report_accounting_equals_jaxs_on_a_canned_transport():
    knobs = {"rate_rps": 400.0, "duration_s": 0.5, "seed": 2}
    statuses = [200, 429, 503, 400, 500, -1, 200]
    keys = ["models/a.npz", None, "models/b.npz"]
    port = runner.run_open_loop("http://x", traffic.generate_request_log(
        traffic.TrafficConfig(**knobs)), transport=_canned(statuses, keys))
    ref = jax_runner.run_open_loop("http://x", jax_traffic.generate_request_log(
        jax_traffic.TrafficConfig(**knobs)), transport=_canned(statuses, keys))
    mask = ("latency", "send_lag_p99_s", "max_in_flight", "ok_in_window",
            "goodput_in_window_rps")
    a, b = port.to_dict(), ref.to_dict()
    assert list(a) == list(b)
    for d in (a, b):
        for k in mask:
            d.pop(k)
        for entry in d["per_model_key"].values():
            entry.pop("latency")
            entry.pop("ok_in_window")
    assert a == b
    assert json.loads(runner.format_report(port)).keys() == json.loads(
        jax_runner.format_report(ref)).keys()


def test_max_blackout_equals_jaxs():
    rng = np.random.default_rng(8)
    results = [runner._Result(t_s=float(t), status=int(s), retry_after_s=None,
                              latency_s=0.0, send_lag_s=0.0)
               for t, s in zip(np.sort(rng.uniform(0, 5, 200)),
                               rng.choice([200, 200, 503, 0], 200))]
    jax_results = [jax_runner._Result(t_s=r.t_s, status=r.status, retry_after_s=None,
                                      latency_s=0.0, send_lag_s=0.0) for r in results]
    assert runner._max_blackout_s(results) == jax_runner._max_blackout_s(jax_results) > 0


class _Shared:
    """One port predictor behind the JAX package's predictor interface,
    so both servers answer from the same floats."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.buckets = predictor.buckets
        self.dtype = predictor.dtype

    def predict(self, X):
        return self.predictor.predict(X)

    def warmup(self, n_features=None, sync=True):
        self.predictor.warmup()


@pytest.fixture(scope="module")
def servers():
    """Each package's aio engine answering from one predictor."""
    from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
    from bodywork_tpu.serve import AioServiceHandle as JaxAioServiceHandle
    from bodywork_tpu.serve import create_app as jax_create_app
    from bodywork_tpu_torch.models import LinearRegressor
    from bodywork_tpu_torch.serve import AioServiceHandle, PaddedPredictor, create_app

    rng = np.random.default_rng(4)
    X = rng.uniform(0, 100, 400).astype(np.float32)
    jax_model = JaxLinearRegressor().fit(X, (2.0 + 0.5 * X).astype(np.float32))
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    kwargs = {"model_key": "models/regressor-2026-07-01.npz", "model_source": "production"}
    predictor = PaddedPredictor(model, (1, 8))
    port = AioServiceHandle(create_app(model, DAY, predictor=predictor, **kwargs),
                            "127.0.0.1", 0).start()
    ref = JaxAioServiceHandle(jax_create_app(jax_model, DAY, predictor=_Shared(predictor),
                                             **kwargs), "127.0.0.1", 0).start()
    yield {"port": port.url.replace("/score/v1", ""), "jax": ref.url.replace("/score/v1", "")}
    for handle in (port, ref):
        handle.stop()
        handle.app.close()


def _recording_http(base, kind, bodies):
    """The harness's own HTTP transport, recording each answer's body."""
    import urllib.parse

    parsed = urllib.parse.urlsplit(base)
    pool = runner._ConnectionPool(parsed.hostname, parsed.port)

    async def transport(req):
        status, retry_after, key, trace_id = await runner._http_transport(pool, req, kind)
        return status, retry_after, key, trace_id

    async def body_of(req):
        # a second, plain exchange for the body bytes (the transport drops them)
        reader, writer = await asyncio.open_connection(parsed.hostname, parsed.port)
        payload = req.payload_binary() if kind == "binary" else req.payload()
        ctype = wire.BINARY_CONTENT_TYPE if kind == "binary" else "application/json"
        writer.write((f"POST {req.route} HTTP/1.1\r\nHost: x\r\nContent-Type: {ctype}\r\n"
                      f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
                      ).encode() + payload)
        raw = await reader.read()
        writer.close()
        bodies[(req.t_s, req.route)] = raw.split(b"\r\n\r\n", 1)[1]

    return transport, body_of


def test_a_drive_of_each_packages_server_reports_jaxs_keys(servers):
    """The real HTTP transport against both aio engines: the same report
    keys, every request answered 200 and attributed to the model key,
    and the JSON and binary framings of one log answered with the same
    bytes by both packages."""
    log = traffic.generate_request_log(traffic.TrafficConfig(
        rate_rps=120.0, duration_s=0.5, batch_fraction=0.3, batch_rows=4, seed=6))
    reports = {name: runner.run_open_loop(base, log, timeout_s=10.0)
               for name, base in servers.items()}
    jax_report = jax_runner.run_open_loop(servers["jax"], jax_traffic.generate_request_log(
        jax_traffic.TrafficConfig(rate_rps=120.0, duration_s=0.5, batch_fraction=0.3,
                                  batch_rows=4, seed=6)), timeout_s=10.0)
    assert list(reports["port"].to_dict()) == list(jax_report.to_dict())
    for report in (*reports.values(), jax_report):
        assert report.ok == report.requests == len(log)
        assert set(report.per_model_key) == {"models/regressor-2026-07-01.npz"}
    bodies: dict = {}
    for name, base in servers.items():
        for kind in TRANSPORTS:
            got: dict = {}
            _transport, body_of = _recording_http(base, kind, got)

            async def _all(body_of=body_of):
                await asyncio.gather(*(body_of(r) for r in log))

            asyncio.run(asyncio.wait_for(_all(), 20))
            bodies[(name, kind)] = got
    first = bodies[("port", "json")]
    assert len(first) == len(log)
    for other in bodies.values():
        assert other == first


def test_cli_generate_only_writes_jaxs_file_and_nothing_to_do_exits_1(tmp_path):
    from bodywork_tpu.cli import main as jax_main

    flags = ["traffic", "run", "--rate", "90", "--duration", "1", "--arrival", "mmpp",
             "--seed", "5"]
    assert cli.main([*flags, "--log-out", str(tmp_path / "port.jsonl")]) == 0
    assert jax_main([*flags, "--log-out", str(tmp_path / "jax.jsonl")]) == 0
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert cli.main(["traffic", "run", "--rate", "50"]) == 1
    (tmp_path / "bad.jsonl").write_text('{"schema": "nope"}\n')
    assert cli.main(["traffic", "run", "--log-in", str(tmp_path / "bad.jsonl"),
                     "--url", "http://127.0.0.1:9"]) == 1


def test_cli_drives_a_live_service_and_prints_the_report(servers, tmp_path, capsys):
    assert cli.main(["traffic", "run", "--url", servers["port"], "--rate", "60",
                     "--duration", "0.5", "--transport", "binary", "--results-out",
                     str(tmp_path / "results.jsonl")]) == 0
    report = json.loads(capsys.readouterr().out)
    assert list(report) == list(jax_runner.LoadReport(
        **{k: 0 for k in report}).to_dict())
    assert report["ok"] == report["requests"] > 0
    lines = (tmp_path / "results.jsonl").read_text().splitlines()
    assert len(lines) == report["requests"]
    assert all(json.loads(line)["status"] == 200 for line in lines)


def test_sharded_drive_spawns_and_merges(servers):
    log = traffic.generate_request_log(traffic.TrafficConfig(rate_rps=80.0, duration_s=0.5,
                                                              seed=9))
    report = runner.run_open_loop(servers["port"], log, timeout_s=10.0, shards=2)
    assert report.shards == 2 and report.ok == report.requests == len(log)


def test_a_sharded_binary_drive_sends_on_time(servers):
    """A fresh shard process resolves the binary framing before its
    clock starts: its first binary request does not wait seconds for the
    serving package's import, so no send lags by half a second."""
    log = traffic.generate_request_log(traffic.TrafficConfig(rate_rps=100.0, duration_s=1.0,
                                                              seed=10))
    report = runner.run_open_loop(servers["port"], log, timeout_s=10.0,
                                  transport_kind="binary", shards=2)
    assert report.shards == 2 and report.ok == report.requests == len(log)
    assert report.send_lag_p99_s < 0.5
