"""The port's multi-process serving replicas (``bodywork_tpu_torch.serve.
multiproc``) on the CPU: the seven contracts of ``tests/test_multiproc.py``
(two real processes on one port, a SIGKILL mid-traffic with zero failed
scores, hot reload reaching every replica, the supervisor's respawn and
the respawn policy's three rules), then the service-wide admission budget,
the aggregated ``/metrics`` text (byte-equal to the JAX package's for the
same snapshots), a worker that cannot start, and the split topology's
arguments, which build the JAX service's topology or refuse as it does
(the split fleets themselves: ``test_torch_dispatch.py``,
``test_torch_netqueue.py``). Every spawn is bounded by its own start-up
timeout."""
import os
import time
from datetime import date

import numpy as np
import pytest
import requests
import torch
from requests.adapters import HTTPAdapter, Retry

from bodywork_tpu_torch.models import LinearRegressor
from bodywork_tpu_torch.models.checkpoint import save_model
from bodywork_tpu_torch.serve.multiproc import MultiProcessService, RespawnPolicy
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

#: each spawned worker's own start-up bound (a fresh interpreter, torch's
#: import and the model's load on the CPU take a few seconds here)
STARTUP_TIMEOUT_S = 90.0


def _seed_store(root, seed=3, intercept=1.0, slope=0.5, day=date(2026, 7, 1)):
    store = FilesystemStore(root)
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, 500).astype(np.float32)
    save_model(store, LinearRegressor().fit(X, (intercept + slope * X).astype(np.float32),
                                            device="cpu"), day)
    return store


def _service(root, **kw) -> MultiProcessService:
    return MultiProcessService(str(root), workers=2, engine="torch", device="cpu",
                               startup_timeout_s=STARTUP_TIMEOUT_S, **kw)


@pytest.fixture(scope="module", autouse=True)
def _one_thread_workers():
    """Spawned workers inherit the environment: one torch thread each, as
    the tests' own process runs, so the file's replicas load the CPU no
    more than one process each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def mp_service(tmp_path_factory, _one_thread_workers):
    root = tmp_path_factory.mktemp("mp-store")
    _seed_store(root)
    svc = _service(root).start()
    try:
        yield svc
    finally:
        svc.stop()


def _session() -> requests.Session:
    """A client with connect and read retries: a connection that lands on
    a just-killed listener is refused (connect retry) or reset mid-exchange
    (read retry); scoring is idempotent, so a retried POST is safe."""
    s = requests.Session()
    retry = Retry(total=6, connect=5, read=5, backoff_factor=0.05, allowed_methods=None)
    s.mount("http://", HTTPAdapter(max_retries=retry))
    return s


def test_two_real_processes_serve_one_port(mp_service):
    pids = mp_service.worker_pids
    assert len(pids) == 2
    assert len(set(pids)) == 2
    assert all(pid != os.getpid() for pid in pids)  # real OS processes
    r = _session().post(mp_service.url, json={"X": 50}, timeout=30)
    assert r.ok
    assert abs(r.json()["prediction"] - 26.0) < 2.0


def test_kill_one_worker_mid_traffic_zero_failed_scores(mp_service):
    """SIGKILL one replica while traffic flows: zero failed scores (the
    surviving listener takes every new connection)."""
    s = _session()
    victim = mp_service.worker_pids[0]
    answers = []
    for i in range(40):
        if i == 10:
            mp_service.kill_worker(victim)
        answers.append(s.post(mp_service.url, json={"X": 10}, timeout=30).ok)
    assert all(answers), f"failed scores at {[i for i, a in enumerate(answers) if not a]}"
    assert victim not in mp_service.worker_pids


def test_hot_reload_reaches_every_replica_process(tmp_path):
    """Each replica polls the store on its own: a newer checkpoint lands in
    both worker processes without a restart (fresh connections, so the
    kernel spreads them over the listeners)."""
    store = _seed_store(tmp_path / "store", seed=5)
    with _service(tmp_path / "store", watch_interval_s=0.5) as svc:
        s = _session()
        r = s.post(svc.url, json={"X": 50}, timeout=30, headers={"Connection": "close"})
        assert r.json()["model_date"] == "2026-07-01"
        rng = np.random.default_rng(5)
        X = rng.uniform(0, 100, 400).astype(np.float32)
        save_model(store, LinearRegressor().fit(X, 2.0 + 2.0 * X, device="cpu"),
                   date(2026, 7, 2))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            dates = {s.post(svc.url, json={"X": 50}, timeout=30,
                            headers={"Connection": "close"}).json()["model_date"]
                     for _ in range(8)}
            if dates == {"2026-07-02"}:
                break
            time.sleep(0.5)
        assert dates == {"2026-07-02"}, f"replicas still serving {dates} after 60s"


def test_supervisor_respawns_killed_worker(mp_service):
    """The supervisor restores the declared replica count after a kill."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if len(mp_service.worker_pids) == 2:
            break
        time.sleep(0.5)
    assert len(mp_service.worker_pids) == 2
    s = _session()
    assert all(s.post(mp_service.url, json={"X": 5}, timeout=30).ok for _ in range(8))


@pytest.mark.parametrize("policy_cls", ["port", "jax"])
def test_respawn_policy_backs_off_exponentially_then_exhausts(policy_cls):
    from bodywork_tpu.serve.multiproc import RespawnPolicy as JaxRespawnPolicy

    cls = RespawnPolicy if policy_cls == "port" else JaxRespawnPolicy
    policy = cls(budget=3, base_s=0.5, max_s=30.0, reset_after_s=60.0)
    assert [policy.on_death(0.1) for _ in range(3)] == [0.5, 1.0, 2.0]
    assert not policy.exhausted
    assert policy.on_death(0.1) is None  # budget burned
    assert policy.exhausted


def test_respawn_policy_healthy_worker_resets_the_streak():
    policy = RespawnPolicy(budget=3, base_s=0.5, max_s=30.0, reset_after_s=60.0)
    assert policy.on_death(0.1) == 0.5
    assert policy.on_death(0.1) == 1.0
    assert policy.on_death(120.0) == 0.5  # alive past reset_after_s: fresh
    assert policy.consecutive == 1


def test_respawn_policy_backoff_is_capped():
    from bodywork_tpu.serve.multiproc import RespawnPolicy as JaxRespawnPolicy

    delays = {}
    for name, cls in (("port", RespawnPolicy), ("jax", JaxRespawnPolicy)):
        policy = cls(budget=50, base_s=0.5, max_s=4.0, reset_after_s=60.0)
        delays[name] = [policy.on_death(0.0) for _ in range(8)]
    assert max(delays["port"]) == 4.0 and delays["port"][-1] == 4.0
    assert delays["port"] == delays["jax"]


# -- the port's service-wide budget, metrics and refusals -------------------


def test_shared_budget_admits_against_the_fleets_sum_and_clears_a_slot():
    """``SharedBudgetSlot`` in both packages: admission compares the sum of
    every worker's slot with ``max_pending``, a release gives back only its
    own unit, and ``clear`` zeroes a dead worker's slot."""
    import multiprocessing

    from bodywork_tpu.serve.admission import SharedBudgetSlot as JaxSlot
    from bodywork_tpu_torch.serve.admission import AdmissionController, SharedBudgetSlot

    ctx = multiprocessing.get_context("spawn")
    for cls in (SharedBudgetSlot, JaxSlot):
        array = ctx.Array("i", 2)
        a, b = cls(array, 0), cls(array, 1)
        assert [a.admit(3), a.admit(3), b.admit(3), b.admit(3)] == [
            (True, 1), (True, 2), (True, 3), (False, 3)]
        b.release()
        assert a.total() == 2
        cls.clear(array, 0)
        assert b.total() == 0 and list(array) == [0, 0]
    array = ctx.Array("i", 2)
    first = AdmissionController(max_pending=2, shared_slot=SharedBudgetSlot(array, 0))
    second = AdmissionController(max_pending=2, shared_slot=SharedBudgetSlot(array, 1))
    assert first.try_admit() and second.try_admit()
    assert not first.try_admit()  # the fleet is at its budget
    state = first.state()
    assert state["shared_pending"] == 2 and state["shedding"] and state["pending"] == 1
    second.release(0.001)
    assert first.state()["shared_pending"] == 1 and first.try_admit()


def test_aggregated_metrics_render_the_jax_text(tmp_path):
    """Two workers' flushed snapshots and a live registry merge into the
    JAX package's text, byte for byte; a dead worker keeps its counters and
    loses its gauges."""
    from bodywork_tpu.obs import multiproc as jax_multiproc
    from bodywork_tpu.obs.registry import Registry as JaxRegistry
    from bodywork_tpu_torch.obs import multiproc
    from bodywork_tpu_torch.obs.registry import Registry

    texts = {}
    for name, registry_cls, module in (("port", Registry, multiproc),
                                       ("jax", JaxRegistry, jax_multiproc)):
        directory = tmp_path / name
        directory.mkdir()
        for pid, n in ((os.getpid() + 100000, 3), (2 ** 22 + 7, 5)):  # a dead pid
            reg = registry_cls()
            reg.counter("bodywork_tpu_service_requests_total", "requests").inc(
                amount=n, route="/score/v1", status="200")
            reg.gauge("bodywork_tpu_serve_queue_depth", "depth", aggregate="sum").set(n)
            reg.histogram("bodywork_tpu_service_latency_seconds", "latency").observe(0.002 * n)
            module.write_snapshot(reg, directory, pid=pid)
        live = registry_cls()
        live.counter("bodywork_tpu_service_requests_total", "requests").inc(
            route="/score/v1", status="200")
        texts[name] = module.aggregated_render(live, directory)
    assert texts["port"] == texts["jax"]
    assert 'bodywork_tpu_service_requests_total{route="/score/v1",status="200"} 9' in texts["port"]
    assert "bodywork_tpu_serve_queue_depth 0" not in texts["port"]


def test_a_worker_that_cannot_start_fails_start_with_its_error(tmp_path):
    """An empty store (nothing to serve, no watcher): ``start`` raises the
    worker's own error instead of serving nothing, and leaves no process."""
    FilesystemStore(tmp_path / "empty").put_bytes("datasets/.keep", b"")
    svc = _service(tmp_path / "empty")
    with pytest.raises(RuntimeError, match="failed to start: ArtefactNotFound"):
        svc.start()
    assert svc.worker_pids == []


def test_a_multi_worker_service_sheds_and_aggregates_across_processes(tmp_path):
    """``--workers 2 --metrics --max-pending``: the service-wide budget is
    live (``/healthz`` ``shared_pending``), and ``/metrics`` on either
    worker counts both workers' requests."""
    _seed_store(tmp_path / "store")
    with _service(tmp_path / "store", metrics=True, max_pending=4,
                  server_engine="aio") as svc:
        s = _session()
        for _ in range(12):
            assert s.post(svc.url, json={"X": 10}, timeout=30,
                          headers={"Connection": "close"}).ok
        health = s.get(svc.url.replace("/score/v1", "/healthz"), timeout=30).json()
        assert health["admission"]["shared_pending"] is not None
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            text = s.get(svc.metrics_url, timeout=30).text
            counted = sum(
                float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
                if line.startswith("bodywork_tpu_http_requests_total{")
                and 'route="/score/v1"' in line)
            if counted >= 12:
                break
            time.sleep(0.3)
        assert counted >= 12, text


#: the four arguments alone (a fleet of front ends; the rest refused or
#: inert without it, as in the JAX service), then their combinations
SPLIT_ARGUMENTS = {
    "frontends": {"frontends": 2},
    "transport": {"transport": "tcp"},
    "standby": {"standby": True},
    "dispatcher_addr": {"dispatcher_addr": "x:9091"},
    "bad-transport": {"transport": "carrier-pigeon", "frontends": 1},
    "external-over-shm": {"frontends": 1, "external_dispatcher": True},
    "standby-over-shm": {"frontends": 1, "standby": True},
    "standby-external": {"frontends": 1, "transport": "tcp", "standby": True,
                         "external_dispatcher": True, "dispatcher_addr": "x:9091"},
    "dispatcher-only": {"frontends": 0, "transport": "tcp"},
    "external-without-addr": {"frontends": 2, "transport": "tcp",
                              "external_dispatcher": True},
    "tcp-split": {"frontends": 2, "transport": "tcp", "dispatcher_addr": "127.0.0.1:9191"},
    "unix-standby": {"frontends": 1, "transport": "unix", "standby": True},
    "standby-pair": {"frontends": 0, "transport": "tcp", "standby": True,
                     "dispatcher_addr": "0.0.0.0:9191"},
}


def _construct(cls, root, kwargs):
    """``(error type, message)`` or the constructed topology."""
    try:
        svc = cls(str(root), **kwargs)
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        return type(exc).__name__, str(exc)
    try:
        addr = svc.dispatcher_addr
        if addr is not None and addr[0] == "unix":
            addr = ("unix", "<temp>")
        return {"workers": svc.workers, "frontends": svc.frontends,
                "transport": svc.transport, "standby": svc.standby,
                "external": svc.external_dispatcher, "addr": addr,
                "queue": svc._queue is not None, "metrics": svc._metrics_enabled,
                "shared_budget": svc._shared_budget is not None}
    finally:
        svc._reserved.close()
        if svc._unix_dir is not None:
            import shutil

            shutil.rmtree(svc._unix_dir, ignore_errors=True)


@pytest.mark.parametrize("name", sorted(SPLIT_ARGUMENTS))
def test_the_split_arguments_are_validated_as_jaxs(tmp_path, name):
    """Every split argument of ``MultiProcessService`` builds the same
    topology as the JAX service, or refuses with the same error."""
    from bodywork_tpu.serve.multiproc import MultiProcessService as JaxService

    kwargs = SPLIT_ARGUMENTS[name]
    got = _construct(MultiProcessService, tmp_path, {**kwargs, "device": "cpu"})
    assert got == _construct(JaxService, tmp_path, kwargs)


def test_cli_serve_workers_refuses_a_bad_worker_count_and_parses(tmp_path):
    from bodywork_tpu_torch.cli import build_parser

    args = build_parser().parse_args(["serve", "--store", str(tmp_path), "--workers", "3",
                                      "--metrics", "--device", "cpu"])
    assert args.workers == 3 and args.metrics and args.device == "cpu"
    with pytest.raises(ValueError, match="at least one replica"):
        MultiProcessService(str(tmp_path), workers=0, device="cpu")

