"""The port's dispatcher leadership (``bodywork_tpu_torch.serve.leadership``)
against the JAX package's: the same acquire / renew / release / expire
sequence, with the same owners and an injected clock, leaves the same
lease document bytes in each package's store, with the same fences and
return values; a campaign parks and then wins, ``on_lost`` fires once, a
steady leader writes one CAS per renew interval and no raw put, and a
``NetQueueClient`` holds its rows across an active dispatcher's death and
resubmits them to the standby at the higher fence, refusing the zombie.
The standby pair's SIGKILL drill spawns processes and is ``slow``, as the
JAX package's is."""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bodywork_tpu.serve import leadership as jax_leadership
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.serve import leadership
from bodywork_tpu_torch.serve.leadership import (
    DispatcherLease,
    LeaderElection,
    LeadershipLost,
)
from bodywork_tpu_torch.serve.netqueue import NetQueueClient, NetQueueServer
from bodywork_tpu_torch.serve.rowqueue import DispatcherUnavailable
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.schema import dispatcher_leader_key

torch.set_num_threads(1)

KEY = dispatcher_leader_key()


def _wait_for(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def test_the_lease_key_schema_and_defaults_are_jaxs(monkeypatch):
    from bodywork_tpu.store.schema import dispatcher_leader_key as jax_key

    assert KEY == jax_key() == "serve/dispatcher-leader.json"
    assert leadership.LEADER_SCHEMA == jax_leadership.LEADER_SCHEMA
    assert leadership.DEFAULT_LEADER_TTL_S == jax_leadership.DEFAULT_LEADER_TTL_S == 5.0
    assert leadership.RENEW_FRACTION == jax_leadership.RENEW_FRACTION
    assert sorted(leadership.__all__) == sorted(jax_leadership.__all__)
    monkeypatch.setenv("BODYWORK_TPU_LEADER_TTL_S", "1.5")
    assert leadership.leader_ttl_from_env() == jax_leadership.leader_ttl_from_env() == 1.5
    monkeypatch.setenv("BODYWORK_TPU_LEADER_TTL_S", "-3")
    assert leadership.leader_ttl_from_env() == jax_leadership.leader_ttl_from_env() == 5.0


def _sequence(mod, store, steps) -> list:
    """Run ``steps`` against two leases ``a`` and ``b`` sharing one
    injected clock; after each, the step's outcome and the document."""
    t = [1000.0]
    leases = {name: mod.DispatcherLease(store, owner=owner, ttl_s=5.0, clock=lambda: t[0],
                                        address=f"10.0.0.{i}:9091")
              for i, (name, owner) in enumerate((("a", "hostA:11:aa"),
                                                 ("b", "hostA:22:bb")))}
    trace = []
    for step in steps:
        if step[0] == "tick":
            t[0] += step[1]
            continue
        who, op, *args = step
        try:
            outcome = getattr(leases[who], op)(*args)
        except Exception as exc:  # noqa: BLE001 - the outcome is compared
            outcome = type(exc).__name__
        raw = store.get_bytes(KEY) if store.exists(KEY) else None
        trace.append((who, op, outcome, leases[who].fence, raw))
    return trace


SEQUENCES = {
    "fenced-takeover": [("a", "try_acquire"), ("b", "try_acquire"), ("tick", 2.0),
                        ("a", "renew"), ("tick", 4.0), ("b", "try_acquire"),
                        ("tick", 1.1), ("b", "try_acquire"), ("a", "renew")],
    "release-keeps-fence": [("a", "try_acquire"), ("a", "release"), ("b", "peek"),
                            ("b", "try_acquire"), ("b", "renew"), ("b", "release")],
    "dead-owner": [("a", "try_acquire"), ("b", "expire_dead_owner", "hostB", 11),
                   ("b", "expire_dead_owner", "hostA", 12), ("b", "try_acquire"),
                   ("b", "expire_dead_owner", "hostA", 11), ("b", "try_acquire"),
                   ("a", "renew")],
    "reacquire": [("a", "try_acquire"), ("tick", 6.0), ("a", "try_acquire"),
                  ("b", "try_acquire"), ("tick", 10.0), ("b", "try_acquire")],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_a_lease_sequence_leaves_the_jax_packages_documents(tmp_path, name):
    """Fences, outcomes and the lease document's bytes after every step
    (owners and clock injected, so nothing needs masking)."""
    got = _sequence(leadership, FilesystemStore(tmp_path / "port"), SEQUENCES[name])
    want = _sequence(jax_leadership, JaxStore(tmp_path / "jax"), SEQUENCES[name])
    assert got == want
    assert max(step[3] for step in got) >= 1


def test_a_corrupt_lease_document_is_cas_repaired_by_the_next_acquire(tmp_path):
    for mod, store in ((leadership, FilesystemStore(tmp_path / "port")),
                       (jax_leadership, JaxStore(tmp_path / "jax"))):
        store.put_bytes(KEY, b"not json {{{")
        lease = mod.DispatcherLease(store, owner="h:1:aa", clock=lambda: 0.0)
        assert lease.peek() is None
        assert lease.try_acquire() == 1
        assert lease.peek()["owner"] == "h:1:aa"
    assert FilesystemStore(tmp_path / "port").get_bytes(KEY) == JaxStore(
        tmp_path / "jax").get_bytes(KEY)


class _CountingStore(FilesystemStore):
    """Counts the raw and conditional writes of the lease document."""

    def __init__(self, root):
        super().__init__(root)
        self.puts = 0
        self.cas = 0

    def put_bytes(self, key, data):
        self.puts += 1
        return super().put_bytes(key, data)

    def put_bytes_if_match(self, key, data, expected_token=None):
        self.cas += 1
        return super().put_bytes_if_match(key, data, expected_token)


def test_steady_leadership_is_one_cas_per_renew_interval_and_no_raw_put(tmp_path):
    store = _CountingStore(tmp_path)
    t = [0.0]
    election = LeaderElection(store, owner="h:1:aa", ttl_s=9.0, clock=lambda: t[0],
                              sleep=lambda s: None)
    assert election.campaign() == 1
    store.puts = store.cas = 0
    for _ in range(30):  # 15 s of ticks at 0.5 s; renew every 3 s
        t[0] += 0.5
        election.maybe_renew(now=t[0])
    assert (store.puts, store.cas) == (0, 5)


def test_a_campaign_parks_then_wins_on_release(tmp_path):
    store = FilesystemStore(tmp_path)
    active = LeaderElection(store, owner="h:1:aa", ttl_s=60.0)
    assert active.campaign() == 1 and active.state()["role"] == "active"
    standby = LeaderElection(store, owner="h:2:bb", ttl_s=60.0)
    won = {}
    t = threading.Thread(target=lambda: won.setdefault("fence", standby.campaign()),
                         daemon=True)
    t.start()
    time.sleep(0.3)
    assert not won and standby.state()["role"] == "standby"
    active.stop()  # releases: the standby's next poll wins
    t.join(timeout=10)
    assert won.get("fence") == 2 and standby.leading
    standby.stop()


def test_on_lost_fires_once_when_fenced_out(tmp_path):
    store = FilesystemStore(tmp_path)
    lost = []
    a = LeaderElection(store, owner="h:1:aa", ttl_s=0.4, on_lost=lambda: lost.append(True))
    assert a.campaign() == 1
    a.start_renewer()
    thief = DispatcherLease(store, owner="h:2:bb", ttl_s=60.0)
    store.put_bytes(KEY, thief._block(2))  # a takeover racing the renewer
    assert _wait_for(lambda: lost == [True], timeout_s=10.0)
    assert not a.leading
    time.sleep(0.5)
    assert lost == [True]
    a.stop()
    with pytest.raises(LeadershipLost):
        a.lease.renew()


def _pump(server, stop):
    """An echo dispatcher: row sums, so replies are a function of the rows."""
    while not stop.is_set():
        try:
            sub = server.poll(timeout_s=0.05)
        except Exception:  # noqa: BLE001 - the server closed under us
            return
        if sub is not None:
            server.reply(sub, 200, predictions=np.asarray(sub.X, np.float32).sum(axis=1),
                         bundle=SimpleNamespace(model_key="mk", model_info="mi",
                                                model_date="2026-07-01"))


def test_held_rows_are_resubmitted_to_the_fenced_standby():
    """Kill the active dispatcher with a request in flight: the client
    holds the row, reconnects to the standby on the same address at the
    next fence, resubmits, and answers the pre-kill bytes; a zombie
    offering the old fence is refused at the HELLO."""
    active = NetQueueServer(("tcp", "127.0.0.1", 0), credit_window=8, fence=1)
    address = active.address
    stop1 = threading.Event()
    pump1 = threading.Thread(target=_pump, args=(active, stop1), daemon=True)
    pump1.start()
    client = NetQueueClient(address, frontend_id=0, reconnect_base_s=0.05,
                            reconnect_max_s=0.2, failover_deadline_s=15.0).start()
    try:
        assert _wait_for(client.dispatcher_up) and client.fence_seen == 1
        X = np.arange(4, dtype=np.float32).reshape(2, 2)
        baseline = {}
        client.submit(X, 1, lambda r: baseline.setdefault("r", r))
        assert _wait_for(lambda: "r" in baseline)
        stop1.set()
        pump1.join(timeout=5)
        held = {}
        client.submit(X, 1, lambda r: held.setdefault("r", r))
        active.close()
        assert _wait_for(lambda: not client.dispatcher_up())
        assert "r" not in held  # held, not failed
        standby = NetQueueServer(address, credit_window=8, fence=2)
        stop2 = threading.Event()
        pump2 = threading.Thread(target=_pump, args=(standby, stop2), daemon=True)
        pump2.start()
        try:
            assert _wait_for(lambda: "r" in held, timeout_s=15.0)
            assert held["r"].status == 200
            assert held["r"].predictions.tolist() == baseline["r"].predictions.tolist()
            assert (client.fence_seen, client.takeovers_observed) == (2, 1)
            lead = client.transport_state()["leadership"]
            assert (lead["role"], lead["fence"], lead["takeovers_observed"]) == (
                "active", 2, 1)
        finally:
            stop2.set()
            standby.close()
        assert _wait_for(lambda: not client.dispatcher_up())
        zombie = NetQueueServer(address, credit_window=8, fence=1)
        try:
            time.sleep(0.8)
            assert not client.dispatcher_up()
            with pytest.raises(DispatcherUnavailable):
                client.submit(X, 1, lambda r: None)
        finally:
            zombie.close()
    finally:
        client.stop()


@pytest.mark.slow
def test_the_standby_pair_survives_a_sigkill_of_the_active(tmp_path):
    """``MultiProcessService(standby=True)`` over tcp on the CPU: both
    candidates warm, one leads; SIGKILL it mid-traffic and the standby
    takes over inside the TTL + reconnect bound with no failed score."""
    import os
    from datetime import date

    import requests

    from bodywork_tpu_torch.models import LinearRegressor
    from bodywork_tpu_torch.models.checkpoint import save_model
    from bodywork_tpu_torch.serve.multiproc import MultiProcessService

    rng = np.random.default_rng(3)
    X = rng.uniform(0, 100, 400).astype(np.float32)
    save_model(FilesystemStore(tmp_path), LinearRegressor().fit(
        X, (1.0 + 0.5 * X).astype(np.float32), device="cpu"), date(2026, 7, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        svc = MultiProcessService(str(tmp_path), frontends=2, transport="tcp", standby=True,
                                  leader_ttl_s=1.0, engine="torch", device="cpu",
                                  startup_timeout_s=120.0).start()
    try:
        assert len(svc.dispatcher_pids) == 2
        leader = svc.dispatcher_pid
        baseline = requests.post(svc.url, json={"X": 50}, timeout=30)
        assert baseline.status_code == 200
        os.kill(leader, 9)
        t0 = time.monotonic()
        statuses = []
        while time.monotonic() - t0 < 10.0:
            r = requests.post(svc.url, json={"X": 50}, timeout=30)
            statuses.append(r.status_code)
            assert r.status_code in (200, 503)
            if r.status_code == 200:
                assert r.content == baseline.content
        assert statuses[-1] == 200
        doc = leadership.DispatcherLease(FilesystemStore(tmp_path)).peek()
        assert doc["fence"] >= 2 and f":{leader}:" not in doc["owner"]
    finally:
        svc.stop()
