"""The port's socket row queue (``bodywork_tpu_torch.serve.netqueue``)
against the JAX package's: the bytes each side puts on the wire (HELLO,
SUBMIT, REPLY) for the same inputs, captured at a raw socket; each
package's client against the other's server over a unix socket and TCP;
the credit window as the shed boundary; the wire-version fence and the
leadership fence refusing a peer at the handshake; ``parse_dispatcher_addr``
and the ``transport_state`` schema. One spawned tcp fleet (2 front ends,
1 dispatcher on the CPU) answers the in-process app's bytes and survives
a dispatcher kill by holding and resubmitting its rows."""
import json
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import requests
import torch

from bodywork_tpu.serve import netqueue as jax_netqueue
from bodywork_tpu.serve import rowqueue as jax_rowqueue
from bodywork_tpu_torch.serve import netqueue, rowqueue
from bodywork_tpu_torch.serve.netqueue import NetQueueClient, NetQueueServer

torch.set_num_threads(1)

PACKAGES = {"port": netqueue, "jax": jax_netqueue}


def _bundle(key="mk", info="mi", when="2026-07-01"):
    return SimpleNamespace(model_key=key, model_info=info, model_date=when)


def _wait_for(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _recv_frame_raw(conn) -> bytes:
    """One whole frame, header included, off a raw socket."""
    head = b""
    while len(head) < 5:
        head += conn.recv(5 - len(head))
    length = int.from_bytes(head[:4], "little")
    body = b""
    while len(body) < length - 1:
        body += conn.recv(length - 1 - len(body))
    return head + body


def test_constants_and_exports_are_jaxs():
    names = ("SERVE_TRANSPORTS", "SERVE_ROLES", "DEFAULT_DISPATCHER_PORT",
             "RECONNECT_BASE_S", "RECONNECT_MAX_S", "DEFAULT_FAILOVER_DEADLINE_S",
             "_MSG_HELLO", "_MSG_SUBMIT", "_MSG_REPLY", "_MAX_FRAME")
    assert {n: getattr(netqueue, n) for n in names} == {
        n: getattr(jax_netqueue, n) for n in names}
    for n in ("_FRAME_HEADER", "_HELLO_BODY", "_SUBMIT_HEADER", "_REPLY_HEADER"):
        assert getattr(netqueue, n).format == getattr(jax_netqueue, n).format
    assert (netqueue.DEFAULT_DISPATCHER_PORT, netqueue.RECONNECT_MAX_S) == (9091, 5.0)
    assert sorted(netqueue.__all__) == sorted(jax_netqueue.__all__)


@pytest.mark.parametrize("msg_type,payload", [(1, b""), (2, b"\x00" * 7), (3, b"abc" * 100)])
def test_frame_bytes_are_jaxs(msg_type, payload):
    assert netqueue._frame(msg_type, payload) == jax_netqueue._frame(msg_type, payload)


ADDRESSES = {
    "host:port": ("tcp", "host.svc:9091"),
    ":port": ("tcp", ":9091"),
    "unix": ("unix", "/tmp/q.sock"),
    "no-port": ("tcp", "no-port"),
    "tcp-none": ("tcp", None),
    "unix-none": ("unix", None),
    "shm": ("shm", "x:1"),
    "pigeon": ("carrier-pigeon", "x:1"),
    "bad-port": ("tcp", "host:port"),
}


@pytest.mark.parametrize("name", sorted(ADDRESSES))
def test_parse_dispatcher_addr_equals_jaxs(name):
    def outcome(mod):
        try:
            return mod.parse_dispatcher_addr(*ADDRESSES[name])
        except ValueError as exc:
            return "ValueError", str(exc)

    assert outcome(netqueue) == outcome(jax_netqueue)


# --- the bytes on the wire -----------------------------------------------------

def _client_submit_bytes(mod, X, kind, trace_id) -> tuple[bytes, bytes]:
    """A raw listener plays the dispatcher: it sends the JAX HELLO and
    records the SUBMIT frame ``mod``'s client writes; the reply it sends
    back must complete the client's wait."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    seen = {}

    def dispatcher():
        conn, _ = listener.accept()
        body = jax_netqueue._HELLO_BODY.pack(1, 4, 0) + b"application/x-bodywork-rows"
        conn.sendall(jax_netqueue._frame(1, body))
        seen["submit"] = _recv_frame_raw(conn)
        req_id = int.from_bytes(seen["submit"][5:13], "little")
        preds = np.asarray([1.5, 2.5], np.float32)
        ident = json.dumps(["mk", "mi", "2026-07-01"]).encode()
        reply = (jax_netqueue._REPLY_HEADER.pack(req_id, 200, len(preds)) + preds.tobytes()
                 + len(ident).to_bytes(4, "little") + ident)
        conn.sendall(jax_netqueue._frame(3, reply))
        time.sleep(0.5)
        conn.close()

    t = threading.Thread(target=dispatcher, daemon=True)
    t.start()
    client = mod.NetQueueClient(("tcp",) + listener.getsockname()[:2], frontend_id=0).start()
    try:
        assert _wait_for(client.dispatcher_up)
        got = {}
        client.submit(X, kind, lambda r: got.setdefault("r", r), trace_id=trace_id)
        assert _wait_for(lambda: "r" in got)
        r = got["r"]
        return seen["submit"], (r.status, r.predictions.tolist(), r.model_key,
                                r.model_info, r.model_date)
    finally:
        client.stop()
        listener.close()
        t.join(timeout=5)


@pytest.mark.parametrize("X,kind,trace_id", [
    (np.float32(21.0), 1, "0af7651916cd43dd8448eb211c80319c"),
    (np.arange(6, dtype=np.float32).reshape(2, 3), 2, None),
    (np.asarray([0.1, 1e-7, 12345.678], np.float32), 2, "t-1"),
])
def test_a_submit_frame_and_its_reply_are_jaxs(X, kind, trace_id):
    assert _client_submit_bytes(netqueue, X, kind, trace_id) == _client_submit_bytes(
        jax_netqueue, X, kind, trace_id)


def _server_bytes(mod, fence, credit_window, predictions) -> dict:
    """A raw client plays the front end against ``mod``'s server: the
    HELLO it receives and the REPLY frame for a JAX-built SUBMIT."""
    server = mod.NetQueueServer(("tcp", "127.0.0.1", 0), credit_window=credit_window,
                                fence=fence)
    conn = socket.create_connection(server.address[1:])
    try:
        hello = _recv_frame_raw(conn)
        rows = (3).to_bytes(4, "little") + (1).to_bytes(4, "little") + \
            np.asarray([1, 2, 3], np.float32).tobytes()
        trace = b"trace-7"
        conn.sendall(jax_netqueue._frame(2, jax_netqueue._SUBMIT_HEADER.pack(
            41, 2, len(trace)) + trace + rows))
        sub = server.poll(timeout_s=10.0)
        assert sub is not None
        polled = (sub.kind, np.asarray(sub.X).tolist(), sub.trace_id, sub.frontend_id)
        server.reply(sub, 200, predictions=predictions, bundle=_bundle())
        return {"hello": hello, "reply": _recv_frame_raw(conn), "polled": polled}
    finally:
        conn.close()
        server.close()


@pytest.mark.parametrize("fence,window,predictions", [
    (0, 1024, np.asarray([1.0, 2.0, 3.0], np.float32)),
    (7, 4, np.asarray([0.5, -1e-6, 1e9], np.float32)),
])
def test_hello_and_reply_frames_are_jaxs(fence, window, predictions):
    got = _server_bytes(netqueue, fence, window, predictions)
    assert got == _server_bytes(jax_netqueue, fence, window, predictions)
    assert got["polled"][0] == 2 and got["polled"][2] == "trace-7"


# --- each package's client against the other's server ------------------------

def _roundtrip(client_mod, server_mod, address) -> list:
    server = server_mod.NetQueueServer(address, credit_window=4)
    client = client_mod.NetQueueClient(server.address, frontend_id=1).start()
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            sub = server.poll(timeout_s=0.05)
            if sub is not None:
                server.reply(sub, 200, predictions=np.asarray(sub.X, np.float32).ravel() * 2,
                             bundle=_bundle(info=f"frontend-{sub.frontend_id}"))

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    try:
        assert _wait_for(client.dispatcher_up)
        out = []
        for X, kind in ((np.float32(21.0), 1), (np.ones((2, 2), np.float32), 2)):
            got = {}
            client.submit(X, kind, lambda r: got.setdefault("r", r), trace_id="t")
            assert _wait_for(lambda: "r" in got)
            r = got["r"]
            out.append((r.status, r.predictions.tolist(), r.model_key, r.model_info,
                        r.model_date))
        return out + [client.stats()["replies_received"]]
    finally:
        stop.set()
        t.join(timeout=5)
        client.stop()
        server.close()


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "port"), ("port", "jax"),
                                                   ("port", "port")])
@pytest.mark.parametrize("transport", ["unix", "tcp"])
def test_roundtrip_across_the_packages_equals_jaxs(tmp_path, client_pkg, server_pkg,
                                                   transport):
    address = (("unix", str(tmp_path / "q.sock")) if transport == "unix"
               else ("tcp", "127.0.0.1", 0))
    got = _roundtrip(PACKAGES[client_pkg], PACKAGES[server_pkg], address)
    want_address = (("unix", str(tmp_path / "j.sock")) if transport == "unix"
                    else ("tcp", "127.0.0.1", 0))
    assert got == _roundtrip(jax_netqueue, jax_netqueue, want_address)
    assert got[0] == (200, [42.0], "mk", "frontend-0", "2026-07-01")


def test_the_credit_window_is_the_shed_boundary():
    """Submits past the HELLO's window raise ``SlotsExhausted`` at once,
    the socket analogue of an empty slot pool; replies return credits."""
    server = NetQueueServer(("tcp", "127.0.0.1", 0), credit_window=4)
    client = NetQueueClient(server.address, frontend_id=0).start()
    try:
        assert _wait_for(client.dispatcher_up)
        assert client.credit_window == 4
        X = np.ones((1, 1), np.float32)
        for _ in range(4):
            client.submit(X, 1, lambda r: None)
        with pytest.raises(rowqueue.SlotsExhausted):
            client.submit(X, 1, lambda r: None)
        assert client.transport_state()["credits_in_flight"] == 4
        for _ in range(4):
            server.reply(server.poll(timeout_s=5.0), 200,
                         predictions=np.zeros(1, np.float32), bundle=_bundle())
        assert _wait_for(lambda: client.stats()["in_flight"] == 0)
        client.submit(X, 1, lambda r: None)  # the credits came back
    finally:
        client.stop()
        server.close()


@pytest.mark.parametrize("version,fence", [(9999, 0), (1, 2)])
def test_the_handshake_refuses_a_wrong_version_or_a_lower_fence(version, fence):
    """A peer of another wire version is refused at the HELLO; so is a
    dispatcher offering a lower fence than one the client has seen (a
    zombie ex-leader)."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)

    def impostor():
        conn, _ = listener.accept()
        body = jax_netqueue._HELLO_BODY.pack(version, 4, fence) + b"application/x-bodywork-rows"
        conn.sendall(jax_netqueue._frame(1, body))
        time.sleep(1.0)
        conn.close()

    t = threading.Thread(target=impostor, daemon=True)
    t.start()
    client = NetQueueClient(("tcp",) + listener.getsockname()[:2], frontend_id=0)
    client.fence_seen = 5  # it has followed a leader at fence 5
    client.start()
    try:
        time.sleep(0.8)
        assert not client.dispatcher_up()
        with pytest.raises(rowqueue.DispatcherUnavailable):
            client.submit(np.ones((1, 1), np.float32), 1, lambda r: None)
    finally:
        client.stop()
        listener.close()
        t.join(timeout=5)


def test_transport_state_and_stats_schemas_are_jaxs():
    """One ``/healthz`` transport schema for both transports and both
    packages."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    states = {}
    for name, mod, rq in (("port", netqueue, rowqueue), ("jax", jax_netqueue, jax_rowqueue)):
        server = mod.NetQueueServer(("tcp", "127.0.0.1", 0), credit_window=4, fence=3)
        net = mod.NetQueueClient(server.address, frontend_id=0).start()
        shm = rq.RowQueueClient(rq.RowQueue(ctx, frontends=1, slots=4, slot_floats=8), 0)
        try:
            assert _wait_for(net.dispatcher_up)
            state = net.transport_state()
            state["address"] = "<address>"
            states[name] = (state, list(net.stats()), list(shm.transport_state()),
                            list(shm.stats()))
        finally:
            net.stop()
            server.close()
    for state in (states["port"][0], states["jax"][0]):
        state["leadership"]["lease_age_s"] = None if state["leadership"].get(
            "lease_age_s") is None else "<age>"
    assert states["port"] == states["jax"]
    assert states["port"][0]["kind"] == "tcp" and states["port"][0]["leadership"]["fence"] == 3
    assert set(states["port"][0]) == set(states["port"][2])


# --- one spawned tcp fleet ---------------------------------------------------------

def test_a_tcp_fleet_answers_the_in_process_bytes_and_holds_rows_across_a_kill(tmp_path):
    """2 front ends and a dispatcher over tcp, on the CPU: the in-process
    app's bytes; SIGKILL the dispatcher and every request still answers
    200 (the clients hold their rows, reconnect to the respawned
    dispatcher and resubmit) or the honest 503."""
    from datetime import date

    from bodywork_tpu_torch.models import LinearRegressor
    from bodywork_tpu_torch.models.checkpoint import load_model, save_model
    from bodywork_tpu_torch.serve.app import create_app
    from bodywork_tpu_torch.serve.multiproc import MultiProcessService
    from bodywork_tpu_torch.store import FilesystemStore

    rng = np.random.default_rng(5)
    X = rng.uniform(0, 100, 400).astype(np.float32)
    store = FilesystemStore(tmp_path / "store")
    save_model(store, LinearRegressor().fit(X, (2.0 + 0.25 * X).astype(np.float32),
                                            device="cpu"), date(2026, 7, 2))
    model, model_date = load_model(store, device="cpu")
    app = create_app(model, model_date, model_key="models/regressor-2026-07-02.npz",
                     model_source="latest")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        svc = MultiProcessService(str(tmp_path / "store"), frontends=2, transport="tcp",
                                  server_engine="aio", engine="torch", device="cpu",
                                  startup_timeout_s=90.0).start()
    try:
        body = json.dumps({"X": [3.5, 40.0]}).encode()
        want = app.handle("POST", "/score/v1/batch", body, "application/json")[2]
        base = svc.url.rsplit("/score/v1", 1)[0]
        r = requests.post(base + "/score/v1/batch", data=body,
                          headers={"Content-Type": "application/json"}, timeout=30)
        assert (r.status_code, r.content) == (200, want)
        health = requests.get(base + "/healthz", timeout=30).json()
        assert health["transport"]["kind"] == "tcp" and health["transport"]["connected"]
        old = svc.dispatcher_pid
        svc.kill_dispatcher()
        statuses = []
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            r = requests.post(base + "/score/v1/batch", data=body,
                              headers={"Content-Type": "application/json"}, timeout=60)
            statuses.append(r.status_code)
            assert r.status_code in (200, 503)
            if r.status_code == 200:
                assert r.content == want
                if svc.dispatcher_pid not in (None, old):
                    break
            time.sleep(0.05)
        assert statuses[-1] == 200 and svc.dispatcher_pid not in (None, old)
        # the front end that answers reconnected to the new dispatcher
        assert _wait_for(lambda: requests.get(base + "/healthz", timeout=30).json()[
            "transport"]["reconnects"] >= 1, timeout_s=30)
    finally:
        svc.stop()
