"""The port's shared-memory row queue (``bodywork_tpu_torch.serve.rowqueue``),
the coalescer's per-source flush accounting and the torch-free front end
(``serve.frontend``, on the thread engine and ``aio``) against the JAX
package's: the same ring and queue semantics on the same inputs, each
package's client against the other's server on one queue (the layout is
shared byte for byte), the same coalescer statistics for the same
submission sequence, and the same response bytes, statuses and health
documents from the two front ends for the same replies. A subprocess pins
that the front-end stack imports neither torch nor jax."""
import asyncio
import json
import multiprocessing
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from bodywork_tpu.serve import frontend as jax_frontend
from bodywork_tpu.serve import rowqueue as jax_rowqueue
from bodywork_tpu.serve.batcher import RequestCoalescer as JaxCoalescer
from bodywork_tpu_torch.serve import frontend, rowqueue
from bodywork_tpu_torch.serve.batcher import RequestCoalescer
from bodywork_tpu_torch.serve.rowqueue import (
    KIND_SINGLE,
    RowQueue,
    RowQueueClient,
    RowQueueServer,
    SlotsExhausted,
    _Reply,
)
from bodywork_tpu_torch.serve.wire import BINARY_CONTENT_TYPE, encode_binary_rows

torch.set_num_threads(1)

CTX = multiprocessing.get_context("spawn")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": rowqueue, "jax": jax_rowqueue}


class _Bundle:
    """What ``RowQueueServer.reply`` reads of a served bundle."""

    def __init__(self, key="k-2026-07-01", info="Stub(x2)", d="2026-07-01"):
        self.model_key = key
        self.model_info = info
        self.model_date = d


def _wait_for(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# --- the lock-free control ring ----------------------------------------------

def _ring_trace(mod) -> list:
    ring = mod._SpscRing(CTX, 4)
    out = [ring.pop()]
    out += [ring.push(v) for v in (10, 20, 30, 40, 50)]
    out.append(ring.pop())
    out.append(ring.push(50))
    out += [ring.pop() for _ in range(5)]
    for v in range(100, 140):
        out += [ring.push(v), ring.pop()]
    return out


def test_spsc_ring_semantics_equal_jaxs():
    """Push publishes by the tail, pop by the head; an empty ring pops
    None, a full ring refuses; the cursors wrap without resetting."""
    got = _ring_trace(rowqueue)
    assert got == _ring_trace(jax_rowqueue)
    assert got[:7] == [None, True, True, True, True, False, 10]


def test_queue_layout_constants_are_jaxs():
    names = ("DEFAULT_SLOTS", "DEFAULT_SLOT_FLOATS", "KIND_SINGLE", "KIND_BATCH",
             "STATUS_PENDING", "META_INTS", "REQ_TEXT_BYTES", "REP_TEXT_BYTES",
             "TEXT_BYTES", "_SLOT_BITS", "_SLOT_MASK", "_M_GEN", "_M_KIND", "_M_ROWS",
             "_M_FEATURES", "_M_STATUS", "_M_REPLY_ROWS", "_M_OWNER")
    assert {n: getattr(rowqueue, n) for n in names} == {
        n: getattr(jax_rowqueue, n) for n in names}
    assert rowqueue.DEFAULT_SLOTS == 1024
    assert sorted(rowqueue.__all__) == sorted(jax_rowqueue.__all__)


# --- the round trip, across the two packages ------------------------------------

def _serve_n(server, n, status=200, scale=2.0):
    """Drain n submissions in a thread, replying as a dispatcher does."""
    polled = []

    def loop():
        deadline = time.monotonic() + 10
        while len(polled) < n and time.monotonic() < deadline:
            sub = server.poll(0.2)
            if sub is None:
                continue
            polled.append(sub)
            server.reply(sub, status, np.asarray(sub.X, dtype=np.float32) * scale, _Bundle())

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t, polled


def _roundtrip(queue_mod, client_mod, server_mod) -> dict:
    queue = queue_mod.RowQueue(CTX, frontends=2, slots=8, slot_floats=16)
    queue.up.value = 1
    client = client_mod.RowQueueClient(queue, frontend_id=1).start()
    try:
        t, polled = _serve_n(server_mod.RowQueueServer(queue), 2)
        replies = []
        for X, kind in ((np.float32(21.0), client_mod.KIND_SINGLE),
                        (np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32),
                         client_mod.KIND_BATCH)):
            done = threading.Event()
            client.submit(X, kind, lambda r, d=done: (replies.append(r), d.set()),
                          trace_id="0af7651916cd43dd8448eb211c80319c")
            assert done.wait(10)
        t.join(timeout=10)
        return {
            "replies": [(r.status, r.predictions.tolist(), r.model_key, r.model_info,
                         r.model_date) for r in replies],
            "polled": [(s.frontend_id, s.kind, np.asarray(s.X).shape, s.trace_id)
                       for s in polled],
            "stats": client.stats(),
        }
    finally:
        client.stop()


@pytest.mark.parametrize("queue_pkg,client_pkg,server_pkg", [
    ("port", "port", "port"),
    ("jax", "jax", "port"),
    ("port", "port", "jax"),
    ("jax", "port", "jax"),
])
def test_roundtrip_across_the_packages_equals_jaxs(queue_pkg, client_pkg, server_pkg):
    """Rows, the trace id, the kind and the answering bundle's identity
    cross the shared slot; each package's client reads the other's
    replies, since the layout is the same."""
    got = _roundtrip(PACKAGES[queue_pkg], PACKAGES[client_pkg], PACKAGES[server_pkg])
    assert got == _roundtrip(jax_rowqueue, jax_rowqueue, jax_rowqueue)
    assert got["replies"] == [
        (200, [42.0], "k-2026-07-01", "Stub(x2)", "2026-07-01"),
        (200, [2.0, 4.0, 6.0, 8.0], "k-2026-07-01", "Stub(x2)", "2026-07-01"),
    ]
    assert got["polled"][1][2] == (2, 2)
    assert got["stats"]["slots_free"] == 8 and got["stats"]["in_flight"] == 0


def _epoch_bump(mod) -> dict:
    queue = mod.RowQueue(CTX, frontends=1, slots=4, slot_floats=8)
    queue.up.value = 1
    client = mod.RowQueueClient(queue, frontend_id=0).start()
    try:
        outcomes = []
        done = threading.Event()
        for _ in range(3):  # no dispatcher consuming
            client.submit(np.float32(1.0), mod.KIND_SINGLE,
                          lambda r: (outcomes.append(r),
                                     done.set() if len(outcomes) == 3 else None))
        in_flight = client.stats()["in_flight"]
        queue.up.value = 0
        queue.epoch.value += 1
        assert done.wait(10)
        refused = False
        try:
            client.submit(np.float32(1.0), mod.KIND_SINGLE, lambda r: None)
        except mod.DispatcherUnavailable:
            refused = True
        return {"in_flight_before": in_flight,
                "outcomes": [type(o).__name__ for o in outcomes],
                "stats": client.stats(), "refused": refused,
                "transport": client.transport_state()}
    finally:
        client.stop()


def test_epoch_bump_fails_waits_in_flight_and_frees_their_slots():
    """The supervisor's death observation fails every wait in flight with
    ``DispatcherUnavailable`` and returns the slots: 503, never a wedge."""
    got = _epoch_bump(rowqueue)
    assert got == _epoch_bump(jax_rowqueue)
    assert got["outcomes"] == ["DispatcherUnavailable"] * 3
    assert got["stats"]["failures"] == 3 and got["stats"]["slots_free"] == 4
    assert got["refused"] and got["transport"]["leadership"]["fence"] == 1


def test_concurrent_submit_and_reply_lose_nothing():
    """The rings stay single-producer under real threads: 8 submitting
    threads, two replying threads, 400 requests, every one answered and
    every slot back in the pool."""
    queue = RowQueue(CTX, frontends=1, slots=64, slot_floats=8)
    queue.up.value = 1
    client = RowQueueClient(queue, frontend_id=0).start()
    n_threads, per_thread = 8, 50
    total = n_threads * per_thread
    server = RowQueueServer(queue)
    stop = threading.Event()
    repliers = ThreadPoolExecutor(max_workers=2)

    def serve_loop():
        while not stop.is_set():
            sub = server.poll(0.05)
            if sub is not None:
                repliers.submit(server.reply, sub, 200,
                                np.asarray(sub.X, np.float32) * 2.0, _Bundle())

    serving = threading.Thread(target=serve_loop, daemon=True)
    serving.start()
    done = threading.Event()
    replies = []
    lock = threading.Lock()

    def on_done(reply):
        with lock:
            replies.append(reply)
            if len(replies) == total:
                done.set()

    def submit_loop(k):
        for j in range(per_thread):
            while True:
                try:
                    client.submit(np.float32(k * per_thread + j), KIND_SINGLE, on_done)
                    break
                except SlotsExhausted:  # pool backpressure: retry
                    time.sleep(0.001)

    try:
        workers = [threading.Thread(target=submit_loop, args=(k,)) for k in range(n_threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert done.wait(60), f"lost {total - len(replies)} of {total}"
        assert sorted(float(r.predictions[0]) for r in replies) == [
            2.0 * i for i in range(total)]
        stats = client.stats()
        assert stats["requests_submitted"] == stats["replies_received"] == total
        assert stats["in_flight"] == 0 and stats["slots_free"] == queue.slots
    finally:
        stop.set()
        serving.join(timeout=5)
        repliers.shutdown(wait=True)
        client.stop()


def _reclaim(mod) -> list:
    queue = mod.RowQueue(CTX, frontends=2, slots=4, slot_floats=8)
    queue.up.value = 1
    victim = mod.RowQueueClient(queue, frontend_id=0)  # readers not started
    survivor = mod.RowQueueClient(queue, frontend_id=1)
    victim.submit(np.float32(1.0), mod.KIND_SINGLE, lambda r: None)
    victim.submit(np.float32(2.0), mod.KIND_SINGLE, lambda r: None)
    survivor.submit(np.float32(3.0), mod.KIND_SINGLE, lambda r: None)
    trace = [int(queue.free[0]), queue.reclaim_frontend(0), int(queue.free[0]),
             queue.reclaim_frontend(0)]
    server = mod.RowQueueServer(queue)
    polled = [server.poll(0.2) for _ in range(3)]
    live = [s for s in polled if s is not None]
    return trace + [[(s.frontend_id, float(np.ravel(s.X)[0])) for s in live]]


def test_a_dead_front_ends_slots_are_reclaimed_and_its_descriptors_go_stale():
    """The supervisor's reclaim returns exactly the dead front end's
    slots and stales its enqueued descriptors; a live sibling's
    submission still serves."""
    got = _reclaim(rowqueue)
    assert got == _reclaim(jax_rowqueue) == [1, 2, 3, 0, [(1, 3.0)]]


def _backpressure(mod) -> list:
    queue = mod.RowQueue(CTX, frontends=1, slots=1, slot_floats=4)
    queue.up.value = 1
    client = mod.RowQueueClient(queue, frontend_id=0)  # reader not started
    trace = []
    for X in (np.ones(5, np.float32), np.float32(1.0), np.float32(2.0)):
        try:
            client.submit(X, mod.KIND_SINGLE, lambda r: None)
            trace.append("queued")
        except mod.SlotsExhausted as exc:
            trace.append(str(exc))
    server = mod.RowQueueServer(queue)
    sub = server.poll(0.5)
    queue.epoch.value += 1
    client._epoch_seen = queue.epoch.value
    client._fail_pending(mod.DispatcherUnavailable("test"))
    client.submit(np.float32(3.0), mod.KIND_SINGLE, lambda r: None)  # reuses the slot
    server.reply(sub, 200, [99.0], _Bundle())  # a stale generation: inert
    sub2 = server.poll(0.5)
    return trace + [float(np.ravel(sub2.X)[0]), int(sub2.gen) - int(sub.gen)]


def test_backpressure_and_stale_descriptors_equal_jaxs():
    """A request past the slot stride and a spent pool are backpressure;
    a stale reply is dropped on the generation guard."""
    got = _backpressure(rowqueue)
    assert got == _backpressure(jax_rowqueue)
    assert got[1] == "queued" and got[-2:] == [3.0, 1]


# --- the coalescer's per-source flush accounting --------------------------------

class _Served:
    def __init__(self):
        self.predictor = self

    @staticmethod
    def predict(X):
        return np.asarray(X, np.float32).ravel() * 2.0


@pytest.mark.parametrize("sources", [
    ("frontend-0", "frontend-1", "frontend-0", "frontend-0", "frontend-1", None),
    (None, None, "frontend-1", "frontend-1"),
    ("frontend-2", "frontend-0", "frontend-1", "frontend-2"),
])
def test_coalescer_per_source_stats_equal_jaxs(sources):
    """Pairs of rows flush together (``max_rows=2``, well inside the
    window); after each flush the
    port's statistics and its multi-source counter equal the JAX
    coalescer's for the same sequence of sources."""
    from bodywork_tpu.obs import get_registry as jax_registry
    from bodywork_tpu_torch.obs import get_registry

    counter = "bodywork_tpu_coalesced_multisource_flush_total"
    history = {}
    for name, cls, registry in (("port", RequestCoalescer, get_registry),
                                ("jax", JaxCoalescer, jax_registry)):
        before = registry().counter(counter).value()
        coalescer = cls(window_ms=5000.0, max_rows=2).start()
        served = _Served()  # one bundle: rows of one bundle share a batch
        trace = []
        try:
            for i in range(0, len(sources), 2):
                # both rows of a pair land under the coalescer's lock, so
                # the pair is one max_rows flush whatever the scheduling
                with coalescer._cond:
                    subs = [coalescer.submit_nowait(served, np.asarray([float(j)], np.float32),
                                                    source=sources[j])
                            for j in (i, i + 1)]
                for sub in subs:
                    assert sub.event.wait(10) and sub.error is None
                stats = coalescer.stats()
                trace.append({k: stats[k] for k in (
                    "rows_submitted", "batches_dispatched", "rows_dispatched",
                    "max_batch_rows", "multi_source_flushes", "sources_seen")})
        finally:
            coalescer.stop()
        history[name] = (trace, registry().counter(counter).value() - before)
    assert history["port"] == history["jax"]
    assert history["port"][1] == history["port"][0][-1]["multi_source_flushes"]


# --- the front end ----------------------------------------------------------------

class _StubClient:
    """A row-queue client that answers at once: twice each row, from a
    stub bundle (the JAX test's stand-in)."""

    def __init__(self, reply_mod, up=True, status=200):
        self.reply_mod = reply_mod
        self.up = up
        self.status = status
        self.rows_submitted = 0
        self.submissions = []

    def submit(self, X, kind, on_done, trace_id=None):
        if not self.up:
            raise self.reply_mod.DispatcherUnavailable("down")
        X = np.asarray(X)
        self.rows_submitted += int(X.shape[0]) if X.ndim else 1
        self.submissions.append((X, kind))
        on_done(self.reply_mod._Reply(self.status, np.asarray(X, np.float32).ravel() * 2.0,
                                      "k-2026-07-01", "Stub(x2)", "2026-07-01"))

    def dispatcher_up(self):
        return self.up

    def stats(self):
        return {"dispatcher_up": self.up, "requests_submitted": len(self.submissions),
                "rows_submitted": self.rows_submitted,
                "replies_received": len(self.submissions), "failures": 0,
                "in_flight": 0, "slots": 16, "slots_free": 16}


def _port_request(app, method, path, body=b"", content_type="application/json"):
    status, headers, payload = app.handle(method, path, body, content_type)
    return status, payload, headers.get("Retry-After") is not None, \
        headers.get("X-Bodywork-Model-Key")


def _jax_request(app, method, path, body=b"", content_type="application/json"):
    c = app.test_client()
    r = c.open(path, method=method, data=body, content_type=content_type)
    return r.status_code, r.data, "Retry-After" in r.headers, \
        r.headers.get("X-Bodywork-Model-Key")


REQUESTS = {
    "single-json": ("POST", "/score/v1", b'{"X": 21}', "application/json"),
    "single-binary": ("POST", "/score/v1", encode_binary_rows(np.asarray([21.0])),
                      BINARY_CONTENT_TYPE),
    "batch": ("POST", "/score/v1/batch", b'{"X": [1.5, 2.25, 3]}', "application/json"),
    "malformed": ("POST", "/score/v1", b"this is not json", "application/json"),
    "missing-x": ("POST", "/score/v1/batch", b'{"Y": 1}', "application/json"),
    "not-found": ("GET", "/nope", b"", "application/json"),
    "wrong-method": ("GET", "/score/v1", b"", "application/json"),
}


@pytest.mark.parametrize("up", [True, False], ids=["dispatcher-up", "dispatcher-down"])
@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_front_end_answers_the_jax_front_ends_bytes(name, up):
    """The same request through both front ends over the same stub
    client: the same status, bytes, ``Retry-After`` and model-key header;
    a down dispatcher answers the honest 503."""
    method, path, body, content_type = REQUESTS[name]
    got = _port_request(frontend.FrontendApp(_StubClient(rowqueue, up=up)),
                        method, path, body, content_type)
    want = _jax_request(jax_frontend.FrontendApp(_StubClient(jax_rowqueue, up=up)),
                        method, path, body, content_type)
    assert got == want
    if not up and path.startswith("/score") and method == "POST" and name not in (
            "malformed", "missing-x"):
        assert got[0] == 503 and got[2]
        assert json.loads(got[1])["error"] == "scoring dispatcher unavailable; retry shortly"


@pytest.mark.parametrize("status,single", [(200, True), (200, False), (503, True),
                                           (500, False)])
def test_render_reply_equals_jaxs(status, single):
    preds = np.asarray([0.1, 1e-7, 123456.789, -2.5], np.float32)
    reply = (status, preds[:1] if single else preds, "k-2026-07-02", "MLP(3x8)", "2026-07-02")
    got = frontend.FrontendApp(_StubClient(rowqueue)).render_reply(_Reply(*reply), single)
    want = jax_frontend.FrontendApp(_StubClient(jax_rowqueue)).render_reply(
        jax_rowqueue._Reply(*reply), single)
    assert got == want


@pytest.mark.parametrize("up", [True, False])
def test_front_end_health_document_equals_jaxs(up):
    port_app = frontend.FrontendApp(RowQueueClient(RowQueue(CTX, frontends=1, slots=4,
                                                            slot_floats=8), 0))
    jax_queue = jax_rowqueue.RowQueue(CTX, frontends=1, slots=4, slot_floats=8)
    jax_app = jax_frontend.FrontendApp(jax_rowqueue.RowQueueClient(jax_queue, 0))
    for app in (port_app, jax_app):
        app.client.queue.up.value = int(up)
    got = port_app.handle("GET", "/healthz")
    want = jax_app.test_client().get("/healthz")
    assert (got[0], json.loads(got[2])) == (want.status_code, json.loads(want.data))
    assert got[0] == (200 if up else 503)
    assert json.loads(got[2])["transport"]["kind"] == "shm"


def test_shed_before_parse_leaves_the_row_queue_untouched():
    """A request refused by admission is never parsed and never reaches
    the queue: a body that would 400 answers 429."""
    from bodywork_tpu_torch.serve.admission import AdmissionController

    admission = AdmissionController(max_pending=1)
    assert admission.try_admit()  # the budget spent, never released
    client = _StubClient(rowqueue)
    app = frontend.FrontendApp(client, admission=admission)
    status, headers, body = app.handle("POST", "/score/v1", b"this is not json at all",
                                       "application/json")
    assert status == 429 and "Retry-After" in headers
    assert json.loads(body)["error"] == "server over capacity; request shed"
    assert client.rows_submitted == 0 and client.submissions == []


def test_front_end_constants_equal_the_apps_and_jaxs():
    from bodywork_tpu.serve import app as jax_app
    from bodywork_tpu_torch.serve import app as port_app

    assert frontend.RETRY_AFTER_S == port_app.RETRY_AFTER_S == jax_frontend.RETRY_AFTER_S \
        == jax_app.RETRY_AFTER_S
    assert frontend.FAST_PHASE_BUCKETS == port_app.FAST_PHASE_BUCKETS \
        == jax_frontend._FAST_PHASE_BUCKETS
    assert frontend.DISPATCH_TIMEOUT_S == jax_frontend.DISPATCH_TIMEOUT_S


def test_the_front_end_stack_imports_neither_torch_nor_jax():
    """N front ends each paying the torch import would defeat the split:
    the whole front-end stack comes up without it (and without jax)."""
    code = (
        "import sys\n"
        "import bodywork_tpu_torch.serve.wire\n"
        "import bodywork_tpu_torch.serve.rowqueue\n"
        "import bodywork_tpu_torch.serve.frontend\n"
        "import bodywork_tpu_torch.serve.aio\n"
        "import bodywork_tpu_torch.serve.multiproc\n"
        "import bodywork_tpu_torch.serve.netqueue\n"
        "import bodywork_tpu_torch.serve.leadership\n"
        "import bodywork_tpu_torch.serve.httpcore\n"
        "bad = sorted(m for m in ('torch', 'jax') if m in sys.modules)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    result = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            env=env, timeout=120)
    assert result.returncode == 0, result.stderr


# --- the aio engine's row-queue handlers ----------------------------------------------

def _aio_exchange(app, requests_):
    """Serve ``app`` on the aio engine and send each ``(method, path,
    body, content_type)``; returns ``(status, body, headers)`` each."""
    from bodywork_tpu_torch.serve.aio import AioServiceHandle

    handle = AioServiceHandle(app, "127.0.0.1", 0).start()

    async def exchange():
        out = []
        for method, path, body, content_type in requests_:
            reader, writer = await asyncio.open_connection("127.0.0.1", handle.port)
            head = (f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Type: {content_type}\r\n"
                    f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n")
            writer.write(head.encode() + body)
            await writer.drain()
            raw = await reader.read()
            writer.close()
            head, _, payload = raw.partition(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            headers = dict(line.split(": ", 1) for line in lines[1:])
            out.append((int(lines[0].split(" ")[1]), payload, headers))
        return out

    try:
        return asyncio.run(exchange())
    finally:
        handle.stop()


def test_aio_front_end_over_a_real_queue_answers_the_in_process_bytes():
    """The ``aio`` engine's row-queue handlers over a real row queue and
    a dispatcher thread: the bodies the thread engine's front end answers
    for the same requests, the ``rowqueue`` span on a sampled trace."""
    queue = RowQueue(CTX, frontends=1, slots=8, slot_floats=64)
    queue.up.value = 1
    client = RowQueueClient(queue, 0).start()
    server = RowQueueServer(queue)
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            sub = server.poll(0.05)
            if sub is not None:
                server.reply(sub, 200, np.asarray(sub.X, np.float32).ravel() * 2.0,
                             _Bundle(info="Stub(x2)"))

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        app = frontend.FrontendApp(client)
        reqs = [REQUESTS[n] for n in ("single-json", "single-binary", "batch", "malformed")]
        got = _aio_exchange(app, reqs)
        want = [app.handle(*r) for r in reqs]
        assert [(s, b) for s, b, _ in got] == [(s, b) for s, _, b in want]
        assert got[0][2]["X-Bodywork-Model-Key"] == "k-2026-07-01"
        health = _aio_exchange(app, [("GET", "/healthz", b"", "application/json")])[0]
        assert health[0] == 200 and json.loads(health[1])["role"] == "frontend"
    finally:
        stop.set()
        pumper.join(timeout=5)
        client.stop()


def test_aio_front_end_answers_503_when_down_and_sheds_an_exhausted_pool():
    """``DispatcherUnavailable`` answers the honest 503 + Retry-After;
    ``SlotsExhausted`` sheds 429 counted as ``reason="rowqueue"``."""
    from bodywork_tpu_torch.obs import get_registry

    queue = RowQueue(CTX, frontends=1, slots=1, slot_floats=4)
    client = RowQueueClient(queue, 0)  # no reader: the one slot stays held
    app = frontend.FrontendApp(client)
    shed = get_registry().counter("bodywork_tpu_serve_shed_total")
    before = shed.value(reason="rowqueue")
    down = _aio_exchange(app, [REQUESTS["single-json"]])[0]
    assert down[0] == 503 and down[2]["Retry-After"]
    assert json.loads(down[1])["error"] == "scoring dispatcher unavailable; retry shortly"
    queue.up.value = 1
    client.submit(np.float32(1.0), KIND_SINGLE, lambda r: None)  # the pool spent
    status, body, headers = _aio_exchange(app, [REQUESTS["single-json"]])[0]
    assert status == 429 and headers["Retry-After"]
    assert json.loads(body)["error"] == "server over capacity; request shed"
    assert shed.value(reason="rowqueue") == before + 1
    big = _aio_exchange(app, [("POST", "/score/v1/batch",
                               json.dumps({"X": list(range(5))}).encode(),
                               "application/json")])[0]
    assert big[0] == 429  # past one slot's stride: backpressure, not a tear
