"""Multi-process serving replicas on one port (the port of the replica half
of ``bodywork_tpu.serve.multiproc``; reference ``bodywork.yaml:40-42``:
the scoring service is ``replicas: 2``, two independent OS processes
behind a k8s Service).

:class:`MultiProcessService` spawns N worker processes, each loading the
checkpoint serving should run and serving the ``/score/v1`` contract
through the port's own ``thread`` or ``aio`` front end, all listening on
the same port through ``SO_REUSEPORT``: the kernel balances connections
across the live listeners, as a Service spreads them over pods. A killed
worker leaves the others taking every new connection, and the supervisor
respawns it under a backoff budget (:class:`RespawnPolicy`).

Each worker is a *spawned* process, never forked (CUDA does not survive a
fork), and owns its CUDA context on the card, its predictor and its
captured graphs. The supervisor never initializes CUDA. A worker that
cannot start (no card, a bad checkpoint) sends its error back, and
:meth:`MultiProcessService.start` raises it; it never serves on the CPU
unless the caller asked for ``device="cpu"``.

With ``max_pending`` (or the ``aio`` engine's default budget) the workers
admit against one service-wide budget (``serve.admission.SharedBudgetSlot``),
whose dead worker's slot the supervisor zeroes before the respawn. With
``metrics=True`` every worker flushes its registry to a shared directory
and any of them answers ``/metrics`` for the whole service
(``obs.multiproc``).

``frontends=N`` selects the disaggregated topology instead: N torch-free
parse/admission front ends (:func:`_frontend_main`, ``serve.frontend``)
on the shared port feed exactly ONE device-owning dispatcher
(``serve.dispatch.dispatcher_main``, the one process with a CUDA
context) over the shared-memory row-queue (``serve.rowqueue``) or a
TCP/unix socket queue (``serve.netqueue``). ``standby=True`` runs an
active/standby dispatcher pair under a CAS lease (``serve.leadership``).
Front ends are spawned like replicas and never initialize CUDA; the
supervisor arms their shared admission budget, zeroes a dead front end's
slot and reclaims its row-queue slots, and respawns a dead dispatcher.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import queue
import shutil
import signal
import socket
import sys
import tempfile
import threading
import time

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.multiproc")

__all__ = ["MultiProcessService", "RespawnPolicy"]

#: supervisor respawn policy: each consecutive quick death doubles the
#: backoff, and past the budget the slot stays down (the k8s
#: CrashLoopBackOff); a worker alive ``RESTART_RESET_AFTER_S`` clears its
#: slot's streak
RESTART_BUDGET = 5
RESTART_BACKOFF_BASE_S = 0.5
RESTART_BACKOFF_MAX_S = 30.0
RESTART_RESET_AFTER_S = 60.0



def _count_worker_restart(registry=None) -> None:
    from bodywork_tpu_torch.obs import get_registry

    (registry or get_registry()).counter(
        "bodywork_tpu_serve_worker_restarts_total",
        "Serving replica processes respawned by the supervisor",
    ).inc()


def _count_dispatcher_restart(registry=None) -> None:
    from bodywork_tpu_torch.obs import get_registry

    (registry or get_registry()).counter(
        "bodywork_tpu_serve_dispatcher_restarts_total",
        "Device-owning dispatcher processes respawned by the supervisor "
        "(disaggregated serving)",
    ).inc()


def service_store(store_path: str, tenant: str | None = None):
    """The store a serving process reads: the (``BODYWORK_TPU_TENANT``-)
    scoped store at ``store_path``, or ``tenant``'s namespace of it."""
    from bodywork_tpu_torch.store import open_scoped_store, open_store

    if tenant is None:
        return open_scoped_store(store_path)
    from bodywork_tpu_torch.tenancy.namespace import scoped_store

    return scoped_store(open_store(store_path), tenant)


class RespawnPolicy:
    """Respawn decisions for one worker slot: consecutive quick deaths back
    off exponentially; past ``budget`` consecutive deaths the slot is
    exhausted and stays down."""

    def __init__(
        self,
        budget: int = RESTART_BUDGET,
        base_s: float = RESTART_BACKOFF_BASE_S,
        max_s: float = RESTART_BACKOFF_MAX_S,
        reset_after_s: float = RESTART_RESET_AFTER_S,
    ):
        self.budget = budget
        self.base_s = base_s
        self.max_s = max_s
        self.reset_after_s = reset_after_s
        self.consecutive = 0
        self.exhausted = False

    def on_death(self, alive_s: float) -> float | None:
        """Called when the slot's worker is found dead after living
        ``alive_s`` seconds: the backoff before the respawn, or None when
        the budget is exhausted (the slot stays down)."""
        if alive_s >= self.reset_after_s:
            self.consecutive = 0  # it was healthy: a fresh incident
        self.consecutive += 1
        if self.consecutive > self.budget:
            self.exhausted = True
            return None
        return min(self.base_s * 2 ** (self.consecutive - 1), self.max_s)


def _reuseport_socket(host: str, port: int) -> socket.socket:
    """A TCP socket bound with ``SO_REUSEPORT`` (not yet listening)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    sock.bind((host, port))
    return sock


def _worker_main(store_path: str, host: str, port: int, engine: str,
                 watch_interval_s: float | None, buckets, ready,
                 batch_window_ms: float | None = None,
                 batch_max_rows: int | None = None,
                 metrics_dir: str | None = None,
                 server_engine: str = "thread",
                 max_pending: int | None = None,
                 retry_after_max_s: float | None = None,
                 shared_budget=None,
                 slot_index: int = 0,
                 dtype: str = "float32",
                 tuned_config: str | None = None,
                 device=None,
                 tenant: str | None = None):
    """One serving replica, in a spawned process: open the (tenant-scoped)
    store, load the checkpoint onto ``device`` (the card unless the caller
    asked for the CPU), build and warm its predictor, listen on the shared
    port, report its pid on ``ready`` and serve until SIGTERM. A start-up
    error is reported on ``ready`` as ``("error", text)`` and exits 1."""
    try:
        from bodywork_tpu_torch.serve.server import serve_latest_model

        store = service_store(store_path, tenant)
        shared_slot = None
        if shared_budget is not None:
            from bodywork_tpu_torch.serve.admission import SharedBudgetSlot

            shared_slot = SharedBudgetSlot(shared_budget, slot_index)
        handle = serve_latest_model(
            store, host=host, port=port, block=False, engine=engine, device=device,
            buckets=tuple(buckets) if buckets else None, dtype=dtype,
            batch_window_ms=batch_window_ms, batch_max_rows=batch_max_rows,
            server_engine=server_engine, max_pending=max_pending,
            retry_after_max_s=retry_after_max_s, watch_interval_s=watch_interval_s,
            tuned_config=tuned_config, sock=_reuseport_socket(host, port),
            shared_slot=shared_slot, metrics_dir=metrics_dir,
        )
    except Exception as exc:  # the supervisor raises it from start()
        ready.put(("error", f"{type(exc).__name__}: {exc}"))
        sys.exit(1)
    flusher = None
    if metrics_dir is not None:
        from bodywork_tpu_torch.obs import get_registry
        from bodywork_tpu_torch.obs.multiproc import MetricsFlusher

        flusher = MetricsFlusher(get_registry(), metrics_dir).start()
    # the supervisor stops a worker with SIGTERM: unwind through the
    # finally below (watcher, coalescer, flusher's last snapshot)
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(0))
    try:
        ready.put(os.getpid())
        handle.wait()
    finally:
        handle.stop()
        if flusher is not None:
            flusher.stop()
        log.info(f"replica exiting: {json.dumps(exit_report())}")


def exit_report() -> dict:
    """What a replica or a dispatcher leaves in its log as it stops: its
    pid, its kernel launches, its graph cache's counts and, on the card,
    its CUDA memory high-water marks."""
    import torch

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES
    from bodywork_tpu_torch.serve.predictor import GRAPH_CACHE

    report = {"pid": os.getpid(), "launches": dict(LAUNCHES),
              "graph_cache": GRAPH_CACHE.stats()}
    if torch.cuda.is_initialized():
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        report["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    return report


def _frontend_main(queue, host: str, port: int, ready,
                   server_engine: str = "thread",
                   metrics_dir: str | None = None,
                   shared_budget=None,
                   slot_index: int = 0,
                   max_pending: int | None = None,
                   retry_after_max_s: float | None = None,
                   transport: str = "shm",
                   dispatcher_addr=None):
    """One parse/admission front end of the disaggregated split: HTTP
    parse + admission + row-queue handoff, NO model. Deliberately
    torch-free (pinned by a test) — front-end processes must stay cheap
    to spawn and must never touch the card; everything device-shaped
    lives in the single dispatcher (``serve.dispatch.dispatcher_main``).

    ``transport`` selects the queue the handoff rides: ``"shm"`` is the
    shared-memory ``queue`` (same host as the dispatcher); ``"tcp"`` /
    ``"unix"`` connect a :class:`~bodywork_tpu_torch.serve.netqueue.
    NetQueueClient` to ``dispatcher_addr`` instead (``queue`` is then
    ``None`` — there is no arena to share across hosts)."""
    from bodywork_tpu_torch.serve.admission import SharedBudgetSlot, build_admission
    from bodywork_tpu_torch.serve.frontend import FrontendApp

    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(0))
    if transport in ("tcp", "unix"):
        from bodywork_tpu_torch.serve.netqueue import NetQueueClient

        client = NetQueueClient(dispatcher_addr, slot_index).start()
    else:
        from bodywork_tpu_torch.serve.rowqueue import RowQueueClient

        client = RowQueueClient(queue, slot_index).start()
    # the same service-wide admission budget as --workers: each front end
    # holds a slot in the shared array, so max_pending bounds the
    # SERVICE's held work and the supervisor can zero a dead front end's
    # contribution
    shared_slot = None
    if shared_budget is not None:
        shared_slot = SharedBudgetSlot(shared_budget, slot_index)
    admission = build_admission(server_engine, max_pending, retry_after_max_s,
                                shared_slot=shared_slot)
    app = FrontendApp(client, admission=admission, metrics_dir=metrics_dir)
    flusher = None
    if metrics_dir is not None:
        # front ends flush into the same dir as the dispatcher: any front
        # end's /metrics scrape merges the whole fleet, dispatcher-side
        # coalescer occupancy included
        from bodywork_tpu_torch.obs import get_registry
        from bodywork_tpu_torch.obs.multiproc import MetricsFlusher

        flusher = MetricsFlusher(get_registry(), metrics_dir).start()
    sock = _reuseport_socket(host, port)
    if server_engine == "aio":
        from bodywork_tpu_torch.serve.aio import AioServiceHandle

        handle = AioServiceHandle(app, host, port, sock=sock)
    else:
        # the thread engine's handle lives in the torch-free HTTP leaf
        # (serve.server imports torch)
        from bodywork_tpu_torch.serve.httpcore import ServiceHandle

        handle = ServiceHandle(app, host, port, sock=sock)
    try:
        handle.start()
        ready.put(os.getpid())
        handle.wait()
    finally:
        if flusher is not None:
            flusher.stop()
        handle.stop()
        client.stop()


class MultiProcessService:
    """N OS-process serving replicas sharing one ``SO_REUSEPORT`` port.

    ``port=0`` reserves a free port: the supervisor binds without
    listening and holds that socket for the service's life, so the number
    cannot be reused between worker restarts (a bound socket that does
    not listen takes no connections). ``restart=True`` respawns a dead
    worker, keeping the declared replica count. ``device`` is where every
    worker (or the dispatcher) serves: the card unless the caller asks
    for the CPU. ``tenant`` scopes the serving store to a tenant
    namespace (unset: ``BODYWORK_TPU_TENANT``, as the JAX workers read
    it).

    ``frontends=N`` selects the DISAGGREGATED topology instead (mutually
    exclusive with ``--workers``, enforced at the CLI): N model-free,
    torch-free parse/admission front ends (:func:`_frontend_main`) on the
    shared port feed exactly ONE device-owning dispatcher
    (``serve.dispatch.dispatcher_main``) over a shared-memory row-queue.
    The same supervisor keeps both roles alive; a dying dispatcher flips
    the queue down (front ends answer 503 + Retry-After, never wedge)
    and is respawned under the same backoff budget.

    ``transport`` (frontends mode only) moves the handoff off shared
    memory: ``"tcp"`` / ``"unix"`` run the same split over the socket
    row-queue (``serve.netqueue``), the topology the split k8s
    Deployments run across pods, with ``dispatcher_addr`` naming the
    dispatcher's listener (auto-picked on loopback / a temp unix path
    when unset). ``external_dispatcher=True`` runs ONLY the front-end
    half against a dispatcher some other supervisor owns: no local
    dispatcher is spawned or supervised, and dispatcher death shows up as
    the clients' connection loss (503 + Retry-After, reconnect backoff).

    ``standby=True`` (socket transports only) runs an ACTIVE/STANDBY
    dispatcher pair under this supervisor instead of a singleton: both
    candidates warm fully (model, predictor, every bucket's CUDA graph),
    one wins the CAS lease (``serve.leadership``) and binds the listener;
    the other parks campaigning. A dead candidate's lease is CAS-expired
    at the supervisor's FIRST death observation, the standby takes over
    by bumping the fence, and the dead process respawns as a fresh
    candidate. ``frontends=0`` with ``standby=True`` is the ``cli serve
    --role dispatcher --standby`` pair: no local HTTP, two supervised
    candidates serving remote front ends.
    """

    def __init__(
        self,
        store_path: str,
        host: str = "127.0.0.1",
        port: int = 0,
        workers: int = 2,
        engine: str = "auto",
        watch_interval_s: float | None = None,
        buckets: tuple[int, ...] | None = None,
        restart: bool = True,
        startup_timeout_s: float = 120.0,
        batch_window_ms: float | None = None,
        batch_max_rows: int | None = None,
        metrics: bool = False,
        server_engine: str = "thread",
        max_pending: int | None = None,
        retry_after_max_s: float | None = None,
        dtype: str = "float32",
        tuned_config: str | None = None,
        device=None,
        tenant: str | None = None,
        frontends: int | None = None,
        transport: str = "shm",
        dispatcher_addr: str | None = None,
        external_dispatcher: bool = False,
        standby: bool = False,
        leader_ttl_s: float | None = None,
    ):
        from bodywork_tpu_torch.serve.netqueue import (
            SERVE_TRANSPORTS,
            parse_dispatcher_addr,
        )

        if transport not in SERVE_TRANSPORTS:
            raise ValueError(
                f"unknown row-queue transport {transport!r}; "
                f"expected one of {SERVE_TRANSPORTS}"
            )
        if transport != "shm" and frontends is None:
            raise ValueError(
                "socket row-queue transports require the disaggregated "
                "topology (--frontends N); --workers replicas have no "
                "row-queue to carry"
            )
        if external_dispatcher and transport == "shm":
            raise ValueError(
                "an external dispatcher cannot be reached over shared "
                "memory; use --transport tcp or unix"
            )
        if standby and transport == "shm":
            raise ValueError(
                "standby leadership needs a socket transport (tcp/unix): "
                "the shm queue is single-host, where the supervisor "
                "respawn is already the takeover path"
            )
        if standby and external_dispatcher:
            raise ValueError(
                "an external dispatcher is supervised elsewhere; its "
                "standby (if any) belongs to that supervisor"
            )
        if frontends is not None:
            if frontends < 0:
                raise ValueError("front-end count cannot be negative")
            if frontends == 0 and not standby:
                raise ValueError(
                    "a dispatcher-only service (--frontends 0) is the "
                    "standby pair topology; it needs --standby"
                )
            # role split: `workers` counts HTTP processes, which in this
            # topology are the front ends (the dispatcher is extra). 0 is
            # the `serve --role dispatcher --standby` pair.
            workers = frontends
        elif workers < 1:
            raise ValueError(f"need at least one replica, got workers={workers}")
        from bodywork_tpu_torch.serve.server import SERVER_ENGINES

        if server_engine not in SERVER_ENGINES:
            raise ValueError(f"unknown server engine {server_engine!r}; "
                             f"expected one of {SERVER_ENGINES}")
        from bodywork_tpu_torch.serve.predictor import SERVE_DTYPES

        if dtype not in SERVE_DTYPES:
            raise ValueError(f"unknown serving dtype {dtype!r}; "
                             f"expected one of {SERVE_DTYPES}")
        self.store_path = str(store_path)
        self.host = host
        self.workers = workers
        self.engine = engine
        self.watch_interval_s = watch_interval_s
        self.buckets = tuple(buckets) if buckets else None
        self.batch_window_ms = batch_window_ms
        self.batch_max_rows = batch_max_rows
        self.server_engine = server_engine
        self.max_pending = max_pending
        self.retry_after_max_s = retry_after_max_s
        self.dtype = dtype
        #: the device name the workers resolve (the supervisor touches no card)
        self.device = None if device is None else str(device)
        self.tenant = tenant
        if tuned_config == "latest":
            # pinned once, so a replica respawned after `cli tune` writes a
            # newer document resolves the knob set its siblings serve
            from bodywork_tpu_torch.tune.config import _resolve_ref

            pinned = _resolve_ref(service_store(self.store_path, tenant), tuned_config)
            tuned_config = pinned if pinned is not None else tuned_config
        self.tuned_config = tuned_config
        self.frontends = frontends
        if frontends is not None and tuned_config and max_pending is None:
            # max_pending is the ONE tuned knob that is front-end-scoped in
            # the split (admission stays upstream of the queue), but front
            # ends are store-free: the supervisor resolves it here, once,
            # and hands the concrete value down. The dispatcher resolves
            # the dispatcher-scoped knobs itself.
            from bodywork_tpu_torch.tune.config import resolve_serving_knobs

            resolved = resolve_serving_knobs(
                service_store(self.store_path, tenant), tuned_config,
                batch_window_ms=None, batch_max_rows=None,
                buckets=None, max_pending=None,
            )
            max_pending = resolved.max_pending
            self.max_pending = max_pending
        # always on in frontends mode: the dispatcher serves no HTTP, so
        # its metrics are only visible through the shared snapshot dir
        self._metrics_enabled = metrics or frontends is not None
        #: the shared snapshot directory, made in start() (None when off)
        self.metrics_dir: str | None = None
        self.restart = restart
        self.startup_timeout_s = startup_timeout_s
        self._ctx = multiprocessing.get_context("spawn")
        self._queue = None
        #: live dispatcher processes: [] (workers / external mode), one
        #: (the singleton), or an active/standby PAIR (standby mode —
        #: which one leads is the lease's call, not an index's)
        self._dispatchers: list = []
        self.standby = standby
        self.leader_ttl_s = leader_ttl_s
        self._lease_reader = None
        self.transport = transport
        self.external_dispatcher = external_dispatcher
        self.dispatcher_addr = None
        self._unix_dir = None
        if frontends is not None and transport == "shm":
            from bodywork_tpu_torch.serve.rowqueue import RowQueue

            self._queue = RowQueue(self._ctx, frontends)
        elif frontends is not None:
            # socket transports carry no shared arena: the handoff state
            # lives in the dispatcher's listener, which needs an address
            # both halves agree on before either spawns
            if dispatcher_addr is None:
                if external_dispatcher:
                    raise ValueError(
                        "an external dispatcher needs an explicit "
                        "--dispatcher-addr"
                    )
                if transport == "unix":
                    self._unix_dir = tempfile.mkdtemp(prefix="bodywork-tpu-netqueue-")
                    dispatcher_addr = os.path.join(self._unix_dir, "rowqueue.sock")
                else:
                    probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    probe.bind(("127.0.0.1", 0))
                    dispatcher_addr = f"127.0.0.1:{probe.getsockname()[1]}"
                    probe.close()
            self.dispatcher_addr = parse_dispatcher_addr(transport, dispatcher_addr)
        # one admission budget for the fleet, one slot per worker (or
        # front end), made wherever they would arm admission
        self._shared_budget = (
            self._ctx.Array("i", workers)
            if workers > 1 and (max_pending is not None or server_engine == "aio")
            else None
        )
        self._reserved = _reuseport_socket(host, port)
        self.port = self._reserved.getsockname()[1]
        self._procs: list = []
        #: processes spawned and not yet ready (a respawn in flight), which
        #: stop() must end too: the supervisor adopts them only once ready
        self._starting: set = set()
        self._flusher = None
        self._sup_registry = None
        self._stopping = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise, name="replica-supervisor", daemon=True)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/score/v1"

    @property
    def metrics_url(self) -> str | None:
        """The aggregated Prometheus endpoint (None when metrics are off)."""
        if self.metrics_dir is None:
            return None
        return f"http://{self.host}:{self.port}/metrics"

    @property
    def worker_pids(self) -> list[int]:
        return [p.pid for p in self._procs if p.is_alive()]

    def _lease(self):
        """A read/expire handle on the dispatcher-leader lease (standby
        mode), opened at first use: the supervisor resolves the active
        leader and fast-expires the lease of a dispatcher it saw die."""
        if self._lease_reader is None:
            from bodywork_tpu_torch.serve.leadership import DispatcherLease

            self._lease_reader = DispatcherLease(
                service_store(self.store_path, self.tenant), ttl_s=self.leader_ttl_s)
        return self._lease_reader

    @property
    def dispatcher_pid(self) -> int | None:
        """PID of the ACTIVE device-owning dispatcher (frontends mode
        only). In standby mode the lease document says which candidate
        leads; a local alive pid matching its owner wins, else the first
        live candidate (e.g. mid-election)."""
        alive = [p.pid for p in self._dispatchers if p.is_alive()]
        if not alive:
            return None
        if self.standby and len(alive) > 1:
            try:
                doc = self._lease().peek()
            except Exception:  # noqa: BLE001 - an unreadable lease names no leader
                doc = None
            owner = (doc or {}).get("owner") or ""
            parts = owner.rsplit(":", 2)
            if len(parts) == 3 and parts[0] == socket.gethostname():
                try:
                    pid = int(parts[1])
                except ValueError:
                    pid = None
                if pid in alive:
                    return pid
        return alive[0]

    @property
    def dispatcher_pids(self) -> list[int]:
        """Every live dispatcher candidate's pid (one, or the standby pair)."""
        return [p.pid for p in self._dispatchers if p.is_alive()]

    def _spawn_dispatcher(self):
        from bodywork_tpu_torch.serve.dispatch import dispatcher_main

        ready = self._ctx.Queue()
        proc = self._ctx.Process(
            target=dispatcher_main,
            args=(self.store_path, self._queue, ready),
            kwargs=dict(
                engine=self.engine,
                watch_interval_s=self.watch_interval_s,
                buckets=self.buckets,
                batch_window_ms=self.batch_window_ms,
                batch_max_rows=self.batch_max_rows,
                metrics_dir=self.metrics_dir,
                dtype=self.dtype,
                tuned_config=self.tuned_config,
                transport=self.transport,
                dispatcher_addr=self.dispatcher_addr,
                standby=self.standby,
                leader_ttl_s=self.leader_ttl_s,
                device=self.device,
                tenant=self.tenant,
            ),
            daemon=True,
        )
        proc.start()
        self._starting.add(proc)
        return proc, ready

    def _spawn_one(self, slot_index: int = 0):
        ready = self._ctx.Queue()
        if self.frontends is not None:
            proc = self._ctx.Process(
                target=_frontend_main,
                args=(self._queue, self.host, self.port, ready,
                      self.server_engine, self.metrics_dir,
                      self._shared_budget, slot_index,
                      self.max_pending, self.retry_after_max_s,
                      self.transport, self.dispatcher_addr),
                daemon=True,
            )
        else:
            proc = self._ctx.Process(
                target=_worker_main,
                args=(self.store_path, self.host, self.port, self.engine,
                      self.watch_interval_s, self.buckets, ready,
                      self.batch_window_ms, self.batch_max_rows,
                      self.metrics_dir, self.server_engine,
                      self.max_pending, self.retry_after_max_s,
                      self._shared_budget, slot_index, self.dtype,
                      self.tuned_config, self.device, self.tenant),
                daemon=True,
            )
        proc.start()
        self._starting.add(proc)
        return proc, ready

    def _wait_ready(self, ready, proc) -> None:
        try:
            self._await_ready(ready, proc)
        finally:
            self._starting.discard(proc)

    def _await_ready(self, ready, proc) -> None:
        deadline = time.monotonic() + self.startup_timeout_s
        while True:
            try:
                message = ready.get(timeout=1.0)
            except queue.Empty:
                if self._stopping.is_set():
                    proc.terminate()
                    raise RuntimeError("service stopping during a replica's start-up") \
                        from None
                if not proc.is_alive():
                    raise RuntimeError(
                        f"serving replica died during startup (exitcode={proc.exitcode})"
                    ) from None
                if time.monotonic() > deadline:
                    proc.terminate()
                    raise TimeoutError(
                        f"serving replica not ready within {self.startup_timeout_s:.0f}s"
                    ) from None
                continue
            if isinstance(message, tuple) and message[0] == "error":
                proc.join(timeout=10)
                raise RuntimeError(f"serving replica failed to start: {message[1]}")
            return

    def start(self) -> "MultiProcessService":
        if self._metrics_enabled and self.metrics_dir is None:
            self.metrics_dir = tempfile.mkdtemp(prefix="bodywork-tpu-obs-")
        spawned: list = []
        try:
            if self.frontends is not None and not self.external_dispatcher:
                # dispatcher first: its readiness IS model readiness — once
                # it arms `queue.up`, the fast-booting front ends answer
                # /healthz 200 from their first request. In standby mode
                # TWO candidates spawn; each signals ready once WARM,
                # before the election, so both waits return.
                for _ in range(2 if self.standby else 1):
                    proc, dready = self._spawn_dispatcher()
                    self._dispatchers.append(proc)
                    self._wait_ready(dready, proc)
            for i in range(self.workers):
                spawned.append(self._spawn_one(i))
            for proc, ready in spawned:
                self._wait_ready(ready, proc)
        except BaseException:
            # a replica that died or timed out during start-up: stop its
            # siblings (and the dispatchers), then remove the snapshot
            # directory (after the joins, so no final flush races it)
            spawned.extend((p, None) for p in self._dispatchers)
            self._dispatchers = []
            for proc, _ready in spawned:
                if proc.is_alive():
                    proc.terminate()
            for proc, _ready in spawned:
                proc.join(timeout=10)
            if self.metrics_dir is not None:
                shutil.rmtree(self.metrics_dir, ignore_errors=True)
                self.metrics_dir = None
            self._release()
            raise
        self._procs = [p for p, _ in spawned]
        if self.metrics_dir is not None:
            # the respawn counters are the supervisor's: a registry of its
            # own, flushed beside the workers' (never the caller's
            # process-global one)
            from bodywork_tpu_torch.obs import Registry
            from bodywork_tpu_torch.obs.multiproc import MetricsFlusher

            self._sup_registry = Registry()
            self._flusher = MetricsFlusher(self._sup_registry, self.metrics_dir).start()
        self._supervisor.start()
        role = "front-end" if self.frontends is not None else "replica"
        log.info(
            f"{self.workers} {role} process(es) listening on {self.url} "
            f"(SO_REUSEPORT, pids {self.worker_pids})"
            + (f"; dispatcher pid(s) {[p.pid for p in self._dispatchers]}"
               + (" (active/standby pair)" if self.standby else "")
               if self._dispatchers else ""))
        return self

    def _supervise(self) -> None:
        slots = [{"policy": RespawnPolicy(), "spawned_at": time.monotonic(),
                  "respawn_at": None} for _ in self._procs]
        dslots = [{"policy": RespawnPolicy(), "spawned_at": time.monotonic(),
                   "respawn_at": None} for _ in self._dispatchers]
        while not self._stopping.wait(0.5):
            now = time.monotonic()
            for d, dslot in enumerate(dslots):
                if self._stopping.is_set():
                    break
                self._supervise_dispatcher(d, dslot, now)
            for i, proc in enumerate(self._procs):
                if self._stopping.is_set():
                    break
                slot = slots[i]
                if proc.is_alive() or slot["policy"].exhausted:
                    continue
                if slot["respawn_at"] is None:
                    # first sight of this death: reclaim the budget the
                    # worker held (its in-flight requests died with it),
                    # whether or not it respawns
                    if self._shared_budget is not None:
                        from bodywork_tpu_torch.serve.admission import SharedBudgetSlot

                        SharedBudgetSlot.clear(self._shared_budget, i)
                    # a dead front end's pending map died with it: reclaim
                    # the row-queue slots it held, or every crash shrinks
                    # the shared pool toward total 429 shedding
                    if self._queue is not None:
                        freed = self._queue.reclaim_frontend(i)
                        if freed:
                            log.warning(f"reclaimed {freed} row-queue slot(s) "
                                        f"from dead front-end {i}")
                    alive_s = now - slot["spawned_at"]
                    delay = slot["policy"].on_death(alive_s)
                    if delay is None:
                        log.error(
                            f"replica slot {i} (pid {proc.pid}) died "
                            f"{slot['policy'].consecutive} consecutive time(s) within "
                            f"{RESTART_RESET_AFTER_S:.0f}s of spawn; restart budget "
                            f"({slot['policy'].budget}) exhausted — leaving the slot down")
                        continue
                    log.warning(
                        f"replica pid {proc.pid} died (exitcode={proc.exitcode}, "
                        f"alive {alive_s:.1f}s)"
                        + (f"; respawning in {delay:.1f}s (streak "
                           f"{slot['policy'].consecutive})" if self.restart else ""))
                    if not self.restart:
                        slot["policy"].exhausted = True  # reported once
                        continue
                    slot["respawn_at"] = now + delay
                    continue
                if now < slot["respawn_at"]:
                    continue  # backing off
                slot["respawn_at"] = None
                new_proc, ready = self._spawn_one(i)
                _count_worker_restart(self._sup_registry)
                try:
                    self._wait_ready(ready, new_proc)
                except (RuntimeError, TimeoutError) as exc:
                    # counts against the slot's budget on the next tick;
                    # spawned_at is now, after the wait, so a worker that
                    # hangs at start-up cannot launder its streak
                    log.error(f"replica respawn failed: {exc!r}")
                    self._procs[i] = new_proc
                    slot["spawned_at"] = time.monotonic()
                    continue
                self._procs[i] = new_proc
                slot["spawned_at"] = time.monotonic()
                log.info(f"replica respawned as pid {new_proc.pid}")

    def _supervise_dispatcher(self, d: int, slot, now: float) -> None:
        """One supervision tick for dispatcher slot ``d`` (frontends
        mode). The replica slots' budget and backoff, plus the liveness
        contract the front ends depend on: the FIRST observation of a
        death downs the queue and bumps its epoch, failing every in-flight
        front-end wait into 503 + Retry-After at once. In standby mode it
        also CAS-expires the dead leader's lease, so the warm standby
        takes over on its next poll instead of waiting out the TTL."""
        proc = self._dispatchers[d]
        if proc.is_alive() or slot["policy"].exhausted:
            return
        if slot["respawn_at"] is None:
            if self._queue is not None:
                self._queue.up.value = 0
                self._queue.epoch.value += 1
            # (socket transports need no supervisor-side down-flip: the
            # dying dispatcher's connections break, and the clients HOLD
            # their in-flight waits for failover resubmission)
            if self.standby:
                # safe: evidence of a dead process on THIS host, never a
                # partition guess; a dead STANDBY owns no lease (no-op)
                try:
                    self._lease().expire_dead_owner(socket.gethostname(), proc.pid)
                except Exception as exc:  # noqa: BLE001 - the TTL covers it
                    log.warning(f"could not fast-expire the dead dispatcher's "
                                f"lease (TTL expiry will cover it): {exc!r}")
            alive_s = now - slot["spawned_at"]
            delay = slot["policy"].on_death(alive_s)
            if delay is None:
                log.error(
                    f"dispatcher (pid {proc.pid}) died "
                    f"{slot['policy'].consecutive} consecutive time(s); "
                    f"restart budget ({slot['policy'].budget}) exhausted "
                    "— front-ends will answer 503 until restarted")
                return
            log.warning(
                f"dispatcher pid {proc.pid} died (exitcode={proc.exitcode}, "
                f"alive {alive_s:.1f}s)"
                + (f"; respawning in {delay:.1f}s (streak "
                   f"{slot['policy'].consecutive})" if self.restart else ""))
            if not self.restart:
                slot["policy"].exhausted = True
                return
            slot["respawn_at"] = now + delay
            return
        if now < slot["respawn_at"]:
            return
        slot["respawn_at"] = None
        new_proc, ready = self._spawn_dispatcher()
        _count_dispatcher_restart(self._sup_registry)
        try:
            # the respawned dispatcher re-arms `queue.up` itself, only
            # after its model is loaded and its graphs captured (standby
            # mode: a fresh WARM candidate, parked campaigning)
            self._wait_ready(ready, new_proc)
        except (RuntimeError, TimeoutError) as exc:
            log.error(f"dispatcher respawn failed: {exc!r}")
            self._dispatchers[d] = new_proc  # dead; the next tick backs off
            slot["spawned_at"] = time.monotonic()
            return
        self._dispatchers[d] = new_proc
        slot["spawned_at"] = time.monotonic()
        log.info(f"dispatcher respawned as pid {new_proc.pid}")

    def kill_worker(self, pid: int) -> None:
        """SIGKILL one replica (the fault-injection hook of tests and drills)."""
        os.kill(pid, signal.SIGKILL)

    def kill_dispatcher(self) -> None:
        """SIGKILL the active dispatcher (the chaos hook: the split
        fleet's worst single fault)."""
        pid = self.dispatcher_pid
        if pid is None:
            raise RuntimeError("no live dispatcher to kill")
        os.kill(pid, signal.SIGKILL)

    def wait(self) -> None:
        """Block until :meth:`stop` is called from another thread or the
        process is signalled (the pod-entrypoint serve loop)."""
        self._stopping.wait()

    def stop(self) -> None:
        self._stopping.set()
        procs = list(self._procs) + list(self._dispatchers) + list(self._starting)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():  # a process wedged past its grace
                proc.kill()
                proc.join(timeout=5)
        if self._supervisor.ident is not None:
            self._supervisor.join(timeout=5)
        if self._flusher is not None:
            self._flusher.stop()
            self._flusher = None
        self._release()
        if self.metrics_dir is not None:
            shutil.rmtree(self.metrics_dir, ignore_errors=True)
        log.info("multi-process scoring service stopped")

    def _release(self) -> None:
        """Close the reserved port, the row-queue and the unix socket's
        directory."""
        if self._queue is not None:
            self._queue.close()
        self._reserved.close()
        if self._unix_dir is not None:
            shutil.rmtree(self._unix_dir, ignore_errors=True)

    def __enter__(self) -> "MultiProcessService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
