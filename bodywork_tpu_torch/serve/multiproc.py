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

The disaggregated topology of the JAX module (``frontends``,
``transport``, ``role``, ``standby``: a device-owning dispatcher behind
front-end processes) is ROADMAP Queue 1 item 15's second half; the port
refuses those arguments by name.
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

#: the split topology's arguments, refused until the item that ports it
_SPLIT_TOPOLOGY = ("frontends", "transport", "dispatcher_addr", "external_dispatcher",
                   "standby", "leader_ttl_s")


def _count_worker_restart(registry=None) -> None:
    from bodywork_tpu_torch.obs import get_registry

    (registry or get_registry()).counter(
        "bodywork_tpu_serve_worker_restarts_total",
        "Serving replica processes respawned by the supervisor",
    ).inc()


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
        from bodywork_tpu_torch.store import open_scoped_store, open_store

        if tenant is None:
            store = open_scoped_store(store_path)
        else:
            from bodywork_tpu_torch.tenancy.namespace import scoped_store

            store = scoped_store(open_store(store_path), tenant)
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
        log.info(f"replica exiting: {json.dumps(_exit_report())}")


def _exit_report() -> dict:
    """What a replica leaves in its log as it stops: its pid, its kernel
    launches and, on the card, its CUDA memory high-water marks."""
    import torch

    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES

    report = {"pid": os.getpid(), "launches": dict(LAUNCHES)}
    if torch.cuda.is_initialized():
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        report["max_memory_reserved"] = torch.cuda.max_memory_reserved()
    return report


class MultiProcessService:
    """N OS-process serving replicas sharing one ``SO_REUSEPORT`` port.

    ``port=0`` reserves a free port: the supervisor binds without
    listening and holds that socket for the service's life, so the number
    cannot be reused between worker restarts (a bound socket that does
    not listen takes no connections). ``restart=True`` respawns a dead
    worker, keeping the declared replica count. ``device`` is where every
    worker serves: the card unless the caller asks for the CPU.
    ``tenant`` scopes the workers' store to a tenant namespace (unset:
    ``BODYWORK_TPU_TENANT``, as the JAX workers read it)."""

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
        **split_topology,
    ):
        for name, value in split_topology.items():
            if name not in _SPLIT_TOPOLOGY:
                raise TypeError(f"unexpected keyword argument {name!r}")
            if value not in (None, False, "shm"):
                raise NotImplementedError(
                    f"{name}={value!r} selects the disaggregated serving topology, which "
                    "the port does not run until ROADMAP Queue 1 item 15 (its second half)"
                )
        if workers < 1:
            raise ValueError(f"need at least one replica, got workers={workers}")
        from bodywork_tpu_torch.serve.predictor import SERVE_DTYPES
        from bodywork_tpu_torch.serve.server import SERVER_ENGINES

        if server_engine not in SERVER_ENGINES:
            raise ValueError(f"unknown server engine {server_engine!r}; "
                             f"expected one of {SERVER_ENGINES}")
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
            from bodywork_tpu_torch.store import open_scoped_store, open_store
            from bodywork_tpu_torch.tune.config import _resolve_ref

            if tenant is None:
                store = open_scoped_store(self.store_path)
            else:
                from bodywork_tpu_torch.tenancy.namespace import scoped_store

                store = scoped_store(open_store(self.store_path), tenant)
            pinned = _resolve_ref(store, tuned_config)
            tuned_config = pinned if pinned is not None else tuned_config
        self.tuned_config = tuned_config
        self._metrics_enabled = metrics
        #: the shared snapshot directory, made in start() (None when off)
        self.metrics_dir: str | None = None
        self.restart = restart
        self.startup_timeout_s = startup_timeout_s
        self._ctx = multiprocessing.get_context("spawn")
        # one admission budget for the fleet, one slot per worker, made
        # wherever the workers would arm admission
        self._shared_budget = (
            self._ctx.Array("i", workers)
            if workers > 1 and (max_pending is not None or server_engine == "aio")
            else None
        )
        self._reserved = _reuseport_socket(host, port)
        self.port = self._reserved.getsockname()[1]
        self._procs: list = []
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

    def _spawn_one(self, slot_index: int = 0):
        ready = self._ctx.Queue()
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
        return proc, ready

    def _wait_ready(self, ready, proc) -> None:
        deadline = time.monotonic() + self.startup_timeout_s
        while True:
            try:
                message = ready.get(timeout=1.0)
            except queue.Empty:
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
            for i in range(self.workers):
                spawned.append(self._spawn_one(i))
            for proc, ready in spawned:
                self._wait_ready(ready, proc)
        except BaseException:
            # a replica that died or timed out during start-up: stop its
            # siblings, then remove the snapshot directory (after the joins,
            # so no final flush races the removal)
            for proc, _ready in spawned:
                if proc.is_alive():
                    proc.terminate()
            for proc, _ready in spawned:
                proc.join(timeout=10)
            if self.metrics_dir is not None:
                shutil.rmtree(self.metrics_dir, ignore_errors=True)
                self.metrics_dir = None
            self._reserved.close()
            raise
        self._procs = [p for p, _ in spawned]
        if self.metrics_dir is not None:
            # the respawn counter is the supervisor's: a registry of its
            # own, flushed beside the workers' (never the caller's
            # process-global one)
            from bodywork_tpu_torch.obs import Registry
            from bodywork_tpu_torch.obs.multiproc import MetricsFlusher

            self._sup_registry = Registry()
            self._flusher = MetricsFlusher(self._sup_registry, self.metrics_dir).start()
        self._supervisor.start()
        log.info(f"{self.workers} replica process(es) listening on {self.url} "
                 f"(SO_REUSEPORT, pids {self.worker_pids})")
        return self

    def _supervise(self) -> None:
        slots = [{"policy": RespawnPolicy(), "spawned_at": time.monotonic(),
                  "respawn_at": None} for _ in self._procs]
        while not self._stopping.wait(0.5):
            now = time.monotonic()
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

    def kill_worker(self, pid: int) -> None:
        """SIGKILL one replica (the fault-injection hook of tests and drills)."""
        os.kill(pid, signal.SIGKILL)

    def wait(self) -> None:
        """Block until :meth:`stop` is called from another thread or the
        process is signalled (the pod-entrypoint serve loop)."""
        self._stopping.wait()

    def stop(self) -> None:
        self._stopping.set()
        procs = list(self._procs)
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
        for proc in procs:
            proc.join(timeout=10)
            if proc.is_alive():  # a worker wedged past its grace
                proc.kill()
                proc.join(timeout=5)
        if self._supervisor.ident is not None:
            self._supervisor.join(timeout=5)
        if self._flusher is not None:
            self._flusher.stop()
            self._flusher = None
        self._reserved.close()
        if self.metrics_dir is not None:
            shutil.rmtree(self.metrics_dir, ignore_errors=True)
        log.info("multi-process scoring service stopped")

    def __enter__(self) -> "MultiProcessService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
