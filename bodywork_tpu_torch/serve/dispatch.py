"""The device-owning dispatcher of the disaggregated serving split (the
port of ``bodywork_tpu.serve.dispatch``).

``serve --frontends N`` runs exactly ONE of these processes per service
(two, active and warm standby, under ``--standby``). It is the one
process with a CUDA context: it owns the predictor and its captured
graphs, the canary bundles, the checkpoint watcher, the
prediction-sanity firewall, and the :class:`~bodywork_tpu_torch.serve.
batcher.RequestCoalescer` — and serves the row-queue (``serve.rowqueue``
over shared memory, ``serve.netqueue`` over a socket) instead of HTTP.
The N front-end processes (``serve.frontend``) parse and admit; this
process scores.

Why the coalescer moves here: under ``--workers N`` each SO_REUSEPORT
replica coalesces only its own kernel-balanced connection share, so
scale-out FRAGMENTS batches. Dispatcher-side, the coalescer sees the
union of every front end's rows: adding front ends CONCENTRATES batches
instead. Each submission is tagged with its front-end id (``source=``),
so the coalescer's flush accounting shows cross-front-end merging, and
``bodywork_tpu_serve_batch_occupancy_ratio`` describes service-wide
batch formation.

Coalescing therefore defaults ON here (the in-process engines keep their
opt-in default); an explicit ``batch_window_ms=0`` still disables it.

Scoring semantics are the in-process path's, run against the same
``ScoringApp``: canary routing by the same seeded hash, stream
accounting, coalescer-saturated fallback to direct dispatch, firewall
before any prediction is written back. The reply carries predictions +
the ANSWERING bundle's identity; the front end renders bytes from them
through the shared wire templates — which is how disaggregated responses
stay byte-identical to in-process ones.

Liveness: the supervisor (``serve.multiproc``) clears ``queue.up`` and
bumps ``queue.epoch`` when this process dies, which fails every
in-flight front-end wait into 503 + Retry-After; on respawn this module
re-arms ``up`` only after the model is loaded and every bucket's graph
is captured. Stale descriptors from before the death are dropped by the
generation guard — a respawned dispatcher can never tear a response.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import time

import numpy as np

from bodywork_tpu_torch.serve.rowqueue import KIND_SINGLE, RowQueueServer
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("serve.dispatch")

__all__ = ["DispatchServer", "dispatcher_main"]


class DispatchServer:
    """Pumps the row-queue into a :class:`~bodywork_tpu_torch.serve.app.
    ScoringApp`: poll a submission, score it exactly as the in-process
    engines would, reply with predictions + the answering bundle."""

    def __init__(self, app, queue, server=None):
        from bodywork_tpu_torch.serve.app import PredictionSanityError
        from bodywork_tpu_torch.serve.batcher import CoalescerSaturated

        self.app = app
        # transport-agnostic: any server with the RowQueueServer
        # poll/reply surface pumps here (serve.netqueue passes the
        # socket one for the cross-host split)
        self.server = server if server is not None else RowQueueServer(queue)
        self._sanity_error = PredictionSanityError
        self._saturated = CoalescerSaturated
        self._stopping = False

    def stop(self) -> None:
        self._stopping = True

    def serve_forever(self, poll_timeout_s: float = 0.2) -> None:
        while not self._stopping:
            sub = self.server.poll(poll_timeout_s)
            if sub is not None:
                self.process(sub)

    # -- scoring -----------------------------------------------------------
    def process(self, sub) -> None:
        """Score one submission. Every exit path writes a reply — a
        front end must never be left waiting on a slot this process has
        already given up on."""
        app = self.app
        try:
            X = sub.X
            served, stream = app.route_stream(X)
            if served is None:
                self.server.reply(sub, 503)
                return
            if app.stream_metrics_active():
                app.count_stream_request(served, stream)
            if sub.kind == KIND_SINGLE:
                X2 = np.array(X, ndmin=2)  # scalar -> (1, 1), as the reference
                if app.batcher is not None and X2.shape[0] == 1:
                    try:
                        # tagged with the submitting front end: the flush
                        # accounting shows batches merging rows ACROSS
                        # front ends (the split's whole point)
                        app.batcher.submit_nowait(
                            served, X2[0],
                            on_done=lambda s, sub=sub, served=served,
                            stream=stream, X2=X2: self._coalesced_done(
                                sub, served, stream, X2, s
                            ),
                            source=f"frontend-{sub.frontend_id}",
                        )
                        return  # replied from the coalescer's callback
                    except self._saturated:
                        app._m_fallbacks.inc()
                predictions = self._predict(served, X2)
                prediction0 = float(np.asarray(predictions).ravel()[0])
                self._finish_single(sub, served, stream, X2, prediction0)
            else:
                X2 = X if X.ndim else X[None]
                predictions = self._predict(served, X2)
                reason = app.sanity_reason(served, predictions)
                if reason is not None:
                    served, predictions = app.firewall(
                        served, stream, X2, predictions, reason
                    )
                self.server.reply(sub, 200, predictions, served)
        except self._sanity_error:
            # production non-finite: the zero-garbage guarantee holds by
            # 500, exactly as in-process (app.firewall already counted)
            self.server.reply(sub, 500)
        except Exception as exc:
            log.error(f"dispatcher failed scoring a submission: {exc!r}")
            self.server.reply(sub, 500)

    def _predict(self, served, X):
        t0 = time.perf_counter()
        try:
            return served.predictor.predict(X)
        finally:
            self.app._m_dispatch.observe(time.perf_counter() - t0)

    def _coalesced_done(self, sub, served, stream, X2, submission) -> None:
        """Runs on the coalescer's dispatcher thread. A batch error maps
        to the same 500 the in-process engines answer."""
        try:
            if submission.error is not None:
                self.server.reply(sub, 500)
                return
            self._finish_single(sub, served, stream, X2, submission.result)
        except Exception as exc:
            log.error(f"dispatcher reply after coalesced batch failed: {exc!r}")
            self.server.reply(sub, 500)

    def _finish_single(self, sub, served, stream, X2, prediction0) -> None:
        """Firewall + reply for a single-row prediction (both the
        coalesced and the direct path end here)."""
        app = self.app
        reason = app.sanity_reason(served, prediction0)
        if reason is not None:
            try:
                served, fallback = app.firewall(
                    served, stream, X2, prediction0, reason
                )
            except self._sanity_error:
                self.server.reply(sub, 500)
                return
            prediction0 = float(np.asarray(fallback).ravel()[0])
        self.server.reply(sub, 200, [prediction0], served)


def dispatcher_main(store_path: str, queue, ready,
                    engine: str = "auto",
                    watch_interval_s: float | None = None,
                    buckets=None,
                    batch_window_ms: float | None = None,
                    batch_max_rows: int | None = None,
                    metrics_dir: str | None = None,
                    dtype: str = "float32",
                    tuned_config: str | None = None,
                    transport: str = "shm",
                    dispatcher_addr=None,
                    standby: bool = False,
                    leader_ttl_s: float | None = None,
                    device=None,
                    tenant: str | None = None):
    """The dispatcher process entrypoint (``multiproc._worker_main`` minus
    HTTP): load the serving checkpoint onto ``device`` (the card unless
    the caller asked for the CPU; without CUDA it raises), build and warm
    the predictor (``auto`` at width 1024 is ``kernel``, every bucket a
    captured graph), arm the dispatcher-side coalescer, pump the
    row-queue. ``up`` flips to 1 only once a model is loaded — front-end
    ``/healthz`` stays 503 until the service can actually score.

    ``transport`` selects the queue the dispatcher serves: ``"shm"``
    pumps the shared-memory ``queue`` (same-host fleet); ``"tcp"`` /
    ``"unix"`` bind a :class:`~bodywork_tpu_torch.serve.netqueue.
    NetQueueServer` at ``dispatcher_addr`` instead, and ``queue`` may be
    ``None`` (the standalone k8s dispatcher Deployment has no shm arena
    to share). ``ready`` may be ``None`` too when there is no supervising
    parent; a start-up error is reported on it as ``("error", text)``.

    ``standby=True`` (socket transports only) runs this dispatcher as a
    WARM leadership candidate (``serve.leadership``): load the model,
    capture every bucket's graph, signal ``ready`` — then block
    campaigning for the CAS lease on the artefact store and only bind
    the listen address after WINNING it, announcing the lease fence in
    every HELLO. Takeover therefore captures nothing: the standby's only
    cold step is the bind. A lost lease (renew fails past TTL) stops the
    serve loop so the process exits and respawns as a fresh candidate
    rather than serving as a zombie.

    The process logs ``dispatcher ready: {...}`` once warm and
    ``dispatcher exiting: {...}`` as it stops (``multiproc.exit_report``:
    pid, kernel launches, graph-cache counts, CUDA memory high-water
    marks), as a ``--workers`` replica logs its exit."""
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(0))
    try:
        from bodywork_tpu_torch.device import resolve_device
        from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key
        from bodywork_tpu_torch.serve.app import create_app
        from bodywork_tpu_torch.serve.batcher import DEFAULT_WINDOW_MS
        from bodywork_tpu_torch.serve.multiproc import service_store
        from bodywork_tpu_torch.serve.server import build_serving_predictor, registry_bounds

        dev = resolve_device(device)
        store = service_store(store_path, tenant)
        # the tuned document's serving knobs are DISPATCHER-SCOPED in the
        # split (tune.config.DISPATCHER_SCOPED_KNOBS): window/max_rows
        # shape the one coalescer that exists, buckets shape the one
        # predictor. max_pending is applied by the SUPERVISOR to the
        # front ends' shared admission budget — admission must stay
        # upstream of the queue.
        tuned_digest = None
        if tuned_config:
            from bodywork_tpu_torch.tune.config import resolve_serving_knobs

            resolved = resolve_serving_knobs(
                store, tuned_config,
                batch_window_ms=batch_window_ms,
                batch_max_rows=batch_max_rows,
                buckets=tuple(buckets) if buckets else None,
                max_pending=None,
            )
            batch_window_ms = resolved.batch_window_ms
            batch_max_rows = resolved.batch_max_rows
            buckets = resolved.buckets
            tuned_digest = resolved.tuned_digest
        served_key, served_source = resolve_serving_key(store)
        model, model_date = load_model(store, served_key, device=dev)
        predictor, _served_dtype = build_serving_predictor(
            store, model, engine, buckets=tuple(buckets) if buckets else None,
            dtype=dtype,
        )
        # coalescing defaults ON dispatcher-side (see module docstring);
        # explicit 0 disables
        window = batch_window_ms if batch_window_ms is not None else DEFAULT_WINDOW_MS
        app = create_app(model, model_date, predictor=predictor,
                         batch_window_ms=window,
                         batch_max_rows=batch_max_rows,
                         metrics_dir=metrics_dir,
                         model_key=served_key, model_source=served_source,
                         model_bounds=registry_bounds(store, served_key))
        app.tuned_config_digest = tuned_digest
    except Exception as exc:  # the supervisor raises it from start()
        if ready is None:
            raise
        ready.put(("error", f"{type(exc).__name__}: {exc}"))
        sys.exit(1)
    flusher = None
    if metrics_dir is not None:
        # the dispatcher's metrics (coalescer occupancy, handoff
        # histogram, queue depth) flush into the shared dir, so ANY
        # front end's /metrics scrape exposes them service-wide
        from bodywork_tpu_torch.obs import get_registry
        from bodywork_tpu_torch.obs.multiproc import MetricsFlusher

        flusher = MetricsFlusher(get_registry(), metrics_dir).start()
    watcher = None
    if watch_interval_s:
        from bodywork_tpu_torch.ops.slo import SloWatchdog, policy_from_env
        from bodywork_tpu_torch.serve.reload import CheckpointWatcher

        watcher = CheckpointWatcher(
            app, store, poll_interval_s=watch_interval_s,
            engine=engine, served_key=served_key,
            buckets=tuple(buckets) if buckets else None,
            slo_watchdog=SloWatchdog(store, [app], policy=policy_from_env()),
            dtype=dtype, device=dev,
        ).start()
    net_server = None
    election = None
    try:
        if standby:
            if transport not in ("tcp", "unix"):
                raise ValueError(
                    "standby leadership needs a socket transport "
                    "(tcp/unix) — the shm queue is single-host, its "
                    "supervisor respawn is already the takeover"
                )
            from bodywork_tpu_torch.serve.leadership import LeaderElection

            # WARM standby: everything above (model, predictor, captured
            # graphs, coalescer) is already paid. Signal ready BEFORE
            # campaigning — the losing candidate parks here and must
            # not trip the supervisor's startup timeout.
            _log_ready_launches()
            if ready is not None:
                ready.put(os.getpid())
            addr_str = (
                dispatcher_addr[1] if dispatcher_addr[0] == "unix"
                else f"{dispatcher_addr[1]}:{dispatcher_addr[2]}"
            )
            election = LeaderElection(
                store, ttl_s=leader_ttl_s, address=addr_str,
            )
            log.info(
                "dispatcher warm, campaigning for the serve lease "
                f"(owner {election.lease.owner})"
            )
            election.campaign()
            from bodywork_tpu_torch.serve.netqueue import NetQueueServer

            # bind only AFTER winning: the listen address itself is the
            # readiness signal (k8s tcpSocket probe routes to the
            # leader), and the HELLO fence refuses zombie ex-leaders
            net_server = NetQueueServer(
                dispatcher_addr, fence=election.fence
            )
            dispatch = DispatchServer(app, queue, server=net_server)
            # a lost lease stops the serve loop: exit and re-candidate
            # beats serving split-brain
            election.on_lost = dispatch.stop
            election.start_renewer()
        elif transport in ("tcp", "unix"):
            from bodywork_tpu_torch.serve.netqueue import NetQueueServer

            # bind BEFORE signalling ready: a front end told to connect
            # must find a listener, not a race
            net_server = NetQueueServer(dispatcher_addr)
            dispatch = DispatchServer(app, queue, server=net_server)
        else:
            dispatch = DispatchServer(app, queue)
        if queue is not None:
            queue.up.value = 1
        if not standby:
            _log_ready_launches()
            if ready is not None:
                ready.put(os.getpid())
        log.info(
            f"dispatcher serving the {transport} row-queue "
            f"(model {served_key}, window={window}ms"
            + (f", fence {election.fence}" if election else "")
            + ")"
        )
        dispatch.serve_forever()
    finally:
        if queue is not None:
            queue.up.value = 0
        if election is not None:
            election.stop()
        if net_server is not None:
            net_server.close()
        if watcher is not None:
            watcher.stop()
        if flusher is not None:
            flusher.stop()
        app.close()
        from bodywork_tpu_torch.serve.multiproc import exit_report

        log.info(f"dispatcher exiting: {json.dumps(exit_report())}")


def _log_ready_launches() -> None:
    """The warm dispatcher's report before its first request (pid, the
    warm-up's kernel launches, the graph cache's counts): the baseline
    against which its exit report's launches rise, and against which a
    standby's graph captures must not move at takeover."""
    from bodywork_tpu_torch.serve.multiproc import exit_report

    log.info(f"dispatcher ready: {json.dumps(exit_report())}")
