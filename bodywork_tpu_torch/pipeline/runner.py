"""Local in-process pipeline runner (the port of
``bodywork_tpu.pipeline.runner``; reference C1/C10 behaviour).

Runs a :class:`PipelineSpec`'s DAG for one simulated day per
:meth:`LocalRunner.run_day`, the in-process stand-in for Bodywork
materialising the DAG as k8s Jobs and Deployments, with the reference's
orchestrator guarantees:

- a batch stage gets ``1 + retries`` attempts (``bodywork.yaml:21``) and
  a completion deadline (``bodywork.yaml:20``); each attempt runs on a
  worker thread and writes through its own store epoch, which the runner
  revokes when it abandons a timed-out attempt, so a late write raises
  instead of landing (``store.epoch``). A deterministic error (a
  ``ValueError``, ``TypeError``, ...) fails the stage without retrying;
- a service stage gets a start and a health gate that polls ``/healthz``
  until ``max_startup_time_s`` (``bodywork.yaml:39``, the k8s readiness
  probe);
- stages within one DAG step run concurrently, steps in order;
- the model registry's promotion gate runs at the step barrier once every
  train stage has finished, before any later step resolves what to
  serve: today's candidate is promoted to the ``production`` alias or
  rejected, so a bad retrain never takes traffic. An incremental
  candidate is gated with shadow evaluation, and a rejected one is
  replaced the same day by a full refit, gated again;
- a failed stage fails the day with a :class:`StageFailure` naming it,
  and services are stopped at day end either way.

- every day is journalled (``pipeline.journal``) unless asked not to
  (``resume=False``): the day's run lease is taken first (a live foreign
  lease raises :class:`~bodywork_tpu_torch.pipeline.journal.LeaseLost`),
  intent and complete marks are written at every step barrier, and a
  restarted day skips the batch stages whose recorded artefact digests
  still verify against the store; a day journalled complete is a no-op.
  A simulated crash (``chaos.kill``) gets no cleanup, as process death
  gets none.

:meth:`LocalRunner.run_simulation` loops the day over N simulated days
(the reference's "re-run the deployment every day", README.md:5), with
the JAX package's overlap machinery: the whole horizon's generator draws
prefetched on one background worker, each next day's train run as a
lookahead on a background thread once today's generate stage has
persisted its data (collected and persisted by the next day's train
stage), and the history snapshot refreshed on a background compactor
after each day. The background work runs on the runner's device, on the
thread's current (default) CUDA stream, so the card orders it with the
day's own work.

Spans (``obs.spans``, the JAX runner's names and categories): one
:class:`~bodywork_tpu_torch.obs.spans.SpanRecorder` a runner
(``self.recorder``) times each stage (``stage``, from the same reading as
``stage_seconds``, with zero-length ``skipped`` spans for the stages the
journal verified), ``registry-gate`` and ``full-refit-fallback-<stage>``
(``gate``), ``run-day-<date>`` (``day``), ``bootstrap-<date>``
(``setup``), and the background work: ``prefetch-dataset-<date>``
(``prefetch``), ``lookahead-train-<date>`` (``overlap``) and
``snapshot-refresh`` (``compact``). Each ``DayResult`` carries the spans
recorded in its window, the input of ``obs.spans.day_report``.
``run_simulation(profile_dir=...)`` profiles the loop with
``torch.profiler`` (``utils.profiling.maybe_trace``), each stage a named
range in it. A span around device work ends where the host waited for it:
a stage returns once its results are in the store or on the host.

Not ported: the JAX runner's compile prewarm and its ``prewarm-enqueue``
and ``prewarm-drain`` spans (XLA machinery; ROADMAP's "not to port").
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import date, timedelta

import torch

from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.obs.spans import Span, SpanRecorder
from bodywork_tpu_torch.pipeline.spec import PipelineSpec, StageSpec
from bodywork_tpu_torch.pipeline.stages import StageContext, stage_artefact_keys
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.epoch import EpochGuardedStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
from bodywork_tpu_torch.utils.logging import configure_logger, get_logger

log = get_logger("pipeline.runner")

#: errors that can never succeed on a retry (the JAX package's
#: ``utils.retry.PERMANENT_ERROR_TYPES``)
PERMANENT_ERROR_TYPES = (ValueError, TypeError, KeyError, AttributeError, NotImplementedError)


def _hit_kill_point(kind: str) -> None:
    """The process-kill hook (``chaos.kill``), resolved through
    ``sys.modules``: the runner never imports the module, which is
    present only when something armed a kill switch."""
    mod = sys.modules.get("bodywork_tpu_torch.chaos.kill")
    if mod is not None:
        mod.hit_kill_point(kind)


def _is_simulated_crash(exc: BaseException) -> bool:
    """True for ``chaos.kill.SimulatedCrash``, the in-process stand-in for
    process death, which propagates raw: no retry, no ``StageFailure``,
    no journal mark."""
    mod = sys.modules.get("bodywork_tpu_torch.chaos.kill")
    return mod is not None and isinstance(exc, mod.SimulatedCrash)


class StageFailure(RuntimeError):
    """A stage failed (exhausted its attempts, timed out, or failed its
    health gate); carries the stage name."""

    def __init__(self, stage: str, message: str):
        super().__init__(f"stage '{stage}' failed: {message}")
        self.stage = stage


@dataclasses.dataclass
class DayResult:
    day: date
    wall_clock_s: float
    stage_seconds: dict[str, float]
    #: stage name -> its return value; ``"registry-gate"`` holds the
    #: gate's ``GateDecision`` (None when there was nothing to gate)
    stage_results: dict[str, object]
    #: seconds of the registry gate between train and serve (None when the
    #: spec has no train stage); not in ``stage_seconds``, which keeps to
    #: the spec's declared stages
    gate_seconds: float | None = None
    #: stages skipped because the run journal recorded them complete and
    #: every recorded artefact digest verified against the store
    skipped_stages: tuple[str, ...] = ()
    #: True when the journal marked the whole day complete and it
    #: verified: nothing ran, no service started
    noop: bool = False
    #: generate stages that persisted prefetched draws (not inline ones)
    prefetched: int = 0
    #: seconds the lookahead train this day's train stage collected took
    #: on its own thread (None when the stage collected none)
    lookahead_train_s: float | None = None
    #: spans recorded in this day's run_day window (the stages, the gate,
    #: the day, and background work that ended inside it): the input of
    #: ``obs.spans.day_report`` / ``chrome_trace``
    spans: list[Span] = dataclasses.field(default_factory=list)

#: ``stage_results`` key of the registry gate's decision
GATE_RESULT = "registry-gate"


def resolve_executable(path: str):
    """``"pkg.mod:fn"`` -> the callable."""
    module_name, _, fn_name = path.partition(":")
    if not fn_name:
        raise ValueError(f"executable must be 'module:function', got {path!r}")
    return getattr(importlib.import_module(module_name), fn_name)


def _is_permanent(exc: BaseException) -> bool:
    return isinstance(exc, (*PERMANENT_ERROR_TYPES, StageFailure))


def _healthy(url: str) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=2) as resp:
            return 200 <= resp.status < 300
    except (urllib.error.URLError, OSError):
        # refused, reset or timed out: not up yet, poll again
        return False


class LocalRunner:
    def __init__(self, spec: PipelineSpec, store: ArtefactStore,
                 drift: DriftConfig | None = None, device=None):
        self.spec = spec
        self.store = store
        self.drift = drift or DriftConfig()
        #: the device every stage computes on, worker threads included
        self.device = resolve_device(device)
        #: (date, box) handoff from a lookahead train to the next run_day
        self._pending_train: tuple | None = None
        #: the background snapshot compactor: at most one refresh in flight
        self._compact_thread: threading.Thread | None = None
        self._compact_lock = threading.Lock()
        #: dataset prefetch: date -> {"ready": Event, "X", "y"}, filled by
        #: one background worker (see _enqueue_generate)
        self._dataset_boxes: dict[date, dict] = {}
        self._gen_queue: list[tuple[date, dict]] = []
        self._gen_worker: threading.Thread | None = None
        self._gen_lock = threading.Lock()
        #: one span timeline for the runner's lifetime: the stages and the
        #: background work overlapping them land on it
        self.recorder = SpanRecorder(label=spec.name)
        configure_logger(spec.log_level)

    def _device_scope(self):
        """Make the runner's card the current CUDA device of the calling
        thread (a worker thread starts on device 0 otherwise)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @staticmethod
    def _worker_threads(n_threads: int) -> None:
        """Give a worker thread the caller's CPU thread count: OpenMP
        starts a new thread with its default team (every core) whatever
        ``torch.set_num_threads`` said in another thread, and on a busy
        host that oversubscription slowed a small MLP fit 40x."""
        torch.set_num_threads(n_threads)

    def _background(self, name: str, work) -> threading.Thread:
        """Start ``work()`` (the prefetch, a lookahead train, a snapshot
        refresh: bounded work) on a thread with the caller's CPU thread
        count, on the runner's device. Not a daemon thread, unlike the JAX
        package's: the interpreter joins it before it tears down, where a
        daemon thread still inside a torch call aborts the process
        (``std::terminate``) instead of exiting with the run's code."""
        n_threads = torch.get_num_threads()

        def _target():
            self._worker_threads(n_threads)
            with self._device_scope():
                work()

        thread = threading.Thread(target=_target, name=name)
        thread.start()
        return thread

    # -- single stages -----------------------------------------------------
    def _run_batch_stage(self, stage: StageSpec, ctx: StageContext):
        fn = resolve_executable(stage.executable)
        last_exc: BaseException | None = None
        for attempt in range(1 + stage.retries):
            if attempt:
                log.warning(f"retrying {stage.name} (attempt {attempt + 1})")
            box: dict = {}
            # each attempt writes through its own epoch: revoking it when
            # the attempt is abandoned below keeps the zombie thread's late
            # writes out of the shared store
            epoch = EpochGuardedStore(ctx.store, label=stage.name)
            attempt_ctx = dataclasses.replace(ctx, store=epoch)
            n_threads = torch.get_num_threads()

            def _target(attempt_ctx=attempt_ctx, box=box):
                try:
                    self._worker_threads(n_threads)
                    with self._device_scope():
                        box["result"] = fn(attempt_ctx, **stage.args)
                except BaseException as exc:  # noqa: BLE001 - reported below
                    box["exc"] = exc

            # a daemon thread, so an attempt hung past its deadline is truly
            # abandoned (a k8s Job past activeDeadlineSeconds) and cannot
            # block interpreter exit
            worker = threading.Thread(target=_target, name=f"stage-{stage.name}", daemon=True)
            worker.start()
            worker.join(timeout=stage.max_completion_time_s)
            if worker.is_alive():
                # it cannot be killed and may still write: fence it and fail
                # now, rather than run a retry beside it
                epoch.revoke()
                last_exc = TimeoutError(
                    f"exceeded max_completion_time_seconds={stage.max_completion_time_s}"
                )
                log.error(f"{stage.name}: {last_exc}")
                break
            if "exc" not in box:
                return box.get("result")
            last_exc = box["exc"]
            if _is_simulated_crash(last_exc):
                # stands in for process death: retrying it would absorb the
                # very failure crash resume exists to survive
                raise last_exc
            log.error(f"{stage.name} failed: {last_exc!r}")
            if _is_permanent(last_exc):
                log.error(f"{stage.name}: a permanent error; not retrying")
                break
        raise StageFailure(stage.name, repr(last_exc))

    def _run_service_stage(self, stage: StageSpec, ctx: StageContext):
        """Start and health-gate a service stage, with ``retries``."""
        last_exc: Exception | None = None
        for attempt in range(1 + stage.retries):
            if attempt:
                log.warning(f"retrying {stage.name} (attempt {attempt + 1})")
            try:
                return self._start_and_health_gate(stage, ctx)
            except Exception as exc:
                last_exc = exc
                log.error(f"{stage.name} failed to start: {exc!r}")
        if isinstance(last_exc, StageFailure):
            raise last_exc
        raise StageFailure(stage.name, repr(last_exc))

    def _start_and_health_gate(self, stage: StageSpec, ctx: StageContext):
        fn = resolve_executable(stage.executable)
        deadline = time.monotonic() + stage.max_startup_time_s
        args = dict(stage.args)
        if stage.replicas > 1 and "replicas" in inspect.signature(fn).parameters:
            # the spec's replica count, for executables that take one
            args.setdefault("replicas", stage.replicas)
        with self._device_scope():
            handle = fn(ctx, **args)
        health_url = handle.base_url + "/healthz"
        poll_s = 0.002
        try:
            while not _healthy(health_url):
                if time.monotonic() > deadline:
                    raise StageFailure(
                        stage.name,
                        f"not healthy within max_startup_time_seconds={stage.max_startup_time_s}",
                    )
                time.sleep(poll_s)
                poll_s = min(poll_s * 2, 0.05)
        except BaseException:
            handle.stop()  # never leak a started but unregistered server
            raise
        ctx.services[stage.name] = handle
        return handle

    def _run_stage_timed(self, name: str, ctx: StageContext, stage_seconds: dict,
                         concurrent: bool = False) -> None:
        """Run one stage, recording its seconds and result. With
        ``concurrent=True`` (a step thread) a failure is parked in
        ``ctx.failures`` for the step barrier to raise. The stage's span
        is its ``stage_seconds`` reading: one measurement, two views."""
        from bodywork_tpu_torch.utils.profiling import annotate

        stage = self.spec.stages[name]
        start_rel = self.recorder.now()
        t0 = time.perf_counter()
        try:
            with annotate(name):  # a named range in an active profile
                if stage.kind == "service":
                    result = self._run_service_stage(stage, ctx)
                else:
                    result = self._run_batch_stage(stage, ctx)
        except BaseException as exc:
            stage_seconds[name] = time.perf_counter() - t0
            self.recorder.add(name, "stage", start_rel, stage_seconds[name],
                              day=str(ctx.today), failed=True)
            if not concurrent:
                raise
            if not isinstance(exc, StageFailure) and not _is_simulated_crash(exc):
                exc = StageFailure(name, repr(exc))
            ctx.failures[name] = exc
            return
        stage_seconds[name] = time.perf_counter() - t0
        extra = {}
        if stage.kind == "batch" and getattr(result, "mode", None) is not None \
                and getattr(result, "rows_touched", None) is not None:
            # a TrainResult: how the model was produced, and what it read
            extra["train_mode"] = result.mode
            extra["rows_touched"] = result.rows_touched
            if getattr(result, "fallback_reason", None):
                extra["fallback_reason"] = result.fallback_reason
        if stage.kind == "service":
            # what went live, and under whose authority
            apps = getattr(result, "replica_apps", None)
            app = apps[0] if apps else getattr(result, "app", None)
            served_key = getattr(app, "model_key", None)
            if served_key is not None:
                extra["served_key"] = served_key
                extra["model_source"] = getattr(app, "model_source", None)
        self.recorder.add(name, "stage", start_rel, stage_seconds[name],
                          day=str(ctx.today), **extra)
        ctx.stage_results[name] = result
        log.info(f"[{ctx.today}] {name} done in {stage_seconds[name]:.3f}s")

    # -- the registry gate -------------------------------------------------
    def _full_refit_fallback(self, today: date, ctx: StageContext, journal,
                             stage_names: list[str]) -> None:
        """The gate rejected today's incremental candidate: run the train
        stage(s) again as a full refit, so the day still ends with a
        gateable candidate. The refit re-registers the same date-keyed
        checkpoint with new bytes (the rejected record goes back to
        candidate on a digest change), and its result records
        ``fallback_reason="gate_rejected"``. The journal's train digests
        are recorded again, so a resume verifies the refit's bytes."""
        from bodywork_tpu_torch.train.incremental import count_fallback

        # a lookahead result was the incremental candidate just rejected
        ctx.prefetched_train = None
        for name in stage_names:
            count_fallback("gate_rejected")
            log.warning(f"[{today}] incremental candidate rejected by the gate; "
                        f"re-running {name} as a full refit")
            stage = self.spec.stages[name]
            fn = resolve_executable(stage.executable)
            with self.recorder.span(f"full-refit-fallback-{name}", "gate", day=str(today)), \
                    self._device_scope():
                result = fn(ctx, **{**stage.args, "mode": "full"})
            ctx.stage_results[name] = dataclasses.replace(result, fallback_reason="gate_rejected")
            if journal is not None:
                completes = self._journal_artefacts([name], ctx)
                if completes:
                    journal.record_completes(completes)

    def _train_mode(self, name: str, result) -> str:
        """The mode a train stage ran in: its result's, or for a stage the
        journal skipped (whose result is its journal entry) the mode it
        ran with, so a day resumed after train still gates an incremental
        candidate with the shadow check and the refit fallback."""
        from bodywork_tpu_torch.pipeline.stages import _train_env_mode

        mode = getattr(result, "mode", None)
        return mode or self.spec.stages[name].args.get("mode") or _train_env_mode()

    @staticmethod
    def _produced(result, model_key: str) -> bool:
        """Whether a train stage's result (or its journal entry) produced
        ``model_key``."""
        if getattr(result, "model_artefact_key", None) == model_key:
            return True
        return isinstance(result, dict) and model_key in (result.get("artefacts") or {})

    def _run_registry_gate(self, today: date, ctx: StageContext, journal,
                           train_stages: set[str]) -> float:
        """The promotion gate between train and serve: adjudicate the
        candidate the train step just registered (promote it to the
        ``production`` alias or reject it) before the serve step resolves
        what to load. The decision goes to ``stage_results`` under
        :data:`GATE_RESULT`. An incremental candidate is gated with shadow
        evaluation over ``INCREMENTAL_SHADOW_DAYS``, and a rejection runs
        :meth:`_full_refit_fallback` and gates the refit under the
        standard policy. No retries; a gate that FAILS (as opposed to
        rejecting) is logged and the day goes on, serving the current
        production (or the latest checkpoint on a store never promoted).
        Returns the seconds it took, which its ``registry-gate`` span
        (``gate``) records with the verdict."""
        start_rel = self.recorder.now()
        t0 = time.perf_counter()
        failed = fallback = False
        verdict = None
        try:
            from bodywork_tpu_torch.registry import GatePolicy, ModelRegistry
            from bodywork_tpu_torch.train.incremental import INCREMENTAL_SHADOW_DAYS

            results = ctx.stage_results
            incremental = [n for n in sorted(train_stages)
                           if self._train_mode(n, results.get(n)) == "incremental"]
            policy = GatePolicy(shadow_days=INCREMENTAL_SHADOW_DAYS) if incremental else None
            decision = ModelRegistry(self.store, policy=policy, device=self.device).gate(day=today)
            if decision is not None and not decision.promote:
                rejected = [n for n in incremental
                            if self._produced(results[n], decision.model_key)]
                if rejected:
                    fallback = True
                    self._full_refit_fallback(today, ctx, journal, rejected)
                    decision = ModelRegistry(self.store, device=self.device).gate(day=today)
            ctx.stage_results[GATE_RESULT] = decision
            if decision is not None:
                verdict = "promoted" if decision.promote else "rejected"
                log.info(f"[{today}] registry gate: {verdict.upper()} {decision.model_key}")
        except Exception as exc:  # noqa: BLE001 - a failed gate is not fatal
            failed = True
            log.error(f"registry gate failed (non-fatal): {exc!r}")
        seconds = time.perf_counter() - t0
        extra = {"verdict": verdict} if verdict else {}
        if fallback:
            extra["full_refit_fallback"] = True
        if failed:
            extra["failed"] = True
        self.recorder.add(GATE_RESULT, "gate", start_rel, seconds, day=str(today), **extra)
        return seconds

    def _train_stages(self) -> set[str]:
        """The spec's train stages, which the gate waits for; warns when
        one shares a DAG step with a service, which then resolves its
        model before today's candidate is gated."""
        train = set(self._stages_of("train_stage"))
        if any(set(step) & train
               and any(self.spec.stages[n].kind == "service" for n in step)
               for step in self.spec.dag):
            log.warning(
                "pipeline spec places a train stage and a service stage in the "
                "same DAG step: the registry gate runs at the step boundary, so "
                "the service resolves its model BEFORE today's candidate is gated "
                "(it serves the previous production / latest)"
            )
        return train

    def _stages_of(self, kind: str) -> list[str]:
        """The spec's stages whose executable is the ``kind`` stage."""
        return [name for name, s in self.spec.stages.items()
                if s.executable.endswith(f":{kind}")]

    # -- overlap: dataset prefetch, lookahead train, snapshot compactor ----
    def _generate_offsets(self) -> list[int]:
        return [self.spec.stages[n].args.get("offset_days", 1)
                for n in self._stages_of("generate_stage")]

    def _enqueue_generate(self, targets: list[date]) -> None:
        """Queue the generator's draws for ``targets`` on the one
        background prefetch worker. The generator is a pure function of
        (date, drift), so its draws can run any time before each date's
        generate stage, which waits on the box's ``ready`` event and only
        persists. A simulation enqueues its whole horizon at day 0."""
        with self._gen_lock:
            fresh = [t for t in targets if t not in self._dataset_boxes]
            for t in fresh:
                box = {"ready": threading.Event()}
                self._dataset_boxes[t] = box
                # the queue carries the box itself: a stage popping it from
                # _dataset_boxes must not break the worker
                self._gen_queue.append((t, box))
            if fresh and self._gen_worker is None:
                self._gen_worker = self._background("dataset-prefetch", self._generate_worker)

    def _generate_worker(self) -> None:
        from bodywork_tpu_torch.data.generator import generate_day

        while True:
            with self._gen_lock:
                if not self._gen_queue:
                    self._gen_worker = None
                    return
                target, box = self._gen_queue.pop(0)
            try:
                with self.recorder.span(f"prefetch-dataset-{target}", "prefetch"):
                    box["X"], box["y"] = generate_day(target, self.drift, device=self.device)
            except Exception as exc:  # noqa: BLE001 - the stage generates inline
                log.warning(f"dataset prefetch failed (non-fatal): {exc!r}")
            finally:
                box["ready"].set()

    def _refresh_snapshot_async(self) -> None:
        """Refresh the history snapshot on a background thread when the day
        that just ran made it stale: off the critical path (the day's
        clock already stopped), at most one refresh in flight."""
        from bodywork_tpu_torch.data.snapshot import refresh_due, write_snapshot

        def _work():
            try:
                if refresh_due(self.store):
                    with self.recorder.span("snapshot-refresh", "compact"):
                        write_snapshot(self.store)
            except Exception as exc:  # noqa: BLE001 - readers keep the old snapshot
                log.warning(f"snapshot refresh failed (non-fatal): {exc!r}")

        with self._compact_lock:
            if self._compact_thread is not None and self._compact_thread.is_alive():
                return
            self._compact_thread = self._background("snapshot-compactor", _work)

    def _drain_compactor(self, timeout_s: float = 60.0) -> bool:
        """Join the background compactor; True when none is left running.
        Called on every exit of ``run_simulation``, so no half-written
        snapshot races whatever reads the store next."""
        thread = self._compact_thread
        if thread is None:
            return True
        thread.join(timeout=timeout_s)
        if thread.is_alive():
            log.warning(f"background snapshot refresh still running after "
                        f"{timeout_s:.0f}s; abandoning it")
            return False
        return True

    def _start_lookahead_train(self, tomorrow: date) -> None:
        """Train tomorrow's model now, on a background thread: tomorrow's
        training set is complete once today's generate stage persisted it,
        so the train overlaps the rest of today. It computes and writes
        nothing; tomorrow's train stage collects the result
        (``ctx.prefetched_train``) and persists it, so an aborted day never
        leaves a future-dated model in the store."""
        names = self._stages_of("train_stage")
        if not names:
            return
        train_spec = self.spec.stages[names[0]]
        ctx_next = StageContext(store=self.store, today=tomorrow, device=self.device,
                                drift=self.drift, defer_artefacts=True)
        fn = resolve_executable(train_spec.executable)
        box: dict = {}

        def _work():
            t0 = time.perf_counter()
            try:
                with self.recorder.span(f"lookahead-train-{tomorrow}", "overlap"):
                    box["result"] = fn(ctx_next, **train_spec.args)
            except BaseException as exc:  # noqa: BLE001 - tomorrow trains inline
                box["exc"] = exc
            box["seconds"] = time.perf_counter() - t0

        box["thread"] = self._background(f"lookahead-train-{tomorrow}", _work)
        self._pending_train = (tomorrow, box)

    # -- crash resume ------------------------------------------------------
    def _resume_state(self, journal) -> tuple[dict[str, dict], str]:
        """Verify the journal's completed stages against the store; returns
        the skippable stages and how the run starts (``fresh``,
        ``resumed``, ``rerun_mismatch``, ``rerun_corrupt``). Only batch
        stages are skippable: a service died with its process."""
        skip, mismatch = journal.verify_completed()
        skip = {name: entry for name, entry in skip.items()
                if name in self.spec.stages and self.spec.stages[name].kind == "batch"}
        if journal.was_corrupt:
            outcome = "rerun_corrupt"
        elif mismatch:
            outcome = "rerun_mismatch"
        elif journal.prior_status is None:
            outcome = "fresh"
        else:
            outcome = "resumed"
        return skip, outcome

    def _noop_day_result(self, today: date, skip: dict) -> DayResult:
        """The day was journalled complete and every artefact verified:
        report it without running anything (no stage, service or gate),
        in the shapes a run records: zero-length stage and day spans."""
        span_mark = self.recorder.mark()
        start_rel = self.recorder.now()
        for name in self.spec.stages:
            self.recorder.add(name, "stage", start_rel, 0.0, day=str(today), skipped=True)
        self.recorder.add(f"run-day-{today}", "day", start_rel, 0.0, resumed_noop=True)
        log.info(f"[{today}] run journal marks the day complete and every "
                 "artefact verified; resumed as a no-op")
        return DayResult(
            day=today, wall_clock_s=0.0,
            stage_seconds={name: 0.0 for name in self.spec.stages},
            stage_results={name: skip.get(name, {"state": "complete"})
                           for name in self.spec.stages},
            skipped_stages=tuple(self.spec.stages), noop=True,
            spans=self.recorder.since(span_mark),
        )

    def _journal_artefacts(self, names: list[str], ctx: StageContext) -> dict[str, dict]:
        """``{stage: {artefact key: content digest}}`` of the batch stages
        that just completed, hashed from the bytes in the store (what a
        resume verifies against), never from copies in memory."""
        from bodywork_tpu_torch.pipeline.journal import artefact_digest

        out: dict[str, dict] = {}
        for name in names:
            stage = self.spec.stages[name]
            if stage.kind == "service" or name not in ctx.stage_results:
                continue
            artefacts: dict[str, str] = {}
            for key in stage_artefact_keys(stage, ctx.stage_results[name], ctx):
                try:
                    artefacts[key] = artefact_digest(self.store.get_bytes(key))
                except Exception as exc:  # noqa: BLE001 - no digest, no skip:
                    # the stage just re-runs on resume
                    log.warning(f"could not digest {key!r} for the journal: {exc!r}")
            out[name] = artefacts
        return out

    # -- DAG execution -----------------------------------------------------
    def _run_step(self, to_run: list[str], ctx: StageContext, stage_seconds: dict) -> None:
        """One DAG step: its stages run concurrently (as concurrent pods
        would), and the first failure is raised at the barrier."""
        if len(to_run) == 1:
            self._run_stage_timed(to_run[0], ctx, stage_seconds)
            return
        threads = [threading.Thread(target=self._run_stage_timed,
                                    args=(name, ctx, stage_seconds, True),
                                    name=f"step-{name}")
                   for name in to_run]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [n for n in to_run if n in ctx.failures]
        if failed:
            raise ctx.failures[failed[0]]

    def run_day(self, today: date, scoring_url: str | None = None,
                lookahead_train: bool = False, resume: bool = True) -> DayResult:
        """Run the DAG for one simulated day; raises :class:`StageFailure`
        naming the first failed stage. With ``resume`` the day is
        journalled: a live foreign lease raises ``LeaseLost``, verified
        completed stages are skipped, a verified complete day is a no-op.
        ``lookahead_train`` starts tomorrow's train once today's generate
        stages have persisted."""
        from bodywork_tpu_torch.utils.shutdown import ShutdownRequested

        journal = None
        skip: dict[str, dict] = {}
        if resume:
            from bodywork_tpu_torch.pipeline.journal import RunJournal, count_resume

            journal = RunJournal(self.store, today)
            journal.acquire()  # LeaseLost propagates: the caller exits
            skip, outcome = self._resume_state(journal)
            batch = [n for n, s in self.spec.stages.items() if s.kind == "batch"]
            if journal.prior_status == "complete" and all(n in skip for n in batch):
                count_resume("noop")
                journal.release()  # nothing to do: free the day at once
                return self._noop_day_result(today, skip)
            count_resume(outcome)
            log.info(f"[{today}] run journal: {outcome}")
        ctx = StageContext(store=self.store, today=today, device=self.device,
                           drift=self.drift, scoring_url=scoring_url)
        pending = self._pending_train
        if pending is not None and pending[0] == today:
            ctx.prefetched_train = pending[1]
        self._pending_train = None
        lookahead_box = ctx.prefetched_train
        targets = [today + timedelta(days=o) for o in self._generate_offsets()]
        self._enqueue_generate(targets)
        gen_boxes = {t: self._dataset_boxes[t] for t in targets if t in self._dataset_boxes}
        ctx.prefetched_datasets = self._dataset_boxes
        gen_stages = set(self._stages_of("generate_stage"))
        stage_seconds: dict[str, float] = {}
        train_stages = self._train_stages()
        gate_seconds = None
        span_mark = self.recorder.mark()
        day_start_rel = self.recorder.now()
        day_start = time.perf_counter()
        try:
            for step in self.spec.dag:
                # one kill point a step barrier, and one after the last step
                _hit_kill_point("stage_boundary")
                to_run = [n for n in step if n not in skip]
                for name in step:
                    if name in skip:
                        # the shapes a run records: seconds, result, span
                        stage_seconds[name] = 0.0
                        ctx.stage_results[name] = skip[name]
                        self.recorder.add(name, "stage", self.recorder.now(), 0.0,
                                          day=str(today), skipped=True)
                        log.info(f"[{today}] {name} skipped (journal-verified complete)")
                if journal is not None and to_run:
                    # write-ahead: a crash from here on finds these stages
                    # at intent and re-runs them
                    journal.record_intents(to_run)
                if to_run:
                    self._run_step(to_run, ctx, stage_seconds)
                if journal is not None and to_run:
                    completes = self._journal_artefacts(to_run, ctx)
                    if completes:
                        journal.record_completes(completes)
                # the gate: once every train stage has registered its
                # candidate, before any later step resolves what to serve
                if (train_stages and gate_seconds is None
                        and train_stages <= set(ctx.stage_results)):
                    gate_seconds = self._run_registry_gate(today, ctx, journal, train_stages)
                # tomorrow's training set is complete once every generate
                # stage has persisted: overlap its train with the rest of today
                if lookahead_train and gen_stages and gen_stages <= set(ctx.stage_results):
                    self._start_lookahead_train(today + timedelta(days=1))
                    lookahead_train = False
            _hit_kill_point("stage_boundary")
            if journal is not None:
                journal.record_day_complete()
        except BaseException as exc:
            if journal is not None:
                if isinstance(exc, ShutdownRequested):
                    # a clean interrupted mark; in-flight stages stay at intent
                    journal.record_interrupted()
                elif not _is_simulated_crash(exc):
                    # free the lease so a retry starts at once; a simulated
                    # crash gets no cleanup, as process death gets none
                    journal.release()
            raise
        finally:
            for handle in ctx.services.values():
                handle.stop()
        wall_clock_s = time.perf_counter() - day_start
        self.recorder.add(f"run-day-{today}", "day", day_start_rel, wall_clock_s)
        # consolidate history after the clock stops
        self._refresh_snapshot_async()
        collected = (lookahead_box is not None and "result" in lookahead_box
                     and not set(self._stages_of("train_stage")) & set(skip))
        return DayResult(
            day=today, wall_clock_s=wall_clock_s,
            stage_seconds=stage_seconds, stage_results=ctx.stage_results,
            gate_seconds=gate_seconds,
            skipped_stages=tuple(n for n in self.spec.stages if n in skip),
            # a generate stage that ran popped its box and used its draws
            prefetched=sum("X" in box and t not in self._dataset_boxes
                           for t, box in gen_boxes.items()),
            lookahead_train_s=lookahead_box["seconds"] if collected else None,
            spans=self.recorder.since(span_mark),
        )

    # -- multi-day simulation ----------------------------------------------
    def bootstrap(self, start: date) -> None:
        """Seed day-0 data if the store has none (the reference bootstraps
        by hand-running the stage-3 notebook before the first deployment)."""
        if self.store.history(DATASETS_PREFIX):
            return
        from bodywork_tpu_torch.data.generator import generate_day
        from bodywork_tpu_torch.data.io import Dataset, persist_dataset

        with self.recorder.span(f"bootstrap-{start}", "setup"):
            X, y = generate_day(start, self.drift, device=self.device)
            persist_dataset(self.store, Dataset(X, y, start))
        log.info(f"bootstrapped day-0 dataset for {start}")

    def run_simulation(self, start: date, days: int, on_day=None,
                       resume: bool = True, profile_dir: str | None = None) -> list[DayResult]:
        """The daily loop over ``days`` simulated days from ``start``: each
        day trains on history to date, serves, generates the next
        (drifted) day and tests the live service against it. The horizon's
        draws are prefetched at day 0, each day but the last starts the
        next day's lookahead train, and the compactor is drained (and the
        final snapshot topped up) before returning. ``on_day``, if given,
        is called with each day's :class:`DayResult` as soon as the day
        ends. ``profile_dir`` profiles the loop with ``torch.profiler``
        (CUDA activity included on the card) and writes its Chrome trace
        there (``utils.profiling.maybe_trace``)."""
        from bodywork_tpu_torch.utils.profiling import maybe_trace

        self.bootstrap(start)
        self._enqueue_generate([start + timedelta(days=i + o)
                                for i in range(days) for o in self._generate_offsets()])
        results = []
        try:
            with maybe_trace(profile_dir, label=f"{days}-day simulation", device=self.device):
                for i in range(days):
                    today = start + timedelta(days=i)
                    results.append(self.run_day(today, lookahead_train=i < days - 1,
                                                resume=resume))
                    log.info(f"simulated day {today}: "
                             f"{results[-1].wall_clock_s:.2f}s wall-clock")
                    if on_day is not None:
                        on_day(results[-1])
        except BaseException:
            # no daemon compactor mid-write may race the next reader
            self._drain_compactor()
            raise
        if not self._drain_compactor():
            return results  # a slow write is still in flight: no second one
        try:
            from bodywork_tpu_torch.data.snapshot import refresh_due, write_snapshot

            if refresh_due(self.store):
                with self.recorder.span("snapshot-refresh", "compact"):
                    write_snapshot(self.store)
        except Exception as exc:  # noqa: BLE001 - readers keep the old snapshot
            log.warning(f"final snapshot refresh failed (non-fatal): {exc!r}")
        return results
