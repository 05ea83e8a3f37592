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
  rejected, so a bad retrain never takes traffic;
- a failed stage fails the day with a :class:`StageFailure` naming it,
  and services are stopped at day end either way.

:meth:`LocalRunner.run_simulation` loops the day over N simulated days
(the reference's "re-run the deployment every day", README.md:5).

Not ported yet (ROADMAP): the run journal and its lease (resume), the
gate's same-day full-refit fallback for a rejected incremental candidate
(with incremental training, Queue 1 item 3), the lookahead train,
dataset prefetch, the history snapshot compactor, compile prewarm, spans
and the day report, and profiling.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import inspect
import threading
import time
import urllib.error
import urllib.request
from datetime import date, timedelta

import torch

from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.device import resolve_device
from bodywork_tpu_torch.pipeline.spec import PipelineSpec, StageSpec
from bodywork_tpu_torch.pipeline.stages import StageContext
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.epoch import EpochGuardedStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX
from bodywork_tpu_torch.utils.logging import configure_logger, get_logger

log = get_logger("pipeline.runner")

#: errors that can never succeed on a retry (the JAX package's
#: ``utils.retry.PERMANENT_ERROR_TYPES``)
PERMANENT_ERROR_TYPES = (ValueError, TypeError, KeyError, AttributeError, NotImplementedError)


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
        ``ctx.failures`` for the step barrier to raise."""
        stage = self.spec.stages[name]
        t0 = time.perf_counter()
        try:
            if stage.kind == "service":
                result = self._run_service_stage(stage, ctx)
            else:
                result = self._run_batch_stage(stage, ctx)
        except BaseException as exc:
            stage_seconds[name] = time.perf_counter() - t0
            if not concurrent:
                raise
            ctx.failures[name] = exc if isinstance(exc, StageFailure) else StageFailure(name, repr(exc))
            return
        stage_seconds[name] = time.perf_counter() - t0
        ctx.stage_results[name] = result
        log.info(f"[{ctx.today}] {name} done in {stage_seconds[name]:.3f}s")

    # -- the registry gate -------------------------------------------------
    def _run_registry_gate(self, today: date, ctx: StageContext) -> float:
        """The promotion gate between train and serve: adjudicate the
        candidate the train step just registered (promote it to the
        ``production`` alias or reject it) before the serve step resolves
        what to load. The decision goes to ``stage_results`` under
        :data:`GATE_RESULT`. No retries; a gate that FAILS (as opposed to
        rejecting) is logged and the day goes on, serving the current
        production (or the latest checkpoint on a store never promoted).
        A rejected incremental candidate's same-day full refit waits for
        incremental training (ROADMAP Queue 1 item 3). Returns the
        seconds it took."""
        t0 = time.perf_counter()
        try:
            from bodywork_tpu_torch.registry import ModelRegistry

            decision = ModelRegistry(self.store, device=self.device).gate(day=today)
            ctx.stage_results[GATE_RESULT] = decision
            if decision is not None:
                verdict = "PROMOTED" if decision.promote else "REJECTED"
                log.info(f"[{today}] registry gate: {verdict} {decision.model_key}")
        except Exception as exc:  # noqa: BLE001 - a failed gate is not fatal
            log.error(f"registry gate failed (non-fatal): {exc!r}")
        return time.perf_counter() - t0

    def _train_stages(self) -> set[str]:
        """The spec's train stages, which the gate waits for; warns when
        one shares a DAG step with a service, which then resolves its
        model before today's candidate is gated."""
        train = {name for name, s in self.spec.stages.items()
                 if s.executable.endswith(":train_stage")}
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

    # -- DAG execution -----------------------------------------------------
    def run_day(self, today: date, scoring_url: str | None = None) -> DayResult:
        """Run the DAG for one simulated day; raises :class:`StageFailure`
        naming the first failed stage."""
        ctx = StageContext(store=self.store, today=today, device=self.device,
                           drift=self.drift, scoring_url=scoring_url)
        stage_seconds: dict[str, float] = {}
        train_stages = self._train_stages()
        gate_seconds = None
        day_start = time.perf_counter()
        try:
            for step in self.spec.dag:
                if len(step) == 1:
                    self._run_stage_timed(step[0], ctx, stage_seconds)
                else:
                    # stages within a step are independent and run concurrently
                    threads = [
                        threading.Thread(target=self._run_stage_timed,
                                         args=(name, ctx, stage_seconds, True),
                                         name=f"step-{name}")
                        for name in step
                    ]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join()
                    failed = [n for n in step if n in ctx.failures]
                    if failed:
                        raise ctx.failures[failed[0]]
                # the gate: once every train stage has registered its
                # candidate, before any later step resolves what to serve
                if (train_stages and gate_seconds is None
                        and train_stages <= set(ctx.stage_results)):
                    gate_seconds = self._run_registry_gate(today, ctx)
        finally:
            for handle in ctx.services.values():
                handle.stop()
        return DayResult(
            day=today, wall_clock_s=time.perf_counter() - day_start,
            stage_seconds=stage_seconds, stage_results=ctx.stage_results,
            gate_seconds=gate_seconds,
        )

    # -- multi-day simulation ----------------------------------------------
    def bootstrap(self, start: date) -> None:
        """Seed day-0 data if the store has none (the reference bootstraps
        by hand-running the stage-3 notebook before the first deployment)."""
        if self.store.history(DATASETS_PREFIX):
            return
        from bodywork_tpu_torch.data.generator import generate_day
        from bodywork_tpu_torch.data.io import Dataset, persist_dataset

        X, y = generate_day(start, self.drift, device=self.device)
        persist_dataset(self.store, Dataset(X, y, start))
        log.info(f"bootstrapped day-0 dataset for {start}")

    def run_simulation(self, start: date, days: int, on_day=None) -> list[DayResult]:
        """The daily loop over ``days`` simulated days from ``start``: each
        day trains on history to date, serves, generates the next
        (drifted) day and tests the live service against it. ``on_day``,
        if given, is called with each day's :class:`DayResult` as soon as
        the day ends."""
        self.bootstrap(start)
        results = []
        for i in range(days):
            today = start + timedelta(days=i)
            results.append(self.run_day(today))
            log.info(f"simulated day {today}: {results[-1].wall_clock_s:.2f}s wall-clock")
            if on_day is not None:
                on_day(results[-1])
        return results
