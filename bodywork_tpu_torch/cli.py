"""Command line of the port: ``python -m bodywork_tpu_torch.cli
generate|serve|test|train|run-day|run-sim|run-ab|run-stage|wait-for|
report|compact|deploy|registry|trace|traffic|chaos|fsck|tune|fleet-sim``.

- ``generate --store S [--date D] [--days N] [--device cuda|cpu]`` writes
  N days of drift data starting at D (default: today, one day);
- ``serve --store S [--engine E] [--dtype float32|bfloat16|int8]
  [--device cuda|cpu] [--host H] [--port P] [--buckets N,N...]
  [--batch-window-ms MS] [--batch-max-rows N] [--server-engine
  thread|aio] [--max-pending N] [--retry-after-max-s S]`` serves the
  registry's ``production`` model (the newest checkpoint on a store
  without a registry; engine ``auto``: the fused kernel for a wide MLP it
  can launch, on the card); a quantized ``--dtype`` (default from
  ``BODYWORK_TPU_SERVE_DTYPE``) serves only if the shadow quality gate
  admits it, and f32 serves otherwise. The coalescer, front-end and
  admission flags are the JAX command's, with its environment defaults
  (``BODYWORK_TPU_BATCH_WINDOW_MS``, ``_BATCH_MAX_ROWS``,
  ``_SERVER_ENGINE``, ``_MAX_PENDING``, ``_RETRY_AFTER_MAX_S``); an
  explicit ``--batch-window-ms 0`` turns coalescing off.
  ``--reload-interval S`` (default 30, 0 off) polls the store and
  hot-swaps the checkpoint serving should run, the SLO watchdog judging
  a live canary on each poll; with it a store with no checkpoint yet
  boots a service answering 503. SIGTERM closes admission, stops the
  watcher, flushes the coalescer and exits 143. ``--mesh-data N
  --mesh-model M`` (defaults from ``BODYWORK_TPU_MESH_DATA|_MODEL``)
  serve through the plain engine over a ``data x model`` device mesh
  (``parallel``), refused beside ``--workers``/``--frontends``;
- ``test --store S --scoring-url URL [--mode single|batch]
  [--max-rows N]`` black-box tests the live service on the latest day
  and persists the test metrics;
- ``train --store S [--model linear|mlp] [--mode full|incremental]
  [--mesh-data N] [--mesh-model M]`` fits and persists the checkpoint
  and its metrics: a full refit on all history (an MLP's sharded over a
  ``data x model`` device mesh with the mesh flags), or the incremental
  fold (default from ``BODYWORK_TPU_TRAIN_MODE``), which prints its
  fallback reason when it ran as a full refit;
- ``run-day --store S [--date D] [--no-resume]`` runs one simulated day
  of the default pipeline (train -> registry gate -> serve -> generate ->
  test) in-process, crash-resumable through the day's run journal, with
  the JAX command's exit codes: 0 done, 1 a stage failed, 5 another
  runner holds the day's lease, 6 the journal marks the day complete and
  every artefact verified (nothing ran), 143 SIGTERM (the journal marks
  the day interrupted; the next run resumes it); ``run-day --scrub``
  scrubs the store after the day (``fsck``, detect only) and puts its
  findings in the day report. ``run-sim --store S
  --days N [--date D] [--samples-per-day R] [--overlap-generate]`` runs
  N days with the horizon prefetch, the lookahead train and the snapshot
  compactor (exit 5 and 143 as ``run-day``); ``--overlap-generate`` runs
  generate beside serve (``default_pipeline(overlap_generate=True)``).
  Their train and serve stages read ``BODYWORK_TPU_TRAIN_MODE`` and
  ``BODYWORK_TPU_SERVE_DTYPE``; both arm the kill switch of
  ``BODYWORK_TPU_CRASH_SCHEDULE`` (``chaos.kill``). ``run-day
  --trace-out T [--report-out R]`` writes the runner's spans as a Chrome
  trace and the day report (``bodywork_tpu.day_report/1``; next to the
  trace when no ``--report-out``), a literal ``{date}`` in either path
  becoming the day (the newest 30 such files kept); ``run-sim
  --trace-out T`` writes the whole simulation's spans and ``--profile-dir
  D`` a ``torch.profiler`` trace of the loop (CUDA activity on the card).
- ``compact --store S [--dry-run] [--keep N]`` consolidates the dataset
  history into one ``snapshots/`` artefact (``--dry-run`` prints the
  days, rows and bytes it would write, and writes nothing).
  Both take ``--model linear|mlp`` and ``--mode single|batch`` (the
  test stage's requests); ``train``, ``run-day`` and ``run-sim`` take
  ``--mlp-hidden 1024,1024,1024``, ``--mlp-steps`` and ``--mlp-lr`` to
  override the MLP's config.

- ``registry list|show|promote|rollback|gate --store S`` reads and moves
  the model registry with the JAX command's flags, output and exit codes:
  ``show WHAT`` (a model key, a date, ``production``, ``previous`` or
  ``aliases``), ``promote --model M [--date D]``, ``rollback [--date D]``
  (exit 8 when the restore target fails pre-verification: the alias did
  not move), ``gate [--model M] [--date D] [--dry-run] [--shadow-days K]
  [--device cuda|cpu]``, ``canary start [--model M] [--fraction F]
  [--seed N]|stop|promote|status``. A registry error exits 1.

- ``traffic run [--url U] [--rate RPS] [--duration S] [--arrival
  poisson|mmpp] [--transport json|binary] [--shards N] [--log-out F]
  [--log-in F] [--results-out F] ...`` generates or replays a seeded
  request log and drives it open-loop, printing the load report (JSON);
  exit 1 on a bad log or nothing to do.
- ``run-ab --store S --days N [--models linear,mlp] [--device cuda|cpu]``
  runs the variants' simulations concurrently on the card and prints
  their drift reports side by side (exit 1 when a variant failed).
- ``chaos canary --store S [--scenario nan|latency|healthy] [--seed N]
  [--requests N] [--fraction F] [--device cuda|cpu]`` runs the canary
  release-safety acceptance and prints its summary (exit 0 PASS, 1
  FAIL).

- ``chaos run-sim --store S --days N [--date D] [--seed N] [--plan F]
  [--samples-per-day N] [--model linear|mlp] [--mode single|batch]
  [--train-mode full|incremental] [--bit-rot] [--crash-schedule
  sweep|JSON] [--device cuda|cpu]`` runs the chaos soak (a faulted twin
  over the retrying, breaker-guarded, fault-injecting store and a flaky
  scoring service), the at-rest bit-rot soak or the crash-resume soak,
  and requires byte-identical final artefacts (exit 0 PASS, 1 FAIL).
- ``fsck --store S [--repair] [--json]`` scrubs the whole store against
  its write-time digests: exit 0 when no actionable finding remains, 7
  otherwise (it imports no torch).

- ``trace show ID|tail [-n N] [--traces N]|export --chrome OUT
  [--trace-id ID] --store S`` reads the flight-recorder dumps under
  ``obs/flightrec/`` (either package's): exit 9 when the trace (or, for
  ``tail`` and ``export``, any dump) is absent, 1 on an error.

- ``run-stage --store S --stage NAME [--spec F] [--date D] [--scoring-url
  U] [--device cuda|cpu]`` runs one stage of the pipeline, the pod entry
  point of the k8s manifests: a batch stage runs and exits 0, a service
  stage serves on its declared port until the process is stopped (a
  SIGTERM ends it as it ends the JAX command). The test stage imports no
  torch and resolves no device. ``wait-for --store S [--dataset]
  [--model] [--dataset-newer-than-model] [--service-url U] [--timeout S]
  [--poll-interval S]`` blocks until the conditions hold (exit 0,
  "conditions met") or the timeout passes (exit 1): the initContainer
  gate that orders the pods. ``deploy --out DIR [--spec F]
  [--emit-images DIR] [--force] [--store-path P] [--image I]
  [--store-volume auto|pvc|hostpath|gcs] ...`` writes the GKE manifests
  for a GPU node pool (exit 1 when stages reference derived image tags
  and neither ``--emit-images`` nor ``--force`` is given). ``report
  --store S [--plot OUT.png] [--fail-on-drift] [--window N] ...`` prints
  the train-vs-live drift table and exits 4 on drift with
  ``--fail-on-drift`` (the verdict line on stderr). ``--spec F`` (the
  ConfigMap's pipeline YAML) on ``run-stage``, ``run-day``, ``run-sim``
  and ``deploy`` overrides ``--model``, ``--mode`` and ``--mlp-*``.

- ``fleet-sim --store S [--days N] [--tenants N] [--sabotage TENANT]
  [--seed N] [--samples-per-day N] [--model linear|mlp] [--mlp-*]
  [--json]`` runs N scenario-zoo tenants' pipelines in one store under
  ``tenants/<id>/``, one optionally NaN-sabotaged, and every healthy
  tenant again alone, whose artefacts must be byte-identical (exit 0 on
  a pass, 1 otherwise). ``serve --workers N [--metrics]`` serves through N
  spawned replica processes on one ``SO_REUSEPORT`` port, respawned on
  death, admitting against one budget, ``/metrics`` aggregated. ``serve
  --frontends N [--transport shm|tcp|unix] [--role auto|frontend|dispatcher]
  [--standby] [--dispatcher-addr A] [--leader-ttl S]`` splits serving into N
  torch-free front ends and one device-owning dispatcher (or an
  active/standby pair), with the JAX command's errors (exit 1).

Every command that opens a store takes ``--tenant ID``: its keys live
under ``tenants/<ID>/`` (``default``, or unset, is the root). The flag
beats ``BODYWORK_TPU_TENANT``; a malformed flag exits 1, a malformed
environment value falls back to the root with a warning.

``--device`` defaults to ``cuda``: without a card the command refuses to
run unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import date

from bodywork_tpu_torch.utils.dates import date_range, parse_date

#: the train command's modes (``train.trainer.TRAIN_MODES``) and the
#: serving dtypes (``serve.predictor.SERVE_DTYPES``), kept here so building
#: the parser imports no torch
TRAIN_MODES = ("full", "incremental")
SERVE_DTYPES = ("float32", "bfloat16", "int8")

#: the row-queue transports and serve roles (``serve.netqueue``'s
#: ``SERVE_TRANSPORTS`` and ``SERVE_ROLES``; a test pins them equal)
SERVE_TRANSPORTS = ("shm", "tcp", "unix")
SERVE_ROLES = ("auto", "frontend", "dispatcher")

#: serving engines the cli offers (``auto`` + the port's engine names)
SERVE_ENGINES = ("auto", "torch", "torch-bf16", "torch-int8", "kernel", "kernel-bf16",
                 "kernel-int8")


def _env_choice(name: str, choices: tuple, default: str) -> str:
    """An enum flag's default from the environment: a value outside
    ``choices`` is ignored with a note on stderr."""
    raw = os.environ.get(name, "").strip()
    if raw and raw not in choices:
        print(f"warning: ignoring {name}={raw!r} (expected one of {', '.join(choices)})",
              file=sys.stderr)
        raw = ""
    return raw or default


def _store(args):
    """The command's store, scoped to its tenant (:func:`_tenant_id`)."""
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.tenancy.namespace import scoped_store

    return scoped_store(open_store(args.store), _tenant_id(args))


def _tenant_id(args) -> str:
    """The command's tenant: ``--tenant`` > ``BODYWORK_TPU_TENANT`` > the
    default (root) namespace. The flag is validated strictly (a typo must
    fail, never read or write the root), the environment degrades to the
    root with a warning; both go through ``schema.validate_tenant_id``."""
    from bodywork_tpu_torch.store.schema import validate_tenant_id
    from bodywork_tpu_torch.tenancy.namespace import tenant_from_env

    tenant = getattr(args, "tenant", None)
    if tenant is not None:
        validate_tenant_id(tenant)
        return tenant
    return tenant_from_env()


def cmd_generate(args) -> int:
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    store = _store(args)
    start = parse_date(args.date) if args.date else date.today()
    for d in date_range(start, args.days):
        X, y = generate_day(d, device=device)
        print(persist_dataset(store, Dataset(X, y, d)))
    return 0


def _env_number(name: str, cast, minimum):
    """A number flag's default from the environment (None when unset); a
    malformed or out-of-range value is ignored with a note on stderr."""
    from bodywork_tpu_torch.utils.env import number_env

    return number_env(name, cast, minimum,
                      warn=lambda msg: print(f"warning: {msg}", file=sys.stderr))


def _env_paths(name: str) -> list:
    """A repeatable path flag's default from the environment: a
    colon-separated list (a Deployment cannot repeat a flag through one
    env var); empty segments drop."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return []
    return [p for p in raw.split(":") if p.strip()]


def _env_flag(name: str) -> bool:
    """A boolean flag's default from the environment: a malformed value
    is ignored (False) with a note on stderr."""
    raw = os.environ.get(name)
    if raw is None:
        return False
    value = raw.strip().lower()
    if value in ("1", "true", "yes", "on"):
        return True
    if value in ("", "0", "false", "no", "off"):
        return False
    print(f"warning: ignoring {name}={raw!r} (expected a boolean like 1/0/true/false)",
          file=sys.stderr)
    return False


def _bucket_list(raw: str) -> tuple[int, ...]:
    """``--buckets``: comma-separated positive ints."""
    from bodywork_tpu_torch.utils.env import bucket_list

    try:
        return bucket_list(raw)
    except ValueError as exc:
        raise argparse.ArgumentTypeError(str(exc)) from None


def cmd_serve(args) -> int:
    from bodywork_tpu_torch.serve import serve_latest_model
    from bodywork_tpu_torch.utils.logging import get_logger
    from bodywork_tpu_torch.utils.shutdown import (
        SIGTERM_EXIT,
        ShutdownRequested,
        graceful_sigterm,
    )

    log = get_logger("cli")

    # None = unset, 0 = coalescing off, > 0 = on; negative degrades to unset
    batch_window = (args.batch_window_ms
                    if args.batch_window_ms is not None and args.batch_window_ms >= 0
                    else None)
    if args.batch_max_rows and not batch_window and not args.tuned_config:
        log.warning("--batch-max-rows has no effect without --batch-window-ms; "
                    "request coalescing stays OFF")
    frontends = args.frontends
    transport = args.transport
    role = args.role
    standby = bool(args.standby)
    if frontends is not None and frontends >= 1 and args.workers > 1:
        # two incompatible scale-out topologies: replicas each own a
        # model; front ends share the one dispatcher's
        log.error("--frontends and --workers are mutually exclusive "
                  "scale-out modes; pick one")
        return 1
    if transport != "shm" and role == "auto" and not frontends:
        # the socket transports carry the front-end -> dispatcher
        # handoff; --workers replicas have no such handoff to move
        log.error("--transport tcp/unix requires --frontends N "
                  "(or a split --role)")
        return 1
    if standby and transport == "shm":
        log.error("--standby needs --transport tcp or unix: the shm "
                  "queue is single-host, where the supervisor respawn "
                  "is already the takeover path")
        return 1
    if role == "dispatcher":
        if not standby:
            return _serve_dispatcher_role(args, transport, batch_window, log)
        # --role dispatcher --standby: the active/standby PAIR under one
        # supervisor, no local HTTP (frontends=0)
        from bodywork_tpu_torch.serve.netqueue import DEFAULT_DISPATCHER_PORT

        if not args.dispatcher_addr:
            if transport == "unix":
                log.error("--role dispatcher with --transport unix "
                          "needs --dispatcher-addr (the socket path "
                          "to bind)")
                return 1
            args.dispatcher_addr = f"0.0.0.0:{DEFAULT_DISPATCHER_PORT}"
        frontends = 0
    if role == "frontend":
        if standby:
            # front ends need no flag to ride a failover: the standby
            # pair announces itself through the lease/fence alone
            log.warning("--standby concerns the dispatcher side; "
                        "ignoring it for --role frontend")
            standby = False
        if transport == "shm":
            log.error("--role frontend needs --transport tcp or unix "
                      "(a remote dispatcher is not reachable over "
                      "shared memory)")
            return 1
        if not args.dispatcher_addr:
            log.error("--role frontend needs --dispatcher-addr "
                      "(the dispatcher Service/host to connect to)")
            return 1
        frontends = frontends or 1
    if (args.workers and args.workers > 1) or (
            frontends is not None and (frontends >= 1 or standby)):
        if (args.mesh_data and args.mesh_data > 1) or args.mesh_model > 1:
            # each replica or dispatcher owns its own single-device model
            log.error("--workers/--frontends is per-process serving; drop "
                      "--mesh-data/--mesh-model")
            return 1
        return _serve_workers(args, batch_window, log, frontends=frontends,
                              transport=transport, standby=standby,
                              external_dispatcher=role == "frontend")
    # serve_latest_model drains on a SIGTERM while serving (admission
    # closed, coalescer flushed); one during start-up unwinds to here
    with graceful_sigterm() as sigterm_fired:
        try:
            serve_latest_model(
                _store(args), host=args.host, port=args.port, block=True,
                engine=args.engine, device=args.device, dtype=args.dtype,
                buckets=args.buckets, batch_window_ms=batch_window,
                batch_max_rows=args.batch_max_rows, server_engine=args.server_engine,
                max_pending=args.max_pending, retry_after_max_s=args.retry_after_max_s,
                watch_interval_s=args.reload_interval or None,
                tuned_config=args.tuned_config, online_tune=args.online_tune,
                tune_request_logs=tuple(args.tune_request_log or ()),
                tune_results_logs=tuple(args.tune_results_log or ()),
                cost_budget_s=args.cost_budget_s, mesh_data=args.mesh_data,
                mesh_model=args.mesh_model,
            )
        except ShutdownRequested:
            log.warning("SIGTERM during service startup; exiting")
    return SIGTERM_EXIT if sigterm_fired.is_set() else 0


def _serve_dispatcher_role(args, transport: str, batch_window, log) -> int:
    """``serve --role dispatcher``: the device-owning half of the
    cross-host split, standalone — serves the socket row-queue instead of
    HTTP (the k8s dispatcher Deployment's entrypoint). No supervisor wraps
    it here; the Deployment's restartPolicy is the respawn loop, and the
    front ends' reconnect backoff is the heal path."""
    from bodywork_tpu_torch.serve.dispatch import dispatcher_main
    from bodywork_tpu_torch.serve.netqueue import (
        DEFAULT_DISPATCHER_PORT,
        parse_dispatcher_addr,
    )

    if transport == "shm":
        log.error("--role dispatcher needs --transport tcp or unix "
                  "(remote front-ends cannot attach to this process's "
                  "shared memory)")
        return 1
    addr = args.dispatcher_addr
    if not addr:
        if transport == "unix":
            log.error("--role dispatcher with --transport unix needs "
                      "--dispatcher-addr (the socket path to bind)")
            return 1
        # tcp default: every interface on the well-known port, which is
        # what the dispatcher k8s Service targets
        addr = f"0.0.0.0:{DEFAULT_DISPATCHER_PORT}"
    try:
        parsed = parse_dispatcher_addr(transport, addr)
    except ValueError as exc:
        log.error(str(exc))
        return 1
    # dispatcher_main installs its own SIGTERM -> clean-exit handler (it is
    # the entrypoint the fleet supervisor spawns)
    dispatcher_main(
        args.store, None, None, engine=args.engine,
        watch_interval_s=args.reload_interval or None, buckets=args.buckets,
        batch_window_ms=batch_window, batch_max_rows=args.batch_max_rows,
        dtype=args.dtype, tuned_config=args.tuned_config, transport=transport,
        dispatcher_addr=parsed, leader_ttl_s=args.leader_ttl, device=args.device,
        tenant=_tenant_id(args),
    )
    return 0


def _serve_workers(args, batch_window, log, frontends=None, transport="shm",
                   standby=False, external_dispatcher=False) -> int:
    """``serve --workers N``: N spawned replica processes on one
    ``SO_REUSEPORT`` port under a respawning supervisor
    (``serve.multiproc``); with ``frontends`` the split topology instead
    (N front ends and the dispatcher, or the standby pair); exits 143 on
    SIGTERM after stopping them."""
    from bodywork_tpu_torch.serve.multiproc import MultiProcessService
    from bodywork_tpu_torch.utils.shutdown import (
        SIGTERM_EXIT,
        ShutdownRequested,
        graceful_sigterm,
    )

    if (args.online_tune or args.cost_budget_s or args.tune_request_log
            or args.tune_results_log):
        log.warning("--online-tune/--cost-budget-s/--tune-*-log apply to single-process "
                    "serving; the --workers/--frontends processes run without them")
    svc = MultiProcessService(
        args.store, host=args.host, port=args.port, workers=args.workers,
        engine=args.engine, watch_interval_s=args.reload_interval or None,
        buckets=args.buckets, batch_window_ms=batch_window,
        batch_max_rows=args.batch_max_rows, metrics=args.metrics,
        server_engine=args.server_engine, max_pending=args.max_pending,
        retry_after_max_s=args.retry_after_max_s, dtype=args.dtype,
        tuned_config=args.tuned_config, device=args.device, tenant=_tenant_id(args),
        frontends=frontends, transport=transport, dispatcher_addr=args.dispatcher_addr,
        external_dispatcher=external_dispatcher, standby=standby,
        leader_ttl_s=args.leader_ttl,
    ).start()
    if svc.metrics_url:
        log.info(f"aggregated metrics at {svc.metrics_url}")
    try:
        # SIGTERM (a pod's stop) unwinds the wait and stops the replicas
        with graceful_sigterm() as sigterm_fired:
            try:
                svc.wait()
            except ShutdownRequested:
                log.warning("SIGTERM: stopping serving replicas")
                svc.stop()
        return SIGTERM_EXIT if sigterm_fired.is_set() else 0
    except KeyboardInterrupt:
        return 0
    finally:
        svc.stop()


def cmd_test(args) -> int:
    from bodywork_tpu_torch.monitor import (
        HttpScoringClient,
        run_service_test,
        scoring_endpoint,
    )

    client = HttpScoringClient(scoring_endpoint(args.scoring_url, args.mode))
    metrics = run_service_test(
        _store(args), client, mode=args.mode, max_rows=args.max_rows,
    )
    print(json.dumps({k: str(v) if isinstance(v, date) else v for k, v in metrics.items()}))
    return 0


def _mlp_kwargs(args) -> dict:
    """The MLP config overrides given on the command line, as the flat
    kwargs ``make_model`` takes."""
    kwargs = {}
    if args.mlp_hidden is not None:
        kwargs["hidden"] = args.mlp_hidden
    if args.mlp_steps is not None:
        kwargs["n_steps"] = args.mlp_steps
    if args.mlp_lr is not None:
        kwargs["learning_rate"] = args.mlp_lr
    if kwargs and args.model != "mlp":
        raise SystemExit("--mlp-hidden/--mlp-steps/--mlp-lr apply to --model mlp only")
    return kwargs


def cmd_train(args) -> int:
    from bodywork_tpu_torch.train import train_on_history

    result = train_on_history(_store(args), args.model,
                              model_kwargs=_mlp_kwargs(args) or None, mode=args.mode,
                              device=args.device, mesh_data=args.mesh_data,
                              mesh_model=args.mesh_model)
    m = result.metrics
    fallback = f" fallback={result.fallback_reason}" if result.fallback_reason else ""
    print(f"{result.model_artefact_key} MAPE={m['MAPE']:.4f} r2={m['r_squared']:.4f} "
          f"mode={result.mode} rows_touched={result.rows_touched}{fallback}")
    return 0


def _pipeline_spec(args):
    """The pipeline spec of an orchestration command: an explicit
    ``--spec`` YAML wins (how in-cluster pods receive the deploy-time
    spec through the ConfigMap); otherwise the default pipeline built
    from ``--model``, ``--mode``, ``--overlap-generate`` and ``--mlp-*``."""
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE, PipelineSpec, default_pipeline

    if getattr(args, "spec", None):
        from pathlib import Path

        return PipelineSpec.from_yaml(Path(args.spec).read_text())
    spec = default_pipeline(args.model, args.mode,
                            overlap_generate=getattr(args, "overlap_generate", False))
    if hasattr(args, "mlp_hidden"):
        spec.stages[TRAIN_STAGE].args.update(_mlp_kwargs(args))
    return spec


def _runner(args):
    """The day loop's runner, over the store wrapped in the kill switch
    that ``BODYWORK_TPU_CRASH_SCHEDULE`` arms (untouched when unset)."""
    from bodywork_tpu_torch.chaos.kill import arm_from_env, wrap_store
    from bodywork_tpu_torch.data.drift_config import DriftConfig
    from bodywork_tpu_torch.pipeline import LocalRunner

    arm_from_env()
    spec = _pipeline_spec(args)
    samples = getattr(args, "samples_per_day", None)
    drift = DriftConfig(n_samples=samples) if samples else None
    return LocalRunner(spec, wrap_store(_store(args)), drift=drift,
                       device=args.device)


def _day_loop(run, what: str) -> tuple[object, int | None]:
    """Run ``run()`` under the graceful SIGTERM handler: ``(result,
    None)``, or ``(None, exit code)`` when the run lost its lease (5).
    On SIGTERM the journal is already durable and the process exits 143
    at once, skipping interpreter teardown, which a daemon thread still
    inside a CUDA call or a first-use kernel build can crash."""
    from bodywork_tpu_torch.pipeline.journal import LEASE_LOST_EXIT, LeaseLost
    from bodywork_tpu_torch.utils.logging import get_logger
    from bodywork_tpu_torch.utils.shutdown import SIGTERM_EXIT, ShutdownRequested, graceful_sigterm

    log = get_logger("cli")
    try:
        with graceful_sigterm():
            return run(), None
    except LeaseLost as exc:
        log.error(f"{exc}; exiting {LEASE_LOST_EXIT} (lease lost)")
        return None, LEASE_LOST_EXIT
    except ShutdownRequested:
        log.warning(f"{what} interrupted by SIGTERM; the journal marks the day "
                    "'interrupted' and the next run resumes it")
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(SIGTERM_EXIT)


def _print_day(r) -> None:
    from bodywork_tpu_torch.pipeline.runner import GATE_RESULT
    from bodywork_tpu_torch.pipeline.spec import SERVE_STAGE

    print(f"day {r.day}: {r.wall_clock_s:.3f}s")
    for name, secs in r.stage_seconds.items():
        print(f"  {name}: {secs:.3f}s")
    if r.gate_seconds is not None:
        decision = r.stage_results.get(GATE_RESULT)
        verdict = ("nothing to gate" if decision is None
                   else f"{'PROMOTED' if decision.promote else 'REJECTED'} "
                        f"{decision.model_key}")
        print(f"  {GATE_RESULT}: {r.gate_seconds:.3f}s ({verdict})")
    app = getattr(r.stage_results.get(SERVE_STAGE), "app", None)
    if app is not None:
        from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES

        health = app.healthz_payload()
        print(f"  served: {health['model_key']} ({health['model_source']}) on "
              f"{health['engine']}, {health['launches'] or 0} kernel launches in this process")
        print(f"  launches by kernel in this process: {json.dumps(LAUNCHES, sort_keys=True)}")
    sys.stdout.flush()


def _derived_report_path(trace_out: str) -> str:
    """``day.trace.json`` -> ``day.report.json`` (or ``<path>.report.json``
    when the trace path has no ``.trace.json`` suffix)."""
    if trace_out.endswith(".trace.json"):
        return trace_out[: -len(".trace.json")] + ".report.json"
    return trace_out + ".report.json"


#: date-keyed trace and report files kept per ``{date}`` template
TRACE_RETENTION = 30


def _prune_templated(template: str, keep: int = TRACE_RETENTION) -> None:
    """Drop all but the newest ``keep`` files matching a ``{date}``
    template (ISO dates sort in time order); an explicit path is the
    operator's to manage."""
    import glob

    # escape the path first: a '[' or '*' in it must stay literal
    files = sorted(glob.glob(glob.escape(template).replace("{date}", "*")))
    for old in files[:-keep]:
        try:
            os.remove(old)
        except OSError:  # a concurrent pruner got it first
            pass


def _write_day_outputs(args, runner, result, d: date, fsck: dict | None = None) -> None:
    """``run-day --trace-out/--report-out``: the runner's whole timeline
    (bootstrap included) as a Chrome trace, and the day's report."""
    from bodywork_tpu_torch.obs.spans import day_report, write_chrome_trace, write_day_report

    trace_out = args.trace_out.replace("{date}", str(d)) if args.trace_out else None
    report_out = args.report_out.replace("{date}", str(d)) if args.report_out else None
    if trace_out:
        path = write_chrome_trace(trace_out, runner.recorder.spans(),
                                  process_name=f"run-day {d}")
        print(f"trace: {path}")
    path = write_day_report(report_out or _derived_report_path(trace_out),
                            day_report(result, fsck=fsck, tenant=_tenant_id(args)))
    print(f"report: {path}")
    if args.trace_out and "{date}" in args.trace_out:
        _prune_templated(args.trace_out)
        if not args.report_out:
            _prune_templated(_derived_report_path(args.trace_out))
    if args.report_out and "{date}" in args.report_out:
        _prune_templated(args.report_out)


def cmd_run_day(args) -> int:
    from bodywork_tpu_torch.pipeline.journal import RESUMED_NOOP_EXIT

    runner = _runner(args)
    d = parse_date(args.date) if args.date else date.today()

    def run():
        runner.bootstrap(d)
        return runner.run_day(d, resume=not args.no_resume)

    result, code = _day_loop(run, "run-day")
    if code is not None:
        return code
    if result.noop:
        print(f"day {d}: already complete (resumed as a no-op)")
        return RESUMED_NOOP_EXIT
    if result.skipped_stages:
        print(f"day {d}: resumed — skipped {', '.join(result.skipped_stages)} "
              "(journal-verified)")
    _print_day(result)
    fsck_report = None
    if args.scrub:
        # detect-only scrub after the day converges: the findings are
        # printed, counted on the audit counters and ride the day report.
        # The day's snapshot compactor finishes first: a scrub listing the
        # store while it writes a snapshot and its sidecar finds the
        # sidecar without its primary (the JAX command scrubs without
        # waiting, and can report that orphan)
        from bodywork_tpu_torch.audit import run_fsck

        runner._drain_compactor()
        fsck_report = run_fsck(runner.store, repair=False)
        by_sev = fsck_report["by_severity"]
        print("fsck: " + (", ".join(f"{s}={n}" for s, n in sorted(by_sev.items()))
                          or "clean"))
    if args.trace_out or args.report_out:
        _write_day_outputs(args, runner, result, d, fsck_report)
    return 0


def cmd_run_sim(args) -> int:
    runner = _runner(args)
    start = parse_date(args.date) if args.date else date.today()
    results, code = _day_loop(
        lambda: runner.run_simulation(start, args.days, on_day=_print_day,
                                      profile_dir=args.profile_dir), "run-sim")
    if code is not None:
        return code
    total = sum(r.wall_clock_s for r in results)
    print(f"total {total:.3f}s over {args.days} day(s), "
          f"mean {total / max(args.days, 1):.3f}s/day")
    if args.profile_dir:
        from bodywork_tpu_torch.utils.profiling import trace_path

        print(f"profile: {trace_path(args.profile_dir, f'{args.days}-day simulation')}")
    if args.trace_out:
        from bodywork_tpu_torch.obs.spans import write_chrome_trace

        path = write_chrome_trace(args.trace_out, runner.recorder.spans(),
                                  process_name=f"run-sim {args.days}d")
        print(f"trace: {path}")
    return 0


def cmd_run_stage(args) -> int:
    """Run one named stage of the pipeline: the per-pod entry point the
    k8s manifests use. A service stage blocks for the pod's lifetime on
    its declared port; the process installs no SIGTERM handler, so a
    SIGTERM ends it as it ends the JAX command."""
    from bodywork_tpu_torch.pipeline.runner import resolve_executable
    from bodywork_tpu_torch.pipeline.stages import StageContext
    from bodywork_tpu_torch.utils.errors import tag_stage
    from bodywork_tpu_torch.utils.logging import get_logger

    spec = _pipeline_spec(args)
    if args.stage not in spec.stages:
        get_logger("cli").error(f"unknown stage {args.stage!r}; have {sorted(spec.stages)}")
        return 1
    # every stage pod reports under its own stage name, not the
    # 'cli-run-stage' tag main() set before the stage was known
    tag_stage(args.stage)
    stage = spec.stages[args.stage]
    # the device as asked for: only a stage that uses one resolves it
    ctx = StageContext(store=_store(args), today=_date(args), device=args.device,
                       scoring_url=args.scoring_url)
    fn = resolve_executable(stage.executable)
    get_logger("cli").info(f"run-stage {stage.name} ({stage.kind}) for {ctx.today}")
    if stage.kind == "service":
        handle = fn(ctx, host="0.0.0.0", port=stage.port or 5000, **stage.args)
        handle.wait()
    else:
        fn(ctx, **stage.args)
    return 0


def _url_ok(url: str) -> bool:
    """True when ``url`` answers a status below 400 within 2 s."""
    import http.client
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=2) as resp:
            return resp.status < 400
    except (OSError, http.client.HTTPException, ValueError):
        return False


def cmd_wait_for(args) -> int:
    """Block until pipeline preconditions hold: the DAG-ordering gate of
    the k8s materialisation (every Job's initContainer). Exit 0 with
    "conditions met", or 1 when ``--timeout`` passes first."""
    import time

    from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, MODELS_PREFIX
    from bodywork_tpu_torch.utils.logging import get_logger

    store = _store(args)
    deadline = time.monotonic() + args.timeout

    def _conditions_met() -> bool:
        if args.dataset and not store.history(DATASETS_PREFIX):
            return False
        if args.model and not store.history(MODELS_PREFIX):
            return False
        if args.dataset_newer_than_model:
            datasets = store.history(DATASETS_PREFIX)
            models = store.history(MODELS_PREFIX)
            if not datasets or not models or datasets[-1][1] <= models[-1][1]:
                return False
        return not args.service_url or _url_ok(args.service_url)

    while not _conditions_met():
        if time.monotonic() > deadline:
            get_logger("cli").error(f"wait-for conditions not met within {args.timeout}s")
            return 1
        time.sleep(args.poll_interval)
    print("conditions met")
    return 0


#: ``report --fail-on-drift`` exit code: not 1 (error), 2 (usage) or 3
DRIFT_EXIT = 4


def cmd_report(args) -> int:
    """The train-vs-live drift table on stdout (``--plot``: the dashboard
    too); the drift verdict on stderr, exit 4 with ``--fail-on-drift``."""
    from bodywork_tpu_torch.monitor.analytics import (
        detect_drift,
        drift_report,
        format_drift_report,
    )
    from bodywork_tpu_torch.utils.logging import get_logger

    store = _store(args)
    report = drift_report(store)
    if not report:
        print("no metric history yet")
        return 0
    print(format_drift_report(report))
    if args.plot:
        from bodywork_tpu_torch.monitor.analytics import render_drift_dashboard

        # a failure here (matplotlib missing) is a logged error and exit 1,
        # as the JAX command's catch-all makes it
        try:
            print(render_drift_dashboard(store, args.plot, report=report))
        except Exception as exc:  # noqa: BLE001
            get_logger("cli").error(exc)
            return 1
    verdict = detect_drift(
        report, mape_ratio=args.mape_ratio, corr_floor=args.corr_floor,
        window=args.window, bias_z=args.bias_z,
        bias_window=args.bias_window, bias_baseline=args.bias_baseline,
    )
    if verdict["drifted"]:
        # stderr: stdout carries the (parseable) table
        scope = f"last {args.window} day(s)" if args.window is not None else "all history"
        rules = f"bias |z| > {args.bias_z} over {args.bias_window}d or corr < {args.corr_floor}"
        if args.mape_ratio is not None:
            rules += f" or MAPE_live > {args.mape_ratio} x MAPE_train"
        print(
            f"DRIFT: {len(verdict['flagged_dates'])}/{verdict['n_days']} "
            f"day(s) flagged over {scope}, first "
            f"{verdict['first_flagged_date']} ({rules})",
            file=sys.stderr,
        )
        if args.fail_on_drift:
            return DRIFT_EXIT
    return 0


def cmd_deploy(args) -> int:
    """Write the GKE manifests (and, with ``--emit-images``, the per-stage
    image build contexts). Manifests that reference derived per-stage
    image tags with no build contexts emitted would ship pods that cannot
    pull their image: refused (exit 1) unless ``--force``."""
    from bodywork_tpu_torch.pipeline.images import uses_derived_tag, write_stage_images
    from bodywork_tpu_torch.pipeline.k8s import write_manifests
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    spec = _pipeline_spec(args)
    derived = [s.name for s in spec.stages.values() if uses_derived_tag(s)]
    if derived and not args.emit_images:
        if not args.force:
            log.error(
                f"stages {derived} reference derived per-stage image tags "
                "that nothing builds: pass --emit-images DIR to emit "
                "their build contexts (then run build.sh), or --force to "
                "write the manifests anyway"
            )
            return 1
        log.warning(
            f"--force: manifests reference derived per-stage image tags "
            f"for {derived} with no build contexts emitted; pods will "
            "ImagePullBackOff until the images are built and pushed"
        )
    written = write_manifests(
        spec, args.out, store_path=args.store_path, image=args.image,
        store_volume=args.store_volume, storage_class=args.storage_class or None,
        pvc_size=args.pvc_size,
    )
    for path in written:
        print(path)
    if args.emit_images:
        for path in write_stage_images(spec, args.emit_images, image=args.image):
            print(path)
    return 0


def cmd_compact(args) -> int:
    """Consolidate the dataset history into one ``snapshots/`` artefact, so
    a cold process loads it in O(1 + tail) reads; ``--dry-run`` prints
    what it would consolidate and writes nothing."""
    from bodywork_tpu_torch.data.snapshot import SNAPSHOT_KEEP, plan_compaction, write_snapshot
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = _store(args)
    plan = plan_compaction(store)
    if plan["days"] == 0:
        print("no datasets to consolidate")
        return 0
    if plan["days_without_tokens"]:
        print(f"warning: {plan['days_without_tokens']} day(s) have no version token "
              "(the backend cannot verify them) and will be skipped", file=sys.stderr)
    if plan["would_write"] is None:
        # exiting 0 here would let a scheduled job claim success forever
        log.error("nothing consolidatable: the backend reports no version token "
                  "for any dataset day")
        return 1
    print(f"{len(plan['covered_days'])} day(s) ({plan['covered_days'][0]} .. "
          f"{plan['covered_days'][-1]}), {plan['rows']} rows, "
          f"~{plan['estimated_bytes']} bytes; latest snapshot: "
          f"{plan['latest_snapshot'] or 'none'}")
    if args.dry_run:
        print(f"dry-run: would write {plan['would_write']}")
        return 0
    key = write_snapshot(store, keep=args.keep or SNAPSHOT_KEEP)
    if key is None:
        log.error("compaction wrote nothing (the store changed mid-run?)")
        return 1
    print(key)
    return 0


#: ``registry rollback`` exit when the restore target fails
#: pre-verification (missing ``previous`` checkpoint, or bytes that no
#: longer match its record's digest): the alias did NOT move
ROLLBACK_REFUSED_EXIT = 8

#: alias names ``registry show`` resolves
_REGISTRY_ALIASES = ("production", "previous")


def _date(args) -> date:
    return parse_date(args.date) if args.date else date.today()


def _registry_model_key(raw: str) -> str:
    """A full model key, a bare checkpoint basename, or a date."""
    from bodywork_tpu_torch.store.schema import MODELS_PREFIX

    if raw.startswith(MODELS_PREFIX):
        return raw
    try:
        return f"{MODELS_PREFIX}regressor-{parse_date(raw)}.npz"
    except ValueError:
        return f"{MODELS_PREFIX}{raw}"


def _registry_errors(fn):
    """Run a registry command; a registry error is logged and exits 1."""
    def run(args) -> int:
        from bodywork_tpu_torch.registry import RegistryCorrupt, RegistryError
        from bodywork_tpu_torch.utils.logging import get_logger

        try:
            return fn(args)
        except (RegistryError, RegistryCorrupt) as exc:
            get_logger("cli").error(exc)
            return 1

    return run


@_registry_errors
def cmd_registry_list(args) -> int:
    from bodywork_tpu_torch.registry import ModelRegistry, read_aliases

    store = _store(args)
    records = ModelRegistry(store).records()
    if not records:
        print("no registry records")
        return 0
    aliases = read_aliases(store) or {}
    production, previous = aliases.get("production"), aliases.get("previous")
    print(f"{'MODEL KEY':<42} {'STATUS':<10} {'DATE':<10} ALIAS")
    for record in records:
        alias = ("production" if record["model_key"] == production
                 else "previous" if record["model_key"] == previous else "")
        print(f"{record['model_key']:<42} {record['status']:<10} "
              f"{record.get('data_date') or '-':<10} {alias}")
    return 0


@_registry_errors
def cmd_registry_show(args) -> int:
    from bodywork_tpu_torch.registry import read_aliases, resolve_alias
    from bodywork_tpu_torch.registry.records import load_record
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = _store(args)
    what = args.what
    if what in _REGISTRY_ALIASES:
        key = resolve_alias(store, what)
        if key is None:
            log.error(f"alias {what!r} is not set (no promotion yet?)")
            return 1
    elif what == "aliases":
        doc = read_aliases(store)
        if doc is None:
            log.error("no registry alias document")
            return 1
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    elif "/" not in what and "." not in what and not any(c.isdigit() for c in what):
        log.error(f"unknown alias {what!r}; known aliases: "
                  f"{', '.join(_REGISTRY_ALIASES)} (or pass a model key/date)")
        return 1
    else:
        key = _registry_model_key(what)
    record = load_record(store, key)
    if record is None:
        log.error(f"no registry record for {key!r}")
        return 1
    print(json.dumps(record, indent=2, sort_keys=True))
    return 0


@_registry_errors
def cmd_registry_promote(args) -> int:
    from bodywork_tpu_torch.registry import ModelRegistry

    doc = ModelRegistry(_store(args)).promote(
        _registry_model_key(args.model), day=_date(args), reason="cli: operator promote")
    print(f"production -> {doc['production']} (previous: {doc['previous']})")
    return 0


@_registry_errors
def cmd_registry_rollback(args) -> int:
    from bodywork_tpu_torch.registry import ModelRegistry, RollbackBlocked
    from bodywork_tpu_torch.utils.logging import get_logger

    try:
        doc = ModelRegistry(_store(args)).rollback(
            day=_date(args), reason="cli: operator rollback")
    except RollbackBlocked as exc:
        get_logger("cli").error(
            f"rollback refused: {exc} — the alias did not move; repair the "
            "checkpoint (or promote a known-good one) and retry"
        )
        return ROLLBACK_REFUSED_EXIT
    print(f"production -> {doc['production']} (previous: {doc['previous']})")
    return 0


@_registry_errors
def cmd_registry_gate(args) -> int:
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.registry import GatePolicy, ModelRegistry

    policy = GatePolicy()
    device = None
    if args.shadow_days is not None:
        policy.shadow_days = args.shadow_days
        device = resolve_device(args.device)  # the shadow scores on it
    registry = ModelRegistry(_store(args), policy=policy, device=device)
    key = _registry_model_key(args.model) if args.model else None
    decision = registry.gate(day=_date(args), model_key=key, dry_run=args.dry_run)
    if decision is None:
        print("no candidate to gate")
        return 0
    verdict = "PROMOTE" if decision.promote else "REJECT"
    prefix = "dry-run: would " if args.dry_run else ""
    print(f"{prefix}{verdict} {decision.model_key}")
    for check in decision.checks:
        print(f"  [{'ok' if check['ok'] else 'FAIL'}] {check['name']}: {check['detail']}")
    return 0


@_registry_errors
def cmd_registry_canary(args) -> int:
    """The canary lifecycle: every action one alias CAS through
    :class:`ModelRegistry` (the actions are ``registry.CANARY_ACTIONS``)."""
    from bodywork_tpu_torch.registry import ModelRegistry
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    registry = ModelRegistry(_store(args))
    action = args.canary_command
    if action == "start":
        key = _registry_model_key(args.model) if args.model else None
        if key is None:
            candidate = registry.newest_candidate()
            if candidate is None:
                log.error("no candidate record to canary; train or pass --model")
                return 1
            key = candidate["model_key"]
        doc = registry.canary_start(key, fraction=args.fraction, seed=args.seed,
                                    day=_date(args))
        print(f"canary -> {doc['canary']} at fraction {doc['canary_fraction']} "
              f"(seed {doc['canary_seed']}, production {doc['production']})")
        return 0
    if action == "stop":
        doc = registry.canary_abort(day=_date(args), reason="cli: operator stop")
        if doc is None:
            log.error("no live canary to stop")
            return 1
        print(f"canary stopped (production stays {doc['production']})")
        return 0
    if action == "promote":
        doc = registry.canary_promote(day=_date(args), reason="cli: operator promote")
        print(f"production -> {doc['production']} (previous: {doc['previous']})")
        return 0
    print(json.dumps(registry.canary_status(), indent=2, sort_keys=True))
    return 0


def cmd_traffic_run(args) -> int:
    """Open-loop load: generate (or replay) a seeded request log and drive
    it at its scheduled arrival times against a live scoring service.
    stdout carries one JSON document, the load report; exit 1 on a bad
    log, an unreachable target or nothing to do."""
    from bodywork_tpu_torch.traffic import (
        TrafficConfig,
        generate_request_log,
        read_request_log,
        run_open_loop,
        write_request_log,
    )
    from bodywork_tpu_torch.traffic.runner import format_report
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    try:
        if args.log_in:
            config, requests = read_request_log(args.log_in)
            log.info(f"replaying {len(requests)} requests from {args.log_in} "
                     f"(seed {config.seed}, {config.arrival})")
        else:
            config = TrafficConfig(
                rate_rps=args.rate, duration_s=args.duration, arrival=args.arrival,
                batch_fraction=args.batch_fraction, batch_rows=args.batch_rows,
                seed=args.seed, burst_multiplier=args.burst_multiplier,
            )
            requests = generate_request_log(config)
        if args.log_out:
            write_request_log(args.log_out, config, requests)
        if args.url is None:
            if not args.log_out:
                log.error("nothing to do: need --url (drive) or --log-out (generate only)")
                return 1
            return 0
        report = run_open_loop(args.url, requests, timeout_s=args.timeout,
                               results_log=args.results_out, transport_kind=args.transport,
                               shards=args.shards)
        print(format_report(report))
        return 0
    except (OSError, ValueError) as exc:
        log.error(f"traffic run failed: {exc}")
        return 1


def cmd_run_ab(args) -> int:
    """N model variants as concurrent isolated pipelines sharing the card
    (BASELINE.json config 5), then their drift reports side by side;
    exit 1 when a variant failed."""
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.pipeline import (
        compare_report,
        format_compare_report,
        run_ab_simulation,
        variants_from_model_types,
    )

    variants = variants_from_model_types(args.models.split(","))
    results = run_ab_simulation(variants, args.store, _date(args), args.days,
                                devices=[resolve_device(args.device)])
    failed = [v for v in results.values() if v.error is not None]
    table = format_compare_report(compare_report(results))
    if table:
        print(table)
    for v in failed:
        print(f"variant {v.name} FAILED: {v.error!r}")
    return 1 if failed else 0


def cmd_chaos_canary(args) -> int:
    """Canary release-safety acceptance: one seeded sabotage scenario on a
    fresh store; stdout carries the summary (JSON). Exit 0 on a verified
    PASS, 1 otherwise."""
    from bodywork_tpu_torch.chaos import run_canary_chaos
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    if "://" in args.store:
        log.error("chaos canary needs a fresh local store for the twin comparison; "
                  "point --store at a directory")
        return 1
    try:
        summary = run_canary_chaos(
            open_store(args.store), scenario=args.scenario, seed=args.seed,
            n_requests=args.requests, fraction=args.fraction,
            samples_per_day=args.samples_per_day or 96, device=args.device,
        )
    except ValueError as exc:
        log.error(exc)
        return 1
    print(json.dumps(summary, indent=2, sort_keys=True))
    if summary["ok"]:
        return 0
    log.error(f"canary chaos scenario {args.scenario!r} FAILED")
    return 1


#: ``fsck`` exit when actionable integrity findings remain after the scan
#: (and, with ``--repair``, after the repairs that could run)
FSCK_FINDINGS_EXIT = 7


def _tune_status(store) -> int:
    """``cli tune status``: the active tuned config (digest, the
    observation window it was fitted from, each knob's source: tuned,
    default or env-override) and the config log's applied/reverted
    history. Exit 1 on a corrupt config log or active document: corrupt
    must never read as defaults."""
    from bodywork_tpu_torch.registry.configlog import ConfigLogCorrupt, read_config_log
    from bodywork_tpu_torch.tune.config import (
        KNOB_DEFAULTS,
        TUNED_KNOB_ENV,
        _resolve_ref,
        load_tuned_config,
    )
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    try:
        log_doc = read_config_log(store)
    except ConfigLogCorrupt as exc:
        log.error(str(exc))
        return 1
    # the config log's active entry where the online controller wrote
    # one, else the newest tuned document (what `--tuned-config latest`
    # would serve)
    if log_doc is not None and log_doc.get("active"):
        active_key = log_doc["active"]["key"]
    else:
        active_key = _resolve_ref(store, "latest")
    knobs = digest = doc = None
    if active_key is not None:
        knobs, digest, doc = load_tuned_config(store, active_key)
        if doc is None:
            log.error(f"active tuned config {active_key!r} is unreadable or "
                      "fails validation")
            return 1
    per_knob = {}
    for knob, env_name in TUNED_KNOB_ENV.items():
        if os.environ.get(env_name, "").strip():
            per_knob[knob] = {"source": "env-override",
                              "value": os.environ[env_name].strip()}
        elif knobs is not None and knob in knobs:
            per_knob[knob] = {"source": "tuned", "value": knobs[knob]}
        else:
            default = KNOB_DEFAULTS.get(knob)
            per_knob[knob] = {"source": "default",
                              "value": list(default) if isinstance(default, tuple)
                              else default}
    out = {
        "active": ({"key": active_key, "digest": digest,
                    "observations": doc.get("observations"),
                    "cost_model": doc.get("cost_model")}
                   if doc is not None else None),
        "knobs": per_knob,
        "config_log": ({"rev": log_doc.get("rev"), "last_op": log_doc.get("last_op"),
                        "previous": (log_doc["previous"]["digest"]
                                     if log_doc.get("previous") else None),
                        "history": log_doc.get("history")}
                       if log_doc is not None else None),
    }
    print(json.dumps(out, indent=2))
    return 0


def cmd_tune(args) -> int:
    """Fit the serving knobs from observed traces: ingest ``traffic run``
    request and results logs, obs snapshots and day reports into one
    observation table, probe the serving checkpoint's per-bucket
    dispatch cost on ``--device`` (the card unless asked for the CPU),
    fit the learned cost model on the probe's curve and the knobs on the
    table, and persist the tuned config under ``tuning/`` (what ``serve
    --tuned-config latest`` consumes). stdout is one JSON document; exit
    1 when there is nothing to ingest. ``tune status`` reports the active
    config instead (:func:`_tune_status`)."""
    from bodywork_tpu_torch.obs.spans import SpanRecorder, write_chrome_trace
    from bodywork_tpu_torch.registry.records import RegistryCorrupt
    from bodywork_tpu_torch.store.base import ArtefactNotFound
    from bodywork_tpu_torch.tune.collect import (
        ObservationTable,
        ingest_day_report,
        ingest_obs_snapshot,
        ingest_request_log,
        ingest_results_log,
    )
    from bodywork_tpu_torch.tune.config import KNOB_DEFAULTS, write_tuned_config
    from bodywork_tpu_torch.tune.model import fit_tuned_config
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = _store(args)
    if args.action == "status":
        return _tune_status(store)
    device = None
    if args.probe:
        from bodywork_tpu_torch.device import resolve_device

        device = resolve_device(args.device)  # no card and no --device cpu: raises
    table = ObservationTable()
    try:
        for path in args.traffic_log:
            n = ingest_request_log(table, path)
            log.info(f"ingested {n} scheduled requests from {path}")
        for path in args.results_log:
            n = ingest_results_log(table, path)
            log.info(f"ingested {n} request outcomes from {path}")
        for path in args.obs_snapshot:
            ingest_obs_snapshot(table, path)
            log.info(f"ingested obs snapshot {path}")
        for path in args.day_report:
            ingest_day_report(table, path)
            log.info(f"ingested day report {path}")
    except (OSError, ValueError, KeyError) as exc:
        log.error(f"trace ingestion failed: {exc}")
        return 1
    n_features = None
    if args.probe:
        from bodywork_tpu_torch.tune.collect import probe_dispatch_costs

        try:
            table.dispatch_cost_s = probe_dispatch_costs(
                store, tuple(args.probe_buckets), reps=args.probe_reps, device=device)
            table.sources.append("dispatch_probe")
        except (ArtefactNotFound, RegistryCorrupt) as exc:
            # no serviceable checkpoint: the probe is one evidence source,
            # not a precondition (a device fault still raises)
            log.warning(f"dispatch-cost probe unavailable ({exc!r}); "
                        "fitting from passive traces only")
        else:
            from bodywork_tpu_torch.models.checkpoint import load_model, resolve_serving_key

            n_features = load_model(store, resolve_serving_key(store)[0],
                                    device=device)[0].n_features or 1
    cost_model_out = None
    if table.dispatch_cost_s and n_features is not None and not args.dry_run:
        # the measured curve is also the learned cost model's training
        # data: fitted and persisted beside the tuned config, so the
        # online controller and the cost-priced shed can price what the
        # probe never measured (a curve below MIN_SAMPLES rungs skips)
        from bodywork_tpu_torch.tune.costmodel import (
            fit_cost_model,
            samples_from_probe,
            write_cost_model,
        )

        try:
            cm_doc = fit_cost_model(samples_from_probe(table.dispatch_cost_s, n_features))
        except ValueError as exc:
            log.warning(f"cost-model fit skipped ({exc!r})")
        else:
            cm_key, cm_digest = write_cost_model(store, cm_doc, _date(args))
            cost_model_out = {"key": cm_key, "digest": cm_digest,
                              "holdout": cm_doc["holdout"]}
            log.info(f"cost model -> {cm_key} (holdout mean rel err "
                     f"{cm_doc['holdout']['mean_rel_err']:.3f})")
    if not table.sources:
        log.error("nothing to tune from: no traces ingested and no probe — "
                  "pass --traffic-log/--results-log/--obs-snapshot/"
                  "--day-report or point --store at a store with a "
                  "serviceable checkpoint")
        return 1
    recorder = SpanRecorder(label="tune")
    doc = fit_tuned_config(table, recorder=recorder)
    if args.trace_out:
        write_chrome_trace(args.trace_out, recorder.spans())
        log.info(f"decision trace -> {args.trace_out}")
    out: dict = {
        "knobs": doc["knobs"],
        "defaults": {k: (list(v) if isinstance(v, tuple) else v)
                     for k, v in KNOB_DEFAULTS.items()},
        "decisions": doc["decisions"],
        "observations": doc["observations"],
        "cost_model": cost_model_out,
    }
    if args.dry_run:
        out["key"] = None
        out["dry_run"] = True
    elif not doc["knobs"]:
        # every knob kept its default: nothing for serving to consume
        log.warning("no knob left its default (insufficient evidence) — "
                    "nothing persisted; see the decision trace for what was "
                    "missing")
        out["key"] = None
        out["nothing_fitted"] = True
    else:
        try:
            key, digest = write_tuned_config(store, doc, day=_date(args))
        except (OSError, ValueError) as exc:
            log.error(f"failed to persist tuned config: {exc}")
            return 1
        out["key"] = key
        out["digest"] = digest
    print(json.dumps(out, indent=2))
    return 0


def cmd_fsck(args) -> int:
    """Full-store integrity scrub: every prefix of the schema verified
    against its write-time digest evidence and the reference graph; with
    ``--repair`` the safe repair subset runs. Exit 0 when no actionable
    finding remains, 7 otherwise, 1 on an error. Imports no torch."""
    from bodywork_tpu_torch.audit import run_fsck

    report = run_fsck(_store(args), repair=args.repair)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        by_sev = report["by_severity"]
        print(f"scanned {report['keys_scanned']} artefact(s) across "
              f"{len(report['prefixes'])} prefix(es): "
              + (", ".join(f"{s}={n}" for s, n in sorted(by_sev.items())) or "clean"))
        for finding in report["findings"]:
            print(f"  [{finding['severity']}] {finding['problem']} "
                  f"{finding['key']}: {finding['detail']}")
        for entry in report["repairs"]:
            print(f"  repair {entry['action']} {entry['key']}: "
                  f"{entry['outcome']} — {entry['detail']}")
        if report["residual"]:
            print(f"{len(report['residual'])} actionable finding(s) remain")
    return 0 if report["ok"] else FSCK_FINDINGS_EXIT


def _chaos_drift(args):
    if args.samples_per_day is None:
        return None
    from bodywork_tpu_torch.data.drift_config import DriftConfig

    return DriftConfig(n_samples=args.samples_per_day)


def cmd_fleet_sim(args) -> int:
    """The multi-tenant fleet soak (``tenancy/fleet.py``): N scenario-zoo
    tenants' daily pipelines interleaved in one shared store under
    ``tenants/<id>/``, optionally one tenant's final training day
    NaN-sabotaged, then every healthy tenant re-run alone in a fresh store
    and required byte-identical to its fleet namespace; the sabotaged
    tenant's gate must reject with production held. Exit 0 on a verified
    pass, 1 otherwise; ``--json`` prints exactly one JSON document."""
    from bodywork_tpu_torch.tenancy import zoo
    from bodywork_tpu_torch.tenancy.fleet import run_fleet_sim
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    if args.store.startswith("gs://"):
        log.error("fleet-sim needs fresh local stores for the byte-level "
                  "twin comparison; point --store at a directory, not gs://")
        return 1
    specs = zoo(args.tenants, base_seed=args.seed, n_samples=args.samples_per_day)
    summary = run_fleet_sim(
        args.store, _date(args), args.days, specs, sabotage_tenant=args.sabotage,
        model_type=args.model, device=args.device, model_kwargs=_mlp_kwargs(args) or None,
    )
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        for tid, cmp_ in summary["comparisons"].items():
            state = "byte-identical" if cmp_["ok"] else (
                f"DIVERGED (mismatched={len(cmp_['mismatched'])} "
                f"missing={len(cmp_['missing'])} extra={len(cmp_['extra'])})"
            )
            print(f"  {tid}: solo twin {state}")
        if summary["sabotage_tenant"]:
            print(f"  {summary['sabotage_tenant']}: gate_rejected="
                  f"{summary['gate_rejected']} production_held={summary['production_held']}")
        print("fleet soak " + ("PASS" if summary["ok"] else "FAIL"))
    return 0 if summary["ok"] else 1


def cmd_chaos_run_sim(args) -> int:
    """Seeded chaos soak: the N-day simulation fault-free and under the
    fault plan, the faulted run's final artefacts required byte-identical
    to the clean run's. ``--bit-rot`` and ``--crash-schedule`` run the
    at-rest corruption and the process-death soaks instead. Exit 0 on a
    verified pass, 1 otherwise.

    Seed precedence, as the JAX command's: ``--seed`` > a ``--plan``
    file's own seed > ``BODYWORK_TPU_CHAOS_SEED`` > 0."""
    from bodywork_tpu_torch.chaos import FaultPlan, run_chaos_sim
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    if args.store.startswith("gs://"):
        log.error("chaos run-sim needs two fresh local stores for the byte-level "
                  "comparison; point --store at a directory, not gs://")
        return 1
    env_seed = _env_number("BODYWORK_TPU_CHAOS_SEED", int, 0)
    if args.plan:
        plan = FaultPlan.from_file(args.plan)
        if args.seed is not None:
            plan.seed = args.seed
    else:
        seed = args.seed if args.seed is not None else env_seed
        plan = FaultPlan.default(seed if seed is not None else 0)
    if args.crash_schedule or plan.crash_schedule:
        if args.bit_rot or plan.bit_rot_p > 0:
            log.warning("crash soak selected; the plan's bit-rot knobs are ignored "
                        "here — run a separate chaos run-sim --bit-rot")
        return _chaos_crash_sim(args, plan, log)
    if args.bit_rot or plan.bit_rot_p > 0:
        return _chaos_bit_rot_sim(args, plan, log)
    summary = run_chaos_sim(
        args.store, _date(args), args.days, plan, model_type=args.model,
        scoring_mode=args.mode, drift=_chaos_drift(args), train_mode=args.train_mode,
        device=args.device,
    )
    faults = summary["faults_injected"]
    print("faults injected: " + (" ".join(
        f"{k.removeprefix('kind=')}={int(v)}" for k, v in sorted(faults.items())) or "none"))
    for name, deltas in summary["retries"].items():
        print(f"{name.removeprefix('bodywork_tpu_')}: {int(sum(deltas.values()))}")
    print(f"breaker state: {summary['breaker_state']}")
    comparison = summary["comparison"]
    if summary["ok"]:
        print(f"PASS: {comparison['matched']} final artefact(s) byte-identical to the "
              f"fault-free run (seed={plan.seed}, {args.days} day(s), 0 torn)")
        return 0
    log.error(f"chaos soak FAILED: mismatched={comparison['mismatched']} "
              f"missing={comparison['missing']} extra={comparison['extra']} "
              f"torn={comparison['torn']} snapshot_ok={comparison['snapshot_ok']}")
    return 1


def _chaos_bit_rot_sim(args, plan, log) -> int:
    """The at-rest bit-rot soak (``--bit-rot``): the flag arms a plan whose
    ``bit_rot_p`` is 0 at the stock 0.25; a plan file's own bit-rot fields
    are never overridden."""
    from bodywork_tpu_torch.chaos import run_bit_rot_sim

    if plan.bit_rot_p == 0:
        plan.bit_rot_p = 0.25
    if any(getattr(plan, f) for f in ("store_transient_p", "store_latency_p", "torn_write_p",
                                      "corrupt_read_p", "http_error_p", "http_latency_p")):
        log.warning("bit-rot soak twins run WITHOUT in-flight fault injection; the plan's "
                    "in-flight probabilities are ignored here — run a separate chaos "
                    "run-sim for them")
    summary = run_bit_rot_sim(
        args.store, _date(args), args.days, plan, model_type=args.model,
        scoring_mode=args.mode, drift=_chaos_drift(args), train_mode=args.train_mode,
        device=args.device,
    )
    print(f"bit rot injected: {summary['injected']} key(s) across "
          + ", ".join(f"{p}={n}" for p, n in sorted(summary["injected_by_prefix"].items())))
    print(f"detected: {summary['detected']}/{summary['injected']} (severities: "
          + (", ".join(f"{s}={n}" for s, n in sorted(summary["findings_by_severity"].items()))
             or "none") + ")")
    repaired = sum(1 for r in summary["repairs"] if r["outcome"] == "repaired")
    print(f"repairs: {repaired}/{len(summary['repairs'])} applied")
    if summary["ok"]:
        print(f"PASS: {summary['injected']} injected corruption(s) all detected, "
              f"classified, and repaired; store byte-identical to the healthy twin "
              f"outside quarantine/ (seed={summary['seed']}, {args.days} day(s))")
        return 0
    log.error(f"bit-rot soak FAILED: undetected={summary['undetected']} "
              f"residual={[f['key'] for f in summary['post_repair_residual']]} "
              f"comparison_ok={summary['comparison']['ok']}")
    return 1


def _chaos_crash_sim(args, plan, log) -> int:
    """The crash-resume soak (``--crash-schedule``): ``sweep`` kills a
    subprocess runner at every stage boundary plus seeded mid-stage
    store-op points; otherwise the value is a JSON kill-point list
    (inline or a file path), or the ``--plan`` file's ``crash_schedule``.
    Children run fault-free."""
    from bodywork_tpu_torch.chaos import run_crash_sim
    from bodywork_tpu_torch.chaos.kill import parse_schedule

    points = None  # None: run_crash_sim builds the full sweep
    raw = args.crash_schedule
    if raw and raw.strip().lower() != "sweep":
        if os.path.exists(raw):
            with open(raw) as f:
                raw = f.read()
        try:
            points = parse_schedule(raw)
        except ValueError as exc:
            log.error(f"bad --crash-schedule: {exc}")
            return 1
    elif not raw and plan.crash_schedule:
        points = list(plan.crash_schedule)
    if args.plan and (plan.corrupt_read_p or any(
            getattr(plan, f) for f in ("store_transient_p", "store_latency_p",
                                       "torn_write_p", "http_error_p", "http_latency_p"))):
        log.warning("crash soak children run WITHOUT in-call fault injection; the plan's "
                    "fault probabilities are ignored here")
    summary = run_crash_sim(
        args.store, _date(args), args.days, seed=plan.seed, points=points,
        model_type=args.model, scoring_mode=args.mode,
        samples_per_day=args.samples_per_day, device=args.device,
    )
    failed = [r for r in summary["results"] if not r["ok"]]
    for r in failed:
        log.error(f"crash point {r['point']}: {r.get('error') or 'diverged'}")
    if summary["ok"]:
        print(f"PASS: {summary['points']} kill point(s) all converged byte-identical to "
              f"the uninterrupted twin (seed={summary['seed']}, {args.days} day(s))")
        return 0
    log.error(f"crash soak FAILED: {len(failed)}/{summary['points']} point(s) did not "
              "converge")
    return 1


#: ``trace`` exit when the requested trace (or any dump) is absent: apart
#: from 1 (an error), so a script tells "not recorded" from "broken"
TRACE_ABSENT_EXIT = 9


def cmd_trace(args) -> int:
    """Inspect stored flight-recorder dumps (``obs/flightrec/``): ``tail``
    lists recent dumps and their traces, ``show`` prints one trace as
    JSON by (a prefix of) its id, and ``export --chrome`` renders traces
    through the Chrome trace-event emitter. The JAX command's output and
    exit codes: :data:`TRACE_ABSENT_EXIT` when nothing matches, 1 when
    the store or the output cannot be used."""
    from bodywork_tpu_torch.utils.logging import get_logger

    try:
        return _trace(args)
    except OSError as exc:
        get_logger("cli").error(exc)
        return 1


def _trace(args) -> int:
    from bodywork_tpu_torch.obs.tracing import find_trace, flight_trace_spans, iter_flight_records
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = _store(args)
    command = args.trace_command
    if command == "show":
        dump_key, trace_doc = find_trace(store, args.trace_id)
        if trace_doc is None:
            log.error(f"trace {args.trace_id!r} not found in any dump")
            return TRACE_ABSENT_EXIT
        print(json.dumps({"dump": dump_key, "trace": trace_doc}, indent=2, sort_keys=True))
        return 0
    records = list(iter_flight_records(store))
    if not records:
        log.error("no flight-recorder dumps stored (obs/flightrec/ empty "
                  "— dumps are written at SLO-watchdog verdicts with "
                  "tracing enabled)")
        return TRACE_ABSENT_EXIT
    if command == "tail":
        for key, doc in records[-args.n:]:
            print(f"{key}  verdict={doc['verdict']} reason={doc['reason']!r} "
                  f"canary={doc.get('canary_key')} traces={doc['n_traces']}")
            for t in doc["traces"][-args.traces:]:
                meta = t.get("meta") or {}
                print(f"  {t['trace_id']}  {t.get('route')} status={t.get('status')} "
                      f"duration={t.get('duration_s')}s stream={meta.get('stream', '-')} "
                      f"spans={len(t['spans'])}")
        return 0
    # export: one trace by id, or every trace of the newest dump
    from bodywork_tpu_torch.obs.spans import write_chrome_trace

    if args.trace_id:
        dump_key, trace_doc = find_trace(store, args.trace_id)
        if trace_doc is None:
            log.error(f"trace {args.trace_id!r} not found in any dump")
            return TRACE_ABSENT_EXIT
        spans, source = flight_trace_spans(trace_doc), dump_key
    else:
        source, doc = records[-1]
        spans = [span for t in doc["traces"] for span in flight_trace_spans(t)]
    print(write_chrome_trace(args.chrome, spans, process_name=source))
    return 0


def _positive_int(raw: str) -> int:
    value = int(raw)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {raw}")
    return value


def _fraction(raw: str) -> float:
    """``--fraction``: a probability in (0, 1]."""
    try:
        value = float(raw)
    except ValueError:
        raise argparse.ArgumentTypeError(f"must be a number, got {raw!r}")
    if not 0.0 < value <= 1.0:
        raise argparse.ArgumentTypeError(f"must be in (0, 1], got {raw}")
    return value


def _widths(raw: str) -> tuple[int, ...]:
    try:
        widths = tuple(int(w) for w in raw.split(",") if w.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(f"widths must be comma-separated integers, got {raw!r}")
    if not widths or any(w < 1 for w in widths):
        raise argparse.ArgumentTypeError(f"widths must be positive integers, got {raw!r}")
    return widths


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="bodywork_tpu_torch",
        description="PyTorch/CUDA port of the bodywork_tpu pipeline",
    )
    parser.add_argument("--log-level", default="INFO")
    sub = parser.add_subparsers(dest="command", required=True)
    store = {"required": True, "help": "artefact store directory"}
    device = {
        "choices": ["cuda", "cpu"], "default": "cuda",
        "help": "where to run (default cuda; without a card only --device cpu runs)",
    }

    p = sub.add_parser("generate", help="generate days of drift data")
    p.set_defaults(fn=cmd_generate)
    p.add_argument("--store", **store)
    p.add_argument("--date", default=None, help="first day, YYYY-MM-DD (default today)")
    p.add_argument("--days", type=int, default=1)
    p.add_argument("--device", **device)

    p = sub.add_parser("serve", help="serve the latest model over HTTP")
    p.set_defaults(fn=cmd_serve)
    p.add_argument("--store", **store)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument(
        "--mesh-data", type=int, default=_env_number("BODYWORK_TPU_MESH_DATA", int, 1),
        help="shard each padded request batch over this many devices (the mesh's data "
             "axis; env BODYWORK_TPU_MESH_DATA overrides, the knob the k8s serve "
             "Deployment materialises; BODYWORK_TPU_VIRTUAL_DEVICES=N repeats each card "
             "N times). Default: single-device serving",
    )
    p.add_argument(
        "--mesh-model", type=int, default=_env_number("BODYWORK_TPU_MESH_MODEL", int, 1) or 1,
        help="tensor-parallel mesh axis for sharded serving (MLP checkpoints only: "
             "weights Megatron-split across this many devices; env "
             "BODYWORK_TPU_MESH_MODEL overrides). Combines with --mesh-data into a "
             "data x model mesh served through the plain torch engine",
    )
    p.add_argument(
        "--engine", default="auto", choices=SERVE_ENGINES,
        help="plain torch (f32, bf16, or int8 weights), the fused CUDA kernel "
             "(f32, bf16 or int8 weights), or auto (the f32 kernel for an MLP whose "
             "hidden layers are all >= 256 wide and that it can launch, on the card)",
    )
    p.add_argument(
        "--dtype", default=_env_choice("BODYWORK_TPU_SERVE_DTYPE", SERVE_DTYPES, "float32"),
        choices=list(SERVE_DTYPES),
        help="serving precision (env BODYWORK_TPU_SERVE_DTYPE overrides the default "
             "float32): bfloat16 or int8 serve the resolved engine's quantized variant "
             "(MLP only) once the shadow quality gate admits it against the f32 "
             "predictions of the same checkpoint; otherwise f32 serves",
    )
    p.add_argument("--device", **device)
    p.add_argument(
        "--buckets", default=None, metavar="N[,N...]", type=_bucket_list,
        help="comma-separated request-size buckets to capture and warm (default: "
             "each engine's own bucket set)",
    )
    p.add_argument(
        "--batch-window-ms", type=float, metavar="MS",
        default=_env_number("BODYWORK_TPU_BATCH_WINDOW_MS", float, 0.0),
        help="coalesce concurrent single-row /score/v1 requests into shared padded "
             "device calls, flushing each batch after at most this many milliseconds "
             "(default off; env BODYWORK_TPU_BATCH_WINDOW_MS overrides; 0 forces it off)",
    )
    p.add_argument(
        "--batch-max-rows", type=_positive_int, metavar="N",
        default=_env_number("BODYWORK_TPU_BATCH_MAX_ROWS", int, 1),
        help="flush a coalesced batch as soon as it reaches N rows (default 64, or env "
             "BODYWORK_TPU_BATCH_MAX_ROWS)",
    )
    p.add_argument(
        "--server-engine", choices=["thread", "aio"],
        default=_env_choice("BODYWORK_TPU_SERVER_ENGINE", ("thread", "aio"), "thread"),
        help="HTTP front end: 'thread' (one thread per connection, default; env "
             "BODYWORK_TPU_SERVER_ENGINE overrides) or 'aio' (asyncio event loop, arms "
             "admission control by default); responses are byte-identical",
    )
    p.add_argument(
        "--max-pending", type=_positive_int, metavar="N",
        default=_env_number("BODYWORK_TPU_MAX_PENDING", int, 1),
        help="admission budget: at most N scoring requests admitted and unfinished; "
             "beyond it requests answer 429 + Retry-After before any work (default off "
             "for thread, 512 for aio; env BODYWORK_TPU_MAX_PENDING overrides)",
    )
    p.add_argument(
        "--retry-after-max-s", type=float, metavar="S",
        default=_env_number("BODYWORK_TPU_RETRY_AFTER_MAX_S", float, 1.0),
        help="cap on the EWMA-derived Retry-After of shed 429s and no-model 503s "
             "(default 30; env BODYWORK_TPU_RETRY_AFTER_MAX_S overrides)",
    )
    p.add_argument(
        "--reload-interval", type=float, default=30.0, metavar="S",
        help="poll the store every S seconds and hot-swap the checkpoint serving "
             "should run into the running service, with the SLO watchdog judging a "
             "live canary on each poll (0 disables; the service then serves its "
             "boot-time model until restart)",
    )
    p.add_argument(
        "--workers", type=int, default=1, metavar="N",
        help="serve through N OS-process replicas sharing this port via "
             "SO_REUSEPORT, supervised and respawned on death, each with its own "
             "CUDA context on the card — the local analogue of the reference's "
             "`replicas: 2` Deployment (default 1: single process, in-process serving)",
    )
    p.add_argument(
        "--frontends", type=_positive_int, metavar="N",
        default=_env_number("BODYWORK_TPU_FRONTENDS", int, 1),
        help="disaggregated serving: N model-free, torch-free parse/admission "
             "front-end processes on this port (SO_REUSEPORT) feeding ONE "
             "device-owning dispatcher (the one CUDA context) over a row-queue, so "
             "batches coalesce from the UNION of every front end's rows (--workers "
             "fragments them per replica). Mutually exclusive with --workers > 1. Env "
             "BODYWORK_TPU_FRONTENDS overrides",
    )
    p.add_argument(
        # choices pinned == serve.netqueue.SERVE_TRANSPORTS (and the stages
        # env-knob parser) by tests/test_torch_netqueue.py
        "--transport", default=_env_choice("BODYWORK_TPU_SERVE_TRANSPORT", SERVE_TRANSPORTS,
                                           "shm"),
        choices=list(SERVE_TRANSPORTS),
        help="row-queue transport between the front ends and the dispatcher "
             "(--frontends mode only): 'shm' (default — shared memory, one host; env "
             "BODYWORK_TPU_SERVE_TRANSPORT overrides), 'unix' (domain socket, one "
             "host), or 'tcp' (cross-host: the split k8s Deployments' transport). "
             "Admission/shed semantics and response bytes are identical across all "
             "three",
    )
    p.add_argument(
        "--dispatcher-addr", metavar="ADDR",
        default=os.environ.get("BODYWORK_TPU_DISPATCHER_ADDR", "").strip() or None,
        help="where the dispatcher's row-queue listener lives for the socket "
             "transports: host:port for tcp (the dispatcher k8s Service), a filesystem "
             "path for unix (env BODYWORK_TPU_DISPATCHER_ADDR overrides). Default: "
             "auto-picked on loopback / a temp path when both halves run under this "
             "process (--role auto); REQUIRED for the split roles",
    )
    p.add_argument(
        # choices pinned == serve.netqueue.SERVE_ROLES by tests/test_torch_netqueue.py
        "--role", default=_env_choice("BODYWORK_TPU_SERVE_ROLE", SERVE_ROLES, "auto"),
        choices=list(SERVE_ROLES),
        help="which half of the disaggregated split this process runs (env "
             "BODYWORK_TPU_SERVE_ROLE overrides): 'auto' (default) runs both halves "
             "locally; 'frontend' runs only the parse/admission fleet against a remote "
             "dispatcher at --dispatcher-addr; 'dispatcher' runs only the "
             "device-owning scorer, serving the socket row-queue instead of HTTP",
    )
    p.add_argument(
        "--standby", action="store_true",
        default=_env_flag("BODYWORK_TPU_SERVE_STANDBY"),
        help="dispatcher high availability (socket transports only): run a WARM "
             "standby dispatcher, its graphs captured, next to the active one, "
             "arbitrated by a CAS lease on the artefact store — the standby takes "
             "over within the lease TTL of a leader death, and front ends resubmit "
             "in-flight rows across the takeover instead of shedding (env "
             "BODYWORK_TPU_SERVE_STANDBY overrides; with --role dispatcher this "
             "supervises the active/standby PAIR)",
    )
    p.add_argument(
        "--leader-ttl", type=float, metavar="S", default=None,
        help="the dispatcher leadership lease's time-to-live in seconds with "
             "--standby: a dead leader blocks takeover for at most this long "
             "(default: env BODYWORK_TPU_LEADER_TTL_S, else 5)",
    )
    p.add_argument(
        "--metrics", action="store_true",
        help="with --workers N: aggregate every replica's metrics into one GET "
             "/metrics view (Prometheus text format) on the serving port. "
             "Single-process serving exposes /metrics unconditionally",
    )
    p.add_argument(
        "--tuned-config", metavar="REF",
        default=os.environ.get("BODYWORK_TPU_TUNED_CONFIG", "").strip() or None,
        help="serve with a fitted knob set from `cli tune`: a tuning/ store key or "
             "'latest' (env BODYWORK_TPU_TUNED_CONFIG overrides). Tuned values fill "
             "every knob not set explicitly (window/max-rows/buckets/max-pending); a "
             "missing or malformed document degrades to the built-in defaults with a "
             "warning, never a failed boot",
    )
    p.add_argument(
        "--online-tune", action="store_true",
        default=_env_flag("BODYWORK_TPU_TUNE_ONLINE"),
        help="arm the online re-tune controller on the reload-watcher loop: "
             "incremental drift detection over the --tune-*-log files, mid-flight knob "
             "refits under a config guard that reverts a regressing config in one CAS. "
             "Requires --reload-interval > 0 (env BODYWORK_TPU_TUNE_ONLINE=1 overrides)",
    )
    p.add_argument(
        "--tune-request-log", action="append", metavar="FILE",
        default=_env_paths("BODYWORK_TPU_TUNE_REQUEST_LOGS"),
        help="a growing `traffic run` request log the online controller watches "
             "incrementally; repeatable (env BODYWORK_TPU_TUNE_REQUEST_LOGS "
             "colon-separated)",
    )
    p.add_argument(
        "--tune-results-log", action="append", metavar="FILE",
        default=_env_paths("BODYWORK_TPU_TUNE_RESULTS_LOGS"),
        help="a growing `traffic run --results-out` outcome log the online "
             "controller watches incrementally; repeatable (env "
             "BODYWORK_TPU_TUNE_RESULTS_LOGS colon-separated)",
    )
    p.add_argument(
        "--cost-budget-s", type=float, metavar="S",
        default=_env_number("BODYWORK_TPU_COST_BUDGET_S", float, 0.0),
        help="arm admission's cost-priced shed: bound the estimated dispatch-seconds "
             "of admitted-and-unfinished work, priced per request by the latest "
             "learned cost model under tuning/ (env BODYWORK_TPU_COST_BUDGET_S "
             "overrides; requires admission to be armed)",
    )

    p = sub.add_parser("tune", help="fit the serving knobs from observed traces; "
                                    "`tune status` reports the active config and the "
                                    "apply/revert history")
    p.set_defaults(fn=cmd_tune)
    p.add_argument(
        "action", nargs="?", default="fit", choices=["fit", "status"],
        help="fit (default): ingest traces and write a tuned config; status: print "
             "the active tuned config (digest, source window, per-knob source incl. "
             "env overrides) and the online controller's applied/reverted history "
             "from the config log — exit 1 on a corrupt document",
    )
    p.add_argument("--store", **store)
    p.add_argument("--date", default=None,
                   help="date key for the tuned document (default: today)")
    p.add_argument("--traffic-log", action="append", default=[], metavar="FILE",
                   help="a `traffic run --log-out` request log to ingest; repeatable")
    p.add_argument("--results-log", action="append", default=[], metavar="FILE",
                   help="a `traffic run --results-out` outcome log to ingest; repeatable")
    p.add_argument("--obs-snapshot", action="append", default=[], metavar="FILE",
                   help="an obs registry snapshot JSON to ingest; repeatable")
    p.add_argument("--day-report", action="append", default=[], metavar="FILE",
                   help="a `run-day --report-out` document to ingest; repeatable")
    p.add_argument("--no-probe", dest="probe", action="store_false",
                   help="skip the dispatch-cost probe (by default the serving "
                        "checkpoint's padded dispatch is timed at each candidate bucket)")
    p.add_argument("--probe-buckets", default=(1, 8, 64, 256, 512, 1024, 4096),
                   type=_bucket_list, metavar="N[,N...]",
                   help="candidate buckets the dispatch-cost probe measures")
    p.add_argument("--probe-reps", type=_positive_int, default=5,
                   help="timed probe repetitions per bucket (median wins)")
    p.add_argument("--device", **device)
    p.add_argument("--dry-run", action="store_true", help="fit and print, write nothing")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="write the per-knob decision trace as a Chrome trace-event file")

    p = sub.add_parser("test", help="black-box test the live scoring service")
    p.set_defaults(fn=cmd_test)
    p.add_argument("--store", **store)
    p.add_argument("--scoring-url", required=True)
    p.add_argument("--mode", default="single", choices=["single", "batch"])
    p.add_argument("--max-rows", type=int, default=None)

    def add_model_args(p) -> None:
        p.add_argument("--store", **store)
        p.add_argument("--model", default="linear", choices=["linear", "mlp"])
        p.add_argument("--mlp-hidden", type=_widths, default=None, metavar="W,W,...",
                       help="the MLP's hidden widths (default: the config's 64,64)")
        p.add_argument("--mlp-steps", type=_positive_int, default=None,
                       help="Adam steps per fit (default 2000)")
        p.add_argument("--mlp-lr", type=float, default=None,
                       help="Adam learning rate (default 1e-2)")
        p.add_argument("--device", **device)

    p = sub.add_parser("train", help="train on all history and persist the model")
    p.set_defaults(fn=cmd_train)
    add_model_args(p)
    p.add_argument("--mode", default=_env_choice("BODYWORK_TPU_TRAIN_MODE", TRAIN_MODES, "full"),
                   choices=list(TRAIN_MODES),
                   help="'full' refits on all history (the default; env "
                        "BODYWORK_TPU_TRAIN_MODE overrides it); 'incremental' folds in "
                        "only the new days: persisted sufficient statistics for the "
                        "linear model, a warm-started fine-tune for the mlp, both "
                        "falling back to a full refit (reason printed) when the store "
                        "lacks what they need")
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-parallel mesh axis for sharded training (mlp only)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel mesh axis for sharded training (mlp only)")

    for name, fn, help_ in (
        ("run-day", cmd_run_day, "run one simulated day in-process"),
        ("run-sim", cmd_run_sim, "run an N-day drift simulation in-process"),
    ):
        p = sub.add_parser(name, help=help_)
        p.set_defaults(fn=fn)
        add_model_args(p)
        p.add_argument("--date", default=None, help="(first) day, YYYY-MM-DD (default today)")
        p.add_argument("--mode", default="batch", choices=["single", "batch"],
                       help="the test stage's requests: one row or one batch each")
        p.add_argument("--spec", default=None,
                       help="pipeline spec YAML (overrides --model/--mode/--mlp-*)")
        p.add_argument("--trace-out", default=None, metavar="PATH",
                       help="write the runner's spans as a Chrome trace-event file "
                            "(Perfetto, chrome://tracing); run-day also writes the "
                            "day report next to it, and replaces {date} with the day")
        if name == "run-sim":
            p.add_argument("--profile-dir", default=None, metavar="DIR",
                           help="write a torch.profiler trace of the whole loop here "
                                "(CUDA activity included on the card)")
            p.add_argument("--days", type=_positive_int, required=True)
            p.add_argument("--samples-per-day", type=_positive_int, default=None, metavar="N",
                           help="rows the generator draws a day (default 1440)")
            p.add_argument("--overlap-generate", action="store_true",
                           help="run generate beside serve (DAG s1 >> s2,s3 >> s4) instead "
                                "of the reference's serial DAG; the artefacts are the same")
        else:
            p.add_argument("--report-out", default=None, metavar="PATH",
                           help="write the day report (JSON: stage seconds + spans) "
                                "here; default <trace-out stem>.report.json when "
                                "--trace-out is given")
            p.add_argument("--scrub", action="store_true",
                           help="run a detect-only integrity scrub (fsck) after the day "
                                "converges; the findings are printed, counted on the "
                                "bodywork_tpu_audit_* counters and ride the day report")
            p.add_argument("--no-resume", action="store_true",
                           help="ignore the runs/ journal: no lease, no verified skipping, "
                                "a full re-run. Default: resume, skipping completed stages "
                                "whose recorded artefact digests verify (exit 5: another "
                                "runner holds the lease; 6: the day was already complete)")

    p = sub.add_parser("run-stage", help="run one pipeline stage (pod entrypoint)")
    p.set_defaults(fn=cmd_run_stage)
    p.add_argument("--spec", default=None,
                   help="pipeline spec YAML (overrides --model/--mode/--mlp-*)")
    add_model_args(p)
    p.add_argument("--stage", required=True)
    p.add_argument("--date", default=None)
    p.add_argument("--mode", default="batch", choices=["single", "batch"])
    p.add_argument("--scoring-url", default=None)

    p = sub.add_parser("wait-for", help="block until pipeline preconditions hold")
    p.set_defaults(fn=cmd_wait_for)
    p.add_argument("--store", **store)
    p.add_argument("--dataset", action="store_true", help="wait until any dataset exists")
    p.add_argument("--model", action="store_true",
                   help="wait until any model checkpoint exists")
    p.add_argument("--dataset-newer-than-model", action="store_true",
                   help="wait until the latest dataset postdates the latest model")
    p.add_argument("--service-url", default=None,
                   help="wait until this health URL returns 200")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--poll-interval", type=float, default=2.0)

    p = sub.add_parser("report", help="longitudinal train-vs-live drift report")
    p.set_defaults(fn=cmd_report)
    p.add_argument("--store", **store)
    p.add_argument("--plot", default=None, metavar="OUT.png",
                   help="also render the drift dashboard PNG here (requires matplotlib)")
    p.add_argument("--fail-on-drift", action="store_true",
                   help="exit 4 when the drift rule flags any day (1=error, 2=usage)")
    p.add_argument("--mape-ratio", type=float, default=None,
                   help="OPT-IN: flag a day when MAPE_live exceeds this multiple of "
                        "MAPE_train (disabled by default: day-level MAPE is unbounded "
                        "when labels touch zero; the calibrated detector is the bias rule)")
    p.add_argument("--corr-floor", type=float, default=0.5,
                   help="flag a day when the live score/label correlation falls below "
                        "this (default 0.5)")
    p.add_argument("--bias-z", type=float, default=4.0,
                   help="flag a day when the trailing-window live residual-mean statistic "
                        "exceeds this many standard errors (default 4.0)")
    p.add_argument("--bias-window", type=_positive_int, default=7, metavar="N",
                   help="trailing days accumulated by the bias rule (default 7)")
    p.add_argument("--bias-baseline", type=_positive_int, default=14, metavar="N",
                   help="first N days of the report used as the bias rule's yardstick "
                        "(default 14)")
    p.add_argument("--window", type=_positive_int, default=None, metavar="N",
                   help="evaluate the drift rule over the last N days only (default: all "
                        "history)")

    p = sub.add_parser("deploy", help="write GKE manifests for a GPU node pool")
    p.set_defaults(fn=cmd_deploy)
    p.add_argument("--spec", default=None, help="pipeline spec YAML (overrides --model/--mode)")
    p.add_argument("--out", required=True)
    p.add_argument("--store-path", default="/mnt/artefact-store")
    p.add_argument("--image", default="bodywork-tpu/runtime:latest")
    p.add_argument("--store-volume", default="auto", choices=["auto", "pvc", "hostpath", "gcs"],
                   help="shared-store medium: ReadWriteMany PVC (multi-node safe), hostPath "
                        "(single-node clusters ONLY), or direct GCS; auto picks gcs for "
                        "gs:// store paths and pvc otherwise")
    p.add_argument("--storage-class", default="standard-rwx",
                   help="storageClassName for the store PVC (default: GKE Filestore's RWX "
                        "class; pass '' for the cluster default, which must support "
                        "ReadWriteMany)")
    p.add_argument("--pvc-size", default="10Gi")
    p.add_argument("--emit-images", default=None, metavar="DIR",
                   help="also write per-stage image build contexts (Dockerfile + pinned "
                        "requirements.txt + build.sh) to DIR")
    p.add_argument("--force", action="store_true",
                   help="write manifests referencing derived per-stage image tags even "
                        "without --emit-images (pods ImagePullBackOff until built)")
    p.add_argument("--model", default="linear", choices=["linear", "mlp"])
    p.add_argument("--mode", default="batch", choices=["single", "batch"])

    p = sub.add_parser("compact", help="consolidate dataset history into a snapshots/ "
                                       "artefact")
    p.set_defaults(fn=cmd_compact)
    p.add_argument("--store", **store)
    p.add_argument("--dry-run", action="store_true",
                   help="print the days covered, rows and estimated bytes without "
                        "writing anything")
    p.add_argument("--keep", type=_positive_int, default=None, metavar="N",
                   help="snapshots to keep after writing (default: "
                        "data.snapshot.SNAPSHOT_KEEP, 2)")

    p = sub.add_parser("registry", help="model registry: gated promotion, shadow eval, "
                                        "rollback")
    registry_sub = p.add_subparsers(dest="registry_command", required=True)
    p = registry_sub.add_parser("list", help="list registry records + aliases")
    p.set_defaults(fn=cmd_registry_list)
    p.add_argument("--store", **store)
    p = registry_sub.add_parser(
        "show", help="show one record (by model key or date) or resolve an alias "
                     "(production/previous) or dump the alias doc (aliases)")
    p.set_defaults(fn=cmd_registry_show)
    p.add_argument("--store", **store)
    p.add_argument("what", help="model key, date, 'production', 'previous', or 'aliases'")
    p = registry_sub.add_parser(
        "promote", help="point the production alias at a registered model (one CAS; "
                        "old production becomes 'previous')")
    p.set_defaults(fn=cmd_registry_promote)
    p.add_argument("--store", **store)
    p.add_argument("--model", required=True, help="model key or date to promote")
    p.add_argument("--date", default=None,
                   help="day to stamp the promotion events with (YYYY-MM-DD; default today)")
    p = registry_sub.add_parser(
        "rollback", help="ONE operation back to the previous production (a single alias "
                         "CAS flip). The restore target is pre-verified first: a missing "
                         "or digest-mismatched 'previous' refuses with exit 8")
    p.set_defaults(fn=cmd_registry_rollback)
    p.add_argument("--store", **store)
    p.add_argument("--date", default=None,
                   help="day to stamp the rollback events with (YYYY-MM-DD; default today)")
    p = registry_sub.add_parser(
        "gate", help="adjudicate the newest candidate (promote or reject): the step "
                     "run-day runs between train and serve")
    p.set_defaults(fn=cmd_registry_gate)
    p.add_argument("--store", **store)
    p.add_argument("--model", default=None,
                   help="candidate to gate (default: newest record in candidate status)")
    p.add_argument("--date", default=None, help="day to stamp decision events with (YYYY-MM-DD)")
    p.add_argument("--dry-run", action="store_true",
                   help="evaluate and print the decision WITHOUT writing anything")
    p.add_argument("--shadow-days", type=_positive_int, default=None, metavar="K",
                   help="also shadow-evaluate the candidate against production over the "
                        "last K dataset days (in-process, no live traffic; default off)")
    p.add_argument("--device", **{**device, "help": "where the shadow evaluation scores "
                                                     "(default cuda)"})

    p = registry_sub.add_parser(
        "canary", help="live canary lifecycle: route a seeded traffic fraction to a "
                       "candidate, watched by the SLO watchdog of a service with "
                       "--reload-interval")
    canary_sub = p.add_subparsers(dest="canary_command", required=True)
    p = canary_sub.add_parser("start", help="point the canary slot at a candidate (one "
                                            "CAS); serving routes --fraction of /score "
                                            "traffic to it on its next poll")
    p.set_defaults(fn=cmd_registry_canary)
    p.add_argument("--store", **store)
    p.add_argument("--model", default=None,
                   help="model key or date to canary (default: newest record in "
                        "candidate status)")
    p.add_argument("--fraction", type=_fraction, default=0.1, metavar="F",
                   help="fraction of scoring traffic routed to the canary, in (0, 1] "
                        "(default 0.1)")
    p.add_argument("--seed", type=int, default=0,
                   help="routing-hash seed: (seed, request bytes) pick the stream")
    p.add_argument("--date", default=None,
                   help="day to stamp the canary events with (YYYY-MM-DD)")
    p = canary_sub.add_parser("stop", help="abort the live canary (one CAS; record -> "
                                           "rejected)")
    p.set_defaults(fn=cmd_registry_canary)
    p.add_argument("--store", **store)
    p.add_argument("--date", default=None, help="day to stamp the abort events with")
    p = canary_sub.add_parser("promote", help="graduate the live canary to production "
                                              "(one CAS)")
    p.set_defaults(fn=cmd_registry_canary)
    p.add_argument("--store", **store)
    p.add_argument("--date", default=None, help="day to stamp the promotion events with")
    p = canary_sub.add_parser("status", help="the canary slot, serveability, and record "
                                             "status")
    p.set_defaults(fn=cmd_registry_canary)
    p.add_argument("--store", **store)

    p = sub.add_parser("traffic", help="open-loop load harness: seeded arrival-rate "
                                       "traffic against a live scoring service")
    traffic_sub = p.add_subparsers(dest="traffic_command", required=True)
    p = traffic_sub.add_parser("run", help="generate (or replay) a seeded request log and "
                                           "drive it open-loop at its scheduled arrival "
                                           "times")
    p.set_defaults(fn=cmd_traffic_run)
    p.add_argument("--url", default=None,
                   help="base URL of the service under load (e.g. http://127.0.0.1:5000); "
                        "omit with --log-out to only generate the log")
    p.add_argument("--rate", type=float, default=100.0, metavar="RPS",
                   help="mean offered load, requests/second (default 100)")
    p.add_argument("--duration", type=float, default=5.0, metavar="S",
                   help="log span in seconds (default 5)")
    p.add_argument("--transport", default="json", choices=["json", "binary"],
                   help="wire encoding of the same log: the JSON body or the f32 row "
                        "framing (application/x-bodywork-rows)")
    p.add_argument("--shards", type=_positive_int, default=1, metavar="N",
                   help="drive through N worker processes (spawned), the log split "
                        "round-robin, one merged report (default 1)")
    p.add_argument("--arrival", default="poisson", choices=["poisson", "mmpp"],
                   help="arrival process: memoryless 'poisson' or bursty 'mmpp' "
                        "(2-state Markov-modulated, the same mean rate)")
    p.add_argument("--batch-fraction", type=float, default=0.0, metavar="P",
                   help="probability an arrival is a /score/v1/batch request (default 0)")
    p.add_argument("--batch-rows", type=_positive_int, default=64, metavar="N",
                   help="rows per batch request (default 64)")
    p.add_argument("--seed", type=int, default=0,
                   help="request-log seed: the same (seed, knobs) gives the same log")
    p.add_argument("--burst-multiplier", type=float, default=4.0, metavar="M",
                   help="mmpp: burst-state rate as a multiple of calm (default 4)")
    p.add_argument("--timeout", type=float, default=30.0, metavar="S",
                   help="per-request response timeout (default 30)")
    p.add_argument("--log-out", default=None, metavar="FILE",
                   help="write the request log (JSONL) here for later replay")
    p.add_argument("--log-in", default=None, metavar="FILE",
                   help="replay this request log instead of generating one")
    p.add_argument("--results-out", default=None, metavar="FILE",
                   help="write one JSONL record per request (status, latency, answering "
                        "model key, trace id)")

    p = sub.add_parser("run-ab", help="concurrent A/B model pipelines on one device pool")
    p.set_defaults(fn=cmd_run_ab)
    p.add_argument("--store", **store)
    p.add_argument("--days", type=int, required=True)
    p.add_argument("--date", default=None, help="start date (YYYY-MM-DD)")
    p.add_argument("--models", default="linear,mlp",
                   help="comma-separated model types, one pipeline each")
    p.add_argument("--device", **device)

    p = sub.add_parser("chaos", help="chaos harness")
    chaos_sub = p.add_subparsers(dest="chaos_command", required=True)
    p = chaos_sub.add_parser(
        "canary", help="canary release-safety acceptance: a sabotaged canary (NaN weights "
                       "/ injected latency) must auto-abort via one CAS with production "
                       "byte-identical to a canary-free twin; a healthy one must "
                       "auto-promote")
    p.set_defaults(fn=cmd_chaos_canary)
    p.add_argument("--store", required=True, help="fresh local directory")
    p.add_argument("--scenario", default="nan", choices=["nan", "latency", "healthy"],
                   help="'nan' (NaN-weight canary checkpoint), 'latency' (chaos latency "
                        "on the canary stream) or 'healthy' (must auto-promote)")
    p.add_argument("--seed", type=int, default=0,
                   help="drives the request stream, the routing hash and the fault plan")
    p.add_argument("--requests", type=_positive_int, default=240, metavar="N",
                   help="seeded single-row scoring requests to drive (default 240)")
    p.add_argument("--fraction", type=_fraction, default=0.35, metavar="F",
                   help="canary traffic fraction in (0, 1] (default 0.35)")
    p.add_argument("--samples-per-day", type=_positive_int, default=None, metavar="N",
                   help="rows a day for the two seeded training days (default 96)")
    p.add_argument("--device", **device)

    p = chaos_sub.add_parser(
        "run-sim", help="seeded chaos soak: faulted N-day sim vs fault-free twin, final "
                        "artefacts must be byte-identical")
    p.set_defaults(fn=cmd_chaos_run_sim)
    p.add_argument("--store", required=True,
                   help="fresh local directory for the two runs' stores (gs:// refused: "
                        "the byte-level comparison needs local twins)")
    p.add_argument("--days", type=_positive_int, required=True)
    p.add_argument("--date", default=None, help="start date (YYYY-MM-DD)")
    p.add_argument("--seed", type=int, default=None,
                   help="fault-plan seed; precedence: this flag > a --plan file's own "
                        "seed > env BODYWORK_TPU_CHAOS_SEED > 0")
    p.add_argument("--plan", default=os.environ.get("BODYWORK_TPU_CHAOS_PLAN"),
                   metavar="FILE",
                   help="JSON fault plan (FaultPlan fields; unknown keys rejected); "
                        "default: the stock all-kinds plan (env BODYWORK_TPU_CHAOS_PLAN)")
    p.add_argument("--samples-per-day", type=_positive_int, default=None, metavar="N",
                   help="rows the generator draws a day (default 1440)")
    p.add_argument("--bit-rot", action="store_true",
                   help="the at-rest bit-rot soak instead: flip seeded bytes across every "
                        "populated prefix of a finished sim's store, then fsck must detect "
                        "and classify all of it and --repair converge byte-identical to a "
                        "healthy twin outside quarantine/")
    p.add_argument("--crash-schedule", default=None, metavar="SPEC",
                   help="the crash-resume soak instead: 'sweep' (every stage boundary + "
                        "seeded mid-stage store-op points) or a JSON kill-point list "
                        "(inline or a file path)")
    p.add_argument("--model", default="linear", choices=["linear", "mlp"])
    p.add_argument("--mode", default="batch", choices=["single", "batch"])
    p.add_argument("--train-mode", default="full", choices=list(TRAIN_MODES),
                   help="run BOTH twins through this training mode")
    p.add_argument("--device", **device)

    p = sub.add_parser(
        "fleet-sim",
        help="multi-tenant fleet soak: N scenario-zoo tenants interleaved in ONE store "
             "under tenants/<id>/, optional single-tenant NaN sabotage, every healthy "
             "tenant proven byte-identical to a solo twin (zero cross-tenant blast radius)")
    p.set_defaults(fn=cmd_fleet_sim)
    p.add_argument("--store", required=True,
                   help="fresh local root dir (fleet/ + solo twins are created under it)")
    p.add_argument("--date", default=None, help="simulation start date")
    p.add_argument("--days", type=_positive_int, default=3, metavar="N")
    p.add_argument("--tenants", type=_positive_int, default=4, metavar="N",
                   help="fleet size; specs cycle the scenario zoo "
                        "(tenant-00 is always baseline/steady)")
    p.add_argument("--sabotage", default=None, metavar="TENANT",
                   help="NaN-poison this tenant's final training day; its gate must "
                        "reject, everyone else must stay byte-identical to their solo twins")
    p.add_argument("--seed", type=int, default=42,
                   help="base seed folded into every tenant's data seed")
    p.add_argument("--samples-per-day", type=_positive_int, default=96, metavar="N",
                   help="rows/day per tenant (default 96 — the soak tests isolation, "
                        "not the fit)")
    p.add_argument("--model", default="linear", choices=["linear", "mlp"])
    p.add_argument("--mlp-hidden", type=_widths, default=None, metavar="W,W,...",
                   help="the MLP's hidden widths (default: the config's 64,64)")
    p.add_argument("--mlp-steps", type=_positive_int, default=None,
                   help="Adam steps per fit (default 2000)")
    p.add_argument("--mlp-lr", type=float, default=None,
                   help="Adam learning rate (default 1e-2)")
    p.add_argument("--json", action="store_true",
                   help="print the full summary as exactly one JSON document on stdout")
    p.add_argument("--device", **device)

    p = sub.add_parser("fsck", help="full-store integrity scrub: every prefix against its "
                                    "write-time digests and the reference graph; --repair "
                                    "runs the safe subset (quarantine, rebuild, "
                                    "digest-verified restore)")
    p.set_defaults(fn=cmd_fsck)
    p.add_argument("--store", **store)
    p.add_argument("--repair", action="store_true",
                   help="run the safe repair subset: corrupt bytes move to quarantine/ "
                        "(never deleted), derived artefacts rebuild, replicas restore "
                        "digest-verified, dangling alias slots demote; data-loss findings "
                        "are quarantined and reported")
    p.add_argument("--json", action="store_true",
                   help="print the full report as one JSON document on stdout")

    p = sub.add_parser("trace", help="inspect request traces in stored flight-recorder "
                                     "dumps (obs/flightrec/)")
    trace_sub = p.add_subparsers(dest="trace_command", required=True)
    p = trace_sub.add_parser("show", help="print one stored trace (JSON) by trace id or "
                                          "prefix")
    p.set_defaults(fn=cmd_trace)
    p.add_argument("--store", **store)
    p.add_argument("trace_id", help="full 32-hex trace id, or any unambiguous prefix "
                                    "(first match wins)")
    p = trace_sub.add_parser("tail", help="list recent dumps and the traces they carry")
    p.set_defaults(fn=cmd_trace)
    p.add_argument("--store", **store)
    p.add_argument("-n", type=_positive_int, default=5, metavar="N",
                   help="dumps to show, newest last (default 5)")
    p.add_argument("--traces", type=_positive_int, default=10, metavar="N",
                   help="traces to list per dump (default 10)")
    p = trace_sub.add_parser("export", help="render stored traces as a Chrome trace-event "
                                            "file, one track per trace")
    p.set_defaults(fn=cmd_trace)
    p.add_argument("--store", **store)
    p.add_argument("--chrome", required=True, metavar="OUT.json",
                   help="output path for the Chrome trace-event JSON")
    p.add_argument("--trace-id", default=None,
                   help="export only this trace (id or prefix); default: every trace "
                        "of the newest dump")
    _inject_tenant_arg(parser)
    return parser


def _inject_tenant_arg(parser: argparse.ArgumentParser) -> None:
    """Give every (sub)command that opens a store a ``--tenant`` flag, in
    one walk over the finished parser tree, so a new store-opening command
    cannot forget it. ``_store()`` scopes its keys under ``tenants/<ID>/``;
    ``default`` (or unset) is the root namespace."""
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            seen = set()
            for child in action.choices.values():
                if id(child) in seen:  # aliases share one parser
                    continue
                seen.add(id(child))
                _inject_tenant_arg(child)
    options = {s for a in parser._actions for s in a.option_strings}
    if "--store" in options and "--tenant" not in options:
        parser.add_argument(
            "--tenant", default=None, metavar="ID",
            help="tenant namespace to operate in (strictly validated "
                 "against the schema tenant-id charset; env "
                 "BODYWORK_TPU_TENANT is the soft default; 'default' = "
                 "the root namespace)",
        )


def main(argv=None) -> int:
    from bodywork_tpu_torch.utils.logging import configure_logger

    from bodywork_tpu_torch.utils.errors import init_error_monitoring

    args = build_parser().parse_args(argv)
    # logs on stderr: stdout carries the command's result
    configure_logger(args.log_level, stream=sys.stderr)
    init_error_monitoring(f"cli-{args.command}")
    if getattr(args, "tenant", None) is not None:
        from bodywork_tpu_torch.store.schema import validate_tenant_id

        try:
            validate_tenant_id(args.tenant)
        except ValueError as exc:  # the JAX command's exit for a bad flag
            print(f"error: {exc}", file=sys.stderr)
            return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
