"""Command line of the port: ``python -m bodywork_tpu_torch.cli
generate|serve|test|train|run-day|run-sim|compact|registry|trace``.

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
  explicit ``--batch-window-ms 0`` turns coalescing off. SIGTERM closes
  admission, flushes the coalescer and exits 143;
- ``test --store S --scoring-url URL [--mode single|batch]
  [--max-rows N]`` black-box tests the live service on the latest day
  and persists the test metrics;
- ``train --store S [--model linear|mlp] [--mode full|incremental]`` fits
  and persists the checkpoint and its metrics: a full refit on all
  history, or the incremental fold (default from
  ``BODYWORK_TPU_TRAIN_MODE``), which prints its fallback reason when it
  ran as a full refit;
- ``run-day --store S [--date D] [--no-resume]`` runs one simulated day
  of the default pipeline (train -> registry gate -> serve -> generate ->
  test) in-process, crash-resumable through the day's run journal, with
  the JAX command's exit codes: 0 done, 1 a stage failed, 5 another
  runner holds the day's lease, 6 the journal marks the day complete and
  every artefact verified (nothing ran), 143 SIGTERM (the journal marks
  the day interrupted; the next run resumes it). ``run-sim --store S
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
  [--device cuda|cpu]``. A registry error exits 1. (The canary verbs
  are a later slice.)

- ``trace show ID|tail [-n N] [--traces N]|export --chrome OUT
  [--trace-id ID] --store S`` reads the flight-recorder dumps under
  ``obs/flightrec/`` (either package's): exit 9 when the trace (or, for
  ``tail`` and ``export``, any dump) is absent, 1 on an error.

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


def cmd_generate(args) -> int:
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.store import open_store

    device = resolve_device(args.device)
    store = open_store(args.store)
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
    if args.batch_max_rows and not batch_window:
        log.warning("--batch-max-rows has no effect without --batch-window-ms; "
                    "request coalescing stays OFF")
    # serve_latest_model drains on a SIGTERM while serving (admission
    # closed, coalescer flushed); one during start-up unwinds to here
    with graceful_sigterm() as sigterm_fired:
        try:
            serve_latest_model(
                args.store, host=args.host, port=args.port, block=True,
                engine=args.engine, device=args.device, dtype=args.dtype,
                buckets=args.buckets, batch_window_ms=batch_window,
                batch_max_rows=args.batch_max_rows, server_engine=args.server_engine,
                max_pending=args.max_pending, retry_after_max_s=args.retry_after_max_s,
            )
        except ShutdownRequested:
            log.warning("SIGTERM during service startup; exiting")
    return SIGTERM_EXIT if sigterm_fired.is_set() else 0


def cmd_test(args) -> int:
    from bodywork_tpu_torch.monitor import (
        HttpScoringClient,
        run_service_test,
        scoring_endpoint,
    )
    from bodywork_tpu_torch.store import open_store

    client = HttpScoringClient(scoring_endpoint(args.scoring_url, args.mode))
    metrics = run_service_test(
        open_store(args.store), client, mode=args.mode, max_rows=args.max_rows,
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
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.train import train_on_history

    result = train_on_history(open_store(args.store), args.model,
                              model_kwargs=_mlp_kwargs(args) or None, mode=args.mode,
                              device=args.device)
    m = result.metrics
    fallback = f" fallback={result.fallback_reason}" if result.fallback_reason else ""
    print(f"{result.model_artefact_key} MAPE={m['MAPE']:.4f} r2={m['r_squared']:.4f} "
          f"mode={result.mode} rows_touched={result.rows_touched}{fallback}")
    return 0


def _runner(args):
    """The day loop's runner, over the store wrapped in the kill switch
    that ``BODYWORK_TPU_CRASH_SCHEDULE`` arms (untouched when unset)."""
    from bodywork_tpu_torch.chaos.kill import arm_from_env, wrap_store
    from bodywork_tpu_torch.data.drift_config import DriftConfig
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import open_store

    arm_from_env()
    spec = default_pipeline(args.model, args.mode,
                            overlap_generate=getattr(args, "overlap_generate", False))
    spec.stages[TRAIN_STAGE].args.update(_mlp_kwargs(args))
    samples = getattr(args, "samples_per_day", None)
    drift = DriftConfig(n_samples=samples) if samples else None
    return LocalRunner(spec, wrap_store(open_store(args.store)), drift=drift,
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


def _write_day_outputs(args, runner, result, d: date) -> None:
    """``run-day --trace-out/--report-out``: the runner's whole timeline
    (bootstrap included) as a Chrome trace, and the day's report."""
    from bodywork_tpu_torch.obs.spans import day_report, write_chrome_trace, write_day_report

    trace_out = args.trace_out.replace("{date}", str(d)) if args.trace_out else None
    report_out = args.report_out.replace("{date}", str(d)) if args.report_out else None
    if trace_out:
        path = write_chrome_trace(trace_out, runner.recorder.spans(),
                                  process_name=f"run-day {d}")
        print(f"trace: {path}")
    path = write_day_report(report_out or _derived_report_path(trace_out), day_report(result))
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
    if args.trace_out or args.report_out:
        _write_day_outputs(args, runner, result, d)
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


def cmd_compact(args) -> int:
    """Consolidate the dataset history into one ``snapshots/`` artefact, so
    a cold process loads it in O(1 + tail) reads; ``--dry-run`` prints
    what it would consolidate and writes nothing."""
    from bodywork_tpu_torch.data.snapshot import SNAPSHOT_KEEP, plan_compaction, write_snapshot
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = open_store(args.store)
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
    from bodywork_tpu_torch.store import open_store

    store = open_store(args.store)
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
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = open_store(args.store)
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
    from bodywork_tpu_torch.store import open_store

    doc = ModelRegistry(open_store(args.store)).promote(
        _registry_model_key(args.model), day=_date(args), reason="cli: operator promote")
    print(f"production -> {doc['production']} (previous: {doc['previous']})")
    return 0


@_registry_errors
def cmd_registry_rollback(args) -> int:
    from bodywork_tpu_torch.registry import ModelRegistry, RollbackBlocked
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.utils.logging import get_logger

    try:
        doc = ModelRegistry(open_store(args.store)).rollback(
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
    from bodywork_tpu_torch.store import open_store

    policy = GatePolicy()
    device = None
    if args.shadow_days is not None:
        policy.shadow_days = args.shadow_days
        device = resolve_device(args.device)  # the shadow scores on it
    registry = ModelRegistry(open_store(args.store), policy=policy, device=device)
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
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    store = open_store(args.store)
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
            p.add_argument("--no-resume", action="store_true",
                           help="ignore the runs/ journal: no lease, no verified skipping, "
                                "a full re-run. Default: resume, skipping completed stages "
                                "whose recorded artefact digests verify (exit 5: another "
                                "runner holds the lease; 6: the day was already complete)")

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
    return parser


def main(argv=None) -> int:
    from bodywork_tpu_torch.utils.logging import configure_logger

    args = build_parser().parse_args(argv)
    # logs on stderr: stdout carries the command's result
    configure_logger(args.log_level, stream=sys.stderr)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
