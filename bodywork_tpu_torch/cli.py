"""Command line of the port: ``python -m bodywork_tpu_torch.cli
generate|serve|test|train|run-day|run-sim|registry``.

- ``generate --store S [--date D] [--days N] [--device cuda|cpu]`` writes
  N days of drift data starting at D (default: today, one day);
- ``serve --store S [--engine E] [--device cuda|cpu] [--host H]
  [--port P]`` serves the registry's ``production`` model (the newest
  checkpoint on a store without a registry; engine ``auto``: the fused
  kernel for a wide MLP it can launch, on the card);
- ``test --store S --scoring-url URL [--mode single|batch]
  [--max-rows N]`` black-box tests the live service on the latest day
  and persists the test metrics;
- ``train --store S [--model linear|mlp] [--mode full|incremental]`` fits
  on all history and persists the checkpoint and its metrics (only the
  ``full`` refit is ported);
- ``run-day --store S [--date D]`` runs one simulated day of the default
  pipeline (train -> registry gate -> serve -> generate -> test)
  in-process, and ``run-sim --store S --days N [--date D]
  [--samples-per-day R]`` runs N.
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

``--device`` defaults to ``cuda``: without a card the command refuses to
run unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
from datetime import date

from bodywork_tpu_torch.utils.dates import date_range, parse_date

#: the train command's modes (``train.trainer.TRAIN_MODES``, kept here so
#: building the parser imports no torch)
TRAIN_MODES = ("full", "incremental")

#: serving engines the cli offers (``auto`` + the port's engine names);
#: ``torch-bf16`` / ``torch-int8`` are not ported yet
SERVE_ENGINES = ("auto", "torch", "kernel", "kernel-bf16", "kernel-int8")


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


def cmd_serve(args) -> int:
    from bodywork_tpu_torch.serve import serve_latest_model

    serve_latest_model(
        args.store, host=args.host, port=args.port, block=True,
        engine=args.engine, device=args.device,
    )
    return 0


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
    print(f"{result.model_artefact_key} MAPE={m['MAPE']:.4f} r2={m['r_squared']:.4f} "
          f"mode={result.mode} rows_touched={result.rows_touched}")
    return 0


def _runner(args):
    from bodywork_tpu_torch.data.drift_config import DriftConfig
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
    from bodywork_tpu_torch.store import open_store

    spec = default_pipeline(args.model, args.mode)
    spec.stages[TRAIN_STAGE].args.update(_mlp_kwargs(args))
    samples = getattr(args, "samples_per_day", None)
    drift = DriftConfig(n_samples=samples) if samples else None
    return LocalRunner(spec, open_store(args.store), drift=drift, device=args.device)


def _print_day(r) -> None:
    from bodywork_tpu_torch.pipeline.runner import GATE_RESULT

    print(f"day {r.day}: {r.wall_clock_s:.3f}s")
    for name, secs in r.stage_seconds.items():
        print(f"  {name}: {secs:.3f}s")
    if r.gate_seconds is not None:
        decision = r.stage_results.get(GATE_RESULT)
        verdict = ("nothing to gate" if decision is None
                   else f"{'PROMOTED' if decision.promote else 'REJECTED'} "
                        f"{decision.model_key}")
        print(f"  {GATE_RESULT}: {r.gate_seconds:.3f}s ({verdict})")
    sys.stdout.flush()


def cmd_run_day(args) -> int:
    runner = _runner(args)
    d = parse_date(args.date) if args.date else date.today()
    runner.bootstrap(d)
    _print_day(runner.run_day(d))
    return 0


def cmd_run_sim(args) -> int:
    runner = _runner(args)
    start = parse_date(args.date) if args.date else date.today()
    results = runner.run_simulation(start, args.days, on_day=_print_day)
    total = sum(r.wall_clock_s for r in results)
    print(f"total {total:.3f}s over {args.days} day(s), "
          f"mean {total / max(args.days, 1):.3f}s/day")
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
        help="plain f32 torch, the fused CUDA kernel (f32, bf16 or int8 "
             "weights), or auto (the f32 kernel for an MLP whose hidden "
             "layers are all >= 256 wide and that it can launch, on the card)",
    )
    p.add_argument("--device", **device)

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
    p.add_argument("--mode", default="full", choices=list(TRAIN_MODES),
                   help="full refit on all history (incremental is not ported yet)")

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
        if name == "run-sim":
            p.add_argument("--days", type=_positive_int, required=True)
            p.add_argument("--samples-per-day", type=_positive_int, default=None, metavar="N",
                           help="rows the generator draws a day (default 1440)")

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
    return parser


def main(argv=None) -> int:
    from bodywork_tpu_torch.utils.logging import configure_logger

    args = build_parser().parse_args(argv)
    # logs on stderr: stdout carries the command's result
    configure_logger(args.log_level, stream=sys.stderr)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
