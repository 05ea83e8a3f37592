"""Command line of the port: ``python -m bodywork_tpu_torch.cli
generate|serve|test``.

- ``generate --store S [--date D] [--days N] [--device cuda|cpu]`` writes
  N days of drift data starting at D (default: today, one day);
- ``serve --store S [--engine E] [--device cuda|cpu] [--host H]
  [--port P]`` serves the newest checkpoint (engine ``auto``: the fused
  kernel for a wide MLP on the card);
- ``test --store S --scoring-url URL [--mode single|batch]
  [--max-rows N]`` black-box tests the live service on the latest day
  and persists the test metrics.

``--device`` defaults to ``cuda``: without a card the command refuses to
run unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import sys
from datetime import date

from bodywork_tpu_torch.utils.dates import date_range, parse_date

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
             "layers are all >= 256 wide, on the card)",
    )
    p.add_argument("--device", **device)

    p = sub.add_parser("test", help="black-box test the live scoring service")
    p.set_defaults(fn=cmd_test)
    p.add_argument("--store", **store)
    p.add_argument("--scoring-url", required=True)
    p.add_argument("--mode", default="single", choices=["single", "batch"])
    p.add_argument("--max-rows", type=int, default=None)
    return parser


def main(argv=None) -> int:
    from bodywork_tpu_torch.utils.logging import configure_logger

    args = build_parser().parse_args(argv)
    # logs on stderr: stdout carries the command's result
    configure_logger(args.log_level, stream=sys.stderr)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
