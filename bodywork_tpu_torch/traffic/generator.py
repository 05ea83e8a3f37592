"""Seeded open-loop traffic generation (the port's copy of
``bodywork_tpu.traffic.generator``: the same draws from
``np.random.default_rng(seed)``, so the same config gives the same log,
and the same ``bodywork_tpu.request_log/1`` files, in both packages).

A *closed-loop* benchmark runs N clients, each waiting for a response
before it sends the next request. A closed-loop client can never overrun the server — its
request rate adapts to the server's service rate — so those numbers say
nothing about behaviour under *open-loop* load, where arrivals come from
the outside world at their own rate ("millions of users" do not
coordinate with the scoring service). This module generates the
open-loop side: a **request log** — the full arrival sequence with
per-request payloads — as a pure function of a seed, in the same spirit
as the chaos harness's seeded fault plans (``chaos.plan``): the same
seed replays the exact same traffic, regardless of what the server under
test does with it, which is what makes A/B runs (engine vs engine, knob
vs knob) comparisons rather than anecdotes.

Arrival processes (:data:`ARRIVAL_PROCESSES`):

- ``poisson`` — memoryless arrivals at a constant mean rate: the
  classic open-loop model, and the kindest realistic one (no burst
  structure beyond exponential clumping).
- ``mmpp`` — a 2-state Markov-modulated Poisson process: the process
  alternates between a *calm* and a *burst* state (exponentially
  distributed dwell times), each emitting Poisson arrivals at its own
  rate, with the burst state ``burst_multiplier`` times hotter. The
  time-averaged rate is still ``rate_rps`` — the same offered load as
  the Poisson case, delivered in squalls. This is the traffic shape
  that actually breaks queues: admission control that survives Poisson
  can still collapse under MMPP's sustained bursts.

The traffic *mix* models the two scoring shapes the service exposes:
each arrival is a single-row ``/score/v1`` request or (with probability
``batch_fraction``) a ``batch_rows``-row ``/score/v1/batch`` request.
Feature values are drawn uniform over the drift generator's [0, 100)
domain, so the server-side work per request matches the parity workload.

Request logs round-trip through JSONL files
(:func:`write_request_log` / :func:`read_request_log`) so a captured or
generated log can be replayed later — against a different engine, a
different build, or a production candidate — byte-for-byte.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("traffic.generator")

__all__ = [
    "ARRIVAL_PROCESSES",
    "TRANSPORTS",
    "Request",
    "TrafficConfig",
    "generate_request_log",
    "read_request_log",
    "write_request_log",
]

#: supported arrival processes (kept in sync with ``cli traffic run
#: --arrival`` choices by tests/test_traffic.py)
ARRIVAL_PROCESSES = ("poisson", "mmpp")

#: supported wire encodings for the same request log (kept in sync with
#: ``cli traffic run --transport`` choices by tests): "json" is the
#: frozen /score contract body, "binary" the f32 row framing
#: (serve.wire.BINARY_CONTENT_TYPE) that skips JSON float formatting on
#: both ends — same schedule, same rows, different bytes on the wire
TRANSPORTS = ("json", "binary")

#: request-log file schema tag — readers refuse logs they would
#: misinterpret instead of replaying garbage traffic
LOG_SCHEMA = "bodywork_tpu.request_log/1"


@dataclasses.dataclass(frozen=True)
class Request:
    """One scheduled request: WHEN it arrives (offset from run start),
    WHERE it goes, and exactly WHAT it carries. Frozen: a log entry is
    a fact about the schedule, never mutated by a run."""

    t_s: float
    route: str  # "/score/v1" | "/score/v1/batch"
    x: tuple[float, ...]

    @property
    def rows(self) -> int:
        """Feature rows this request scores — the offered row-shape
        unit the tuner's bucket-ladder model conditions on
        (the JAX package's ``tune/collect.py``). Single-row scoring sends one row no
        matter how many values ride the payload."""
        return len(self.x) if self.route.endswith("/batch") else 1

    def payload(self) -> bytes:
        """The HTTP body this request sends — built here so every
        replay of a log sends byte-identical requests."""
        if self.route == "/score/v1":
            return json.dumps({"X": [self.x[0]]}).encode()
        return json.dumps({"X": list(self.x)}).encode()

    def payload_binary(self) -> bytes:
        """The same request as binary row framing
        (``serve.wire.BINARY_CONTENT_TYPE``): the rows :meth:`payload`
        encodes as JSON, framed as little-endian f32 — what
        ``--transport binary`` puts on the wire. Deterministic for the
        same log entry, like :meth:`payload`."""
        from bodywork_tpu_torch.serve.wire import encode_binary_rows

        if self.route == "/score/v1":
            return encode_binary_rows(np.asarray([self.x[0]]))
        return encode_binary_rows(np.asarray(self.x))


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """The knobs a request log is generated from. Everything that
    shapes the sequence is HERE, so (config, seed) fully determines the
    log — the replayability contract."""

    rate_rps: float = 100.0
    duration_s: float = 5.0
    arrival: str = "poisson"
    #: probability an arrival is a /score/v1/batch request
    batch_fraction: float = 0.0
    #: rows per batch request
    batch_rows: int = 64
    seed: int = 0
    #: mmpp: burst-state arrival rate as a multiple of the calm rate
    burst_multiplier: float = 4.0
    #: mmpp: mean dwell seconds in (calm, burst) before switching
    dwell_s: tuple[float, float] = (1.0, 0.25)

    def validate(self) -> None:
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {self.rate_rps}")
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {self.duration_s}"
            )
        if self.arrival not in ARRIVAL_PROCESSES:
            raise ValueError(
                f"arrival must be one of {ARRIVAL_PROCESSES}, "
                f"got {self.arrival!r}"
            )
        if not 0.0 <= self.batch_fraction <= 1.0:
            raise ValueError(
                f"batch_fraction must be in [0, 1], got {self.batch_fraction}"
            )
        if self.batch_rows < 1:
            raise ValueError(
                f"batch_rows must be >= 1, got {self.batch_rows}"
            )
        if self.burst_multiplier <= 0:
            raise ValueError(
                f"burst_multiplier must be > 0, got {self.burst_multiplier}"
            )
        if len(self.dwell_s) != 2 or any(d <= 0 for d in self.dwell_s):
            raise ValueError(
                f"dwell_s must be two positive means, got {self.dwell_s}"
            )

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dwell_s"] = list(self.dwell_s)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown traffic config field(s): {sorted(unknown)}"
            )
        if "dwell_s" in d:
            d = {**d, "dwell_s": tuple(d["dwell_s"])}
        config = cls(**d)
        config.validate()
        return config


def _poisson_arrivals(rng: np.random.Generator, rate: float,
                      duration: float) -> list[float]:
    times: list[float] = []
    t = rng.exponential(1.0 / rate)
    while t < duration:
        times.append(t)
        t += rng.exponential(1.0 / rate)
    return times


def _mmpp_arrivals(rng: np.random.Generator, config: TrafficConfig) -> list[float]:
    """2-state MMPP with the time-averaged rate pinned to ``rate_rps``:
    the calm rate is solved so that dwell-weighted mean(calm, burst)
    equals the configured offered load — MMPP changes the SHAPE of the
    traffic, never the amount, so a Poisson-vs-MMPP pair at one
    ``rate_rps`` isolates burst tolerance."""
    w_calm = config.dwell_s[0] / (config.dwell_s[0] + config.dwell_s[1])
    w_burst = 1.0 - w_calm
    calm_rate = config.rate_rps / (w_calm + w_burst * config.burst_multiplier)
    rates = (calm_rate, calm_rate * config.burst_multiplier)

    times: list[float] = []
    t, state = 0.0, 0
    state_end = rng.exponential(config.dwell_s[state])
    while t < config.duration_s:
        gap = rng.exponential(1.0 / rates[state])
        if t + gap >= state_end:
            # exponential inter-arrivals are memoryless: jumping to the
            # state boundary and redrawing at the new state's rate is
            # exact, not an approximation
            t = state_end
            state = 1 - state
            state_end = t + rng.exponential(config.dwell_s[state])
            continue
        t += gap
        if t < config.duration_s:
            times.append(t)
    return times


def generate_request_log(config: TrafficConfig) -> list[Request]:
    """The full request sequence for ``config`` — a pure function of
    the config (including its seed): calling this twice yields equal
    lists, which is the property every replay/determinism guarantee in
    the harness rests on (pinned by tests/test_traffic.py)."""
    config.validate()
    rng = np.random.default_rng(config.seed)
    if config.arrival == "poisson":
        times = _poisson_arrivals(rng, config.rate_rps, config.duration_s)
    else:
        times = _mmpp_arrivals(rng, config)
    requests: list[Request] = []
    for t in times:
        is_batch = (
            config.batch_fraction > 0.0
            and rng.random() < config.batch_fraction
        )
        n_rows = config.batch_rows if is_batch else 1
        # the drift generator's feature domain (data/generator.py), so
        # per-request server work matches the parity workload
        x = tuple(float(v) for v in rng.uniform(0.0, 100.0, n_rows))
        requests.append(Request(
            t_s=round(float(t), 9),
            route="/score/v1/batch" if is_batch else "/score/v1",
            x=x,
        ))
    return requests


def write_request_log(path: str | Path, config: TrafficConfig,
                      requests: list[Request]) -> None:
    """JSONL: one header line (schema + generating config), then one
    line per request. Plain text so a log diffs/greps like any other
    artefact."""
    path = Path(path)
    with path.open("w") as f:
        f.write(json.dumps({
            "schema": LOG_SCHEMA,
            "config": config.to_dict(),
            "n_requests": len(requests),
        }) + "\n")
        for r in requests:
            # "rows" is derivable from (route, x) but recorded
            # explicitly so the tuner (and any log consumer) can
            # reconstruct the offered row-shape distribution without
            # knowing the route->rows rule (a tuner reads it;
            # read_request_log below tolerates its absence in old logs)
            f.write(json.dumps(
                {"t_s": r.t_s, "route": r.route, "rows": r.rows,
                 "x": list(r.x)}
            ) + "\n")
    log.info(f"wrote request log: {len(requests)} requests -> {path}")


def read_request_log(path: str | Path) -> tuple[TrafficConfig, list[Request]]:
    """Load a log written by :func:`write_request_log`. The header's
    count is verified so a truncated file fails loudly instead of
    silently replaying a lighter load."""
    path = Path(path)
    with path.open() as f:
        header = json.loads(f.readline())
        if header.get("schema") != LOG_SCHEMA:
            raise ValueError(
                f"{path}: not a request log (schema "
                f"{header.get('schema')!r}, expected {LOG_SCHEMA!r})"
            )
        requests = [
            Request(t_s=e["t_s"], route=e["route"],
                    x=tuple(float(v) for v in e["x"]))
            for e in (json.loads(line) for line in f if line.strip())
        ]
    if len(requests) != header.get("n_requests"):
        raise ValueError(
            f"{path}: truncated request log "
            f"({len(requests)} of {header.get('n_requests')} requests)"
        )
    return TrafficConfig.from_dict(header["config"]), requests
