"""Open-loop load driver: replay a request log against a live service
(the port's copy of ``bodywork_tpu.traffic.runner``; the same report).

The driver is the *open-loop* half of the harness contract: requests
fire at their scheduled arrival times **whether or not earlier responses
have returned**. A slow server does not slow the driver down — it just
accumulates in-flight requests, exactly as real arrival-rate traffic
would. (The closed-loop helpers in ``bench.py`` are the opposite
regime: they measure the server's service rate; this measures its
behaviour at a fixed offered rate.)

Measurement protocol:

- **Latency is measured from the scheduled arrival time**, not from the
  moment the request hit the wire. Measuring from send-time is the
  classic coordinated-omission mistake: a driver that stalls behind a
  slow server under-reports exactly the latencies that matter. The
  driver's own scheduling health is reported separately
  (``send_lag_p99_s``) so a client-side stall is visible instead of
  silently polluting the server's numbers.
- **Goodput counts 200s only.** A shed 429, a degraded 503, or a
  transport error all consumed offered load without delivering a
  prediction; ``goodput_rps`` is the rate of *useful* responses — the
  number an SLO is written against.
- **Keep-alive connection pool.** Requests ride a shared pool of
  keep-alive connections (grown on demand, one in-flight request per
  connection), the shape real arrival-rate traffic has by the time it
  reaches a replica: individual users don't share sockets, but their
  requests arrive through load balancers and sidecars that do. It also
  keeps the *measurement* about request admission rather than TCP
  churn — with a connection dialed per request, an overloaded server
  pays accept/close for every request it sheds, and at rates where
  scoring is a cheap coalesced batch that churn (not the scoring) is
  what collapses, drowning the very effect config 9 exists to measure.

The transport is pluggable (``transport=`` — an async callable taking a
:class:`~bodywork_tpu_torch.traffic.generator.Request` and returning
``(status, retry_after_s)``): tests substitute a recording/canned
transport to prove replay determinism without a socket, the CLI and
bench use the real HTTP transport.

The driver itself has a ceiling: ONE process's event loop drives as
many requests a second as one core can send. ``shards=N`` splits the log round-robin across N
worker processes — round-robin preserves both the aggregate rate and
the arrival-time distribution of every shard — and merges the
per-shard results into ONE report, so the offered rate scales with
driver cores while every measurement rule above still holds.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import multiprocessing
import urllib.parse

from bodywork_tpu_torch.traffic.generator import Request
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("traffic.runner")

__all__ = ["LoadReport", "format_report", "run_open_loop"]

#: response head + headers cap when parsing the reply
_MAX_HEAD = 64 * 1024


@dataclasses.dataclass
class _Result:
    t_s: float            # scheduled arrival offset
    status: int           # 0 = transport error / timeout
    retry_after_s: float | None
    latency_s: float      # scheduled arrival -> response complete
    send_lag_s: float     # scheduled arrival -> actually sent
    #: the X-Bodywork-Model-Key response header (which model ANSWERED —
    #: production, canary, or a firewall fallback); None when absent
    model_key: str | None = None
    #: the X-Bodywork-Trace-Id response header (obs/tracing.py): the
    #: server-side trace this request became — the join key between
    #: client-observed latency and server-side spans; None when the
    #: service runs tracing-off
    trace_id: str | None = None
    #: feature rows this request carried (the offered row-shape unit;
    #: the tuner reconstructs the row distribution from a results log
    #: alone — replayed logs previously lost it)
    rows: int = 1


def _percentile(sorted_vals: list, q: float) -> float | None:
    """Nearest-rank percentile (the bench.py convention)."""
    if not sorted_vals:
        return None
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * len(sorted_vals) + 0.5)) - 1))
    return sorted_vals[k]


@dataclasses.dataclass
class LoadReport:
    """One open-loop run, summarised. ``to_dict`` is the record the CLI
    prints and bench config 9 embeds."""

    requests: int
    duration_s: float
    offered_rps: float
    ok: int
    #: OK responses that completed INSIDE the offered-load window
    #: (scheduled arrival + latency <= duration). Under overload the
    #: plain ``ok`` count includes the post-window queue drain;
    #: in-window goodput is the sustainable service rate — the capacity
    #: estimator reads THIS.
    ok_in_window: int
    shed: int              # 429 (admission or injected)
    unavailable: int       # 503
    client_error: int      # other 4xx
    server_error: int      # 5xx except 503
    transport_errors: int  # connect/reset/parse failures
    timeouts: int
    goodput_rps: float
    goodput_in_window_rps: float
    shed_fraction: float
    latency: dict          # p50/p99/p999 over OK responses, seconds
    retry_after: dict      # {responses, mean_s, max_s} where the header appeared
    send_lag_p99_s: float | None
    max_in_flight: int
    #: longest service blackout observed by the driver: the maximum
    #: time-span (in scheduled-arrival time) over any run of consecutive
    #: scheduled arrivals that produced zero 200s, measured from the
    #: first failed arrival to the next successful one. THE failover
    #: headline — bench config 17 asserts this stays under the lease
    #: TTL plus one reconnect backoff when the active dispatcher dies.
    max_blackout_s: float = 0.0
    #: responses carrying an X-Bodywork-Trace-Id header — nonzero means
    #: the service ran tracing-on and the results log (when written)
    #: joins to server-side spans
    traced_responses: int = 0
    #: latency/goodput broken down by the RESPONDING model key (the
    #: X-Bodywork-Model-Key header; "unknown" bucket when absent) — how
    #: a canary sweep attributes per-version behaviour with this harness
    per_model_key: dict = dataclasses.field(default_factory=dict)
    #: driver worker processes this report aggregates (1 = the classic
    #: single-process drive, ceiling ~1.6k rps; >1 = the sharded driver)
    shards: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _ConnectionPool:
    """Keep-alive connections to one host:port, grown on demand. Each
    connection carries ONE request at a time (no pipelining); a
    connection that errored, was cancelled mid-exchange, or whose
    server answered ``Connection: close`` is discarded, never reused —
    a fresh dial replaces it on the next acquire."""

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._idle: list = []

    async def acquire(self):
        """``(reader, writer, reused)`` — ``reused`` marks a pooled
        connection, which the transport may legally find half-closed
        (the server timed it out while idle) and retry fresh."""
        while self._idle:
            reader, writer = self._idle.pop()
            if reader.at_eof() or writer.is_closing():
                writer.close()
                continue
            return reader, writer, True
        reader, writer = await asyncio.open_connection(
            self.host, self.port, limit=_MAX_HEAD
        )
        return reader, writer, False

    def release(self, reader, writer, reusable: bool) -> None:
        if reusable and not reader.at_eof() and not writer.is_closing():
            self._idle.append((reader, writer))
        else:
            writer.close()

    def close(self) -> None:
        while self._idle:
            _reader, writer = self._idle.pop()
            writer.close()


async def _http_transport(pool: _ConnectionPool, request: Request,
                          kind: str = "json"):
    """One request over a pooled keep-alive connection. Returns
    ``(status, retry_after_s)``; raises on transport failure (the
    driver counts). On ANY failure — including a cancellation from the
    driver's timeout — the connection is discarded, so a half-read
    response can never bleed into the next request.

    ``kind`` selects the wire encoding (``generator.TRANSPORTS``):
    "json" sends the frozen contract body, "binary" the f32 row
    framing — the same log drives either, so a json-vs-binary pair
    isolates serialization cost from everything else.

    A *reused* connection the server closed while it idled in the pool
    (thread-per-request servers time out keep-alive sockets) fails
    before a single response byte arrives; scoring is idempotent and
    nothing was answered, so the request retries exactly once on a
    fresh dial — the same reused-idempotent rule urllib3 applies. A
    FRESH connection failing is a real transport error and propagates."""
    if kind == "binary":
        from bodywork_tpu_torch.serve.wire import BINARY_CONTENT_TYPE

        body = request.payload_binary()
        content_type = BINARY_CONTENT_TYPE
    else:
        body = request.payload()
        content_type = "application/json"
    head = (
        f"POST {request.route} HTTP/1.1\r\n"
        f"Host: {pool.host}:{pool.port}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n\r\n"
    ).encode("latin-1")
    for attempt in (0, 1):
        reader, writer, reused = await pool.acquire()
        reusable = False
        try:
            try:
                writer.write(head + body)
                await writer.drain()
                status_line = await reader.readline()
            except (ConnectionResetError, BrokenPipeError):
                if reused and attempt == 0:
                    continue  # stale keep-alive: one retry, fresh dial
                raise
            if not status_line:
                if reused and attempt == 0:
                    continue  # EOF before the status line, same story
                raise ConnectionResetError("EOF before response status line")
            parts = status_line.decode("latin-1").split(" ", 2)
            status = int(parts[1])
            retry_after = None
            model_key = None
            trace_id = None
            content_length = None
            keep_alive = True
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _sep, value = line.decode("latin-1").partition(":")
                name = name.strip().lower()
                if name == "retry-after":
                    try:
                        retry_after = float(value.strip())
                    except ValueError:
                        pass
                elif name == "x-bodywork-model-key":
                    # which model version ANSWERED — the per-model-key
                    # report breakdown reads this (canary sweeps)
                    model_key = value.strip() or None
                elif name == "x-bodywork-trace-id":
                    # the server-side trace id (obs/tracing.py) — logged
                    # per request so spans join to client latencies
                    trace_id = value.strip() or None
                elif name == "content-length":
                    try:
                        content_length = int(value.strip())
                    except ValueError:
                        pass
                elif name == "connection":
                    keep_alive = value.strip().lower() != "close"
            if content_length:
                await reader.readexactly(content_length)
            # a response with no Content-Length would need a close/EOF
            # to delimit — never reusable
            reusable = keep_alive and content_length is not None
            return status, retry_after, model_key, trace_id
        finally:
            pool.release(reader, writer, reusable)
    raise ConnectionResetError("unreachable")  # pragma: no cover


def _drive_once(
    url: str,
    requests_log: list[Request],
    timeout_s: float,
    transport,
    transport_kind: str,
):
    """One process's open-loop drive: fire every request at its
    scheduled time, return ``(results, timeouts, max_in_flight)``. The
    single-shard core both :func:`run_open_loop` and each shard worker
    run."""
    parsed = urllib.parse.urlsplit(url)
    host = parsed.hostname or "127.0.0.1"
    port = parsed.port or 80
    pool: _ConnectionPool | None = None
    if transport is None:
        from bodywork_tpu_torch.traffic.generator import TRANSPORTS

        if transport_kind not in TRANSPORTS:
            raise ValueError(
                f"transport_kind must be one of {TRANSPORTS}, "
                f"got {transport_kind!r}"
            )
        pool = _ConnectionPool(host, port)
        if transport_kind == "binary":
            # the framing's first use imports the serving package (and
            # torch): seconds that would stall the loop after its clock
            # starts, in a fresh shard process
            from bodywork_tpu_torch.serve.wire import encode_binary_rows  # noqa: F401

        async def transport(req: Request):
            return await _http_transport(pool, req, kind=transport_kind)

    results: list[_Result] = []
    in_flight = 0
    max_in_flight = 0
    timeouts = 0

    async def _drive():
        nonlocal in_flight, max_in_flight, timeouts
        loop = asyncio.get_running_loop()
        t_start = loop.time()

        async def fire(req: Request):
            nonlocal in_flight, max_in_flight, timeouts
            target = t_start + req.t_s
            delay = target - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            send_lag = loop.time() - target
            in_flight += 1
            max_in_flight = max(max_in_flight, in_flight)
            model_key = None
            trace_id = None
            try:
                outcome = await asyncio.wait_for(transport(req), timeout_s)
                # the HTTP transport reports (status, retry_after,
                # model_key, trace_id); shorter tuples from older or
                # pluggable transports land in the "unknown" buckets
                if len(outcome) >= 4:
                    status, retry_after, model_key, trace_id = outcome[:4]
                elif len(outcome) == 3:
                    status, retry_after, model_key = outcome
                else:
                    status, retry_after = outcome
            except asyncio.TimeoutError:
                timeouts += 1
                status, retry_after = 0, None
            except Exception:
                status, retry_after = 0, None
            finally:
                in_flight -= 1
            results.append(_Result(
                t_s=req.t_s, status=status, retry_after_s=retry_after,
                latency_s=loop.time() - target, send_lag_s=send_lag,
                model_key=model_key, trace_id=trace_id,
                rows=req.rows,
            ))

        try:
            await asyncio.gather(*[fire(r) for r in requests_log])
        finally:
            if pool is not None:
                pool.close()

    asyncio.run(_drive())
    return results, timeouts, max_in_flight


def _shard_main(url, requests_log, timeout_s, transport_kind, conn) -> None:
    """One sharded-driver worker: drive this shard's slice of the log,
    ship the raw per-request results back over the pipe (``_Result`` is
    a plain picklable dataclass). Any failure is shipped too — a dead
    shard must fail the whole run loudly, not silently under-offer."""
    try:
        results, timeouts, max_in_flight = _drive_once(
            url, requests_log, timeout_s, None, transport_kind
        )
        conn.send(("ok", results, timeouts, max_in_flight))
    except BaseException as exc:  # noqa: BLE001 - marshalled to the parent
        conn.send(("error", repr(exc)))
    finally:
        conn.close()


def _merged_max_in_flight(results: list[_Result]) -> int:
    """Exact peak concurrency across every shard, reconstructed from the
    per-request send/complete intervals (per-shard maxima cannot be
    summed — shards do not peak at the same instant)."""
    events = []
    for r in results:
        events.append((r.t_s + r.send_lag_s, 1))
        events.append((r.t_s + r.latency_s, -1))
    events.sort()
    peak = current = 0
    for _t, delta in events:
        current += delta
        peak = max(peak, current)
    return peak


def run_open_loop(
    url: str,
    requests_log: list[Request],
    timeout_s: float = 30.0,
    transport=None,
    duration_s: float | None = None,
    results_log: str | None = None,
    transport_kind: str = "json",
    shards: int = 1,
) -> LoadReport:
    """Fire ``requests_log`` at its scheduled arrival times against
    ``url`` (scheme://host:port — any path component is ignored; each
    log entry carries its own route) and summarise the outcome.

    ``results_log`` writes one JSONL record per request (scheduled
    arrival, status, client-observed latency, send lag, answering model
    key, and the server's returned trace id) — the join table between
    this harness's client-side latencies and the server-side spans a
    flight-recorder dump or ``cli trace show`` holds for the same trace
    id (obs/tracing.py).

    ``shards=N`` drives through N worker processes, splitting the log
    round-robin (``requests_log[i::N]`` keeps every shard's rate and
    arrival distribution proportional) and merging the per-shard
    results into this one report — the escape from the single-process
    generator's one-core ceiling.
    Custom ``transport=`` callables cannot cross the process boundary,
    so sharding requires the real HTTP transport.

    Runs its own event loop, so it is callable from plain synchronous
    code (the CLI, bench children, tests); do not call it from inside a
    running loop."""
    if not requests_log:
        raise ValueError("empty request log: nothing to drive")
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    shards = min(shards, len(requests_log))
    span = duration_s if duration_s is not None else max(
        r.t_s for r in requests_log
    )
    span = max(span, 1e-6)
    if shards == 1:
        results, timeouts, max_in_flight = _drive_once(
            url, requests_log, timeout_s, transport, transport_kind
        )
    else:
        if transport is not None:
            raise ValueError(
                "shards > 1 requires the built-in HTTP transport "
                "(a custom transport callable cannot cross the "
                "worker-process boundary)"
            )
        # spawn, not fork: the driver may run inside a process that
        # holds threads and a live CUDA context, which a forked child
        # must not inherit
        ctx = multiprocessing.get_context("spawn")
        workers = []
        for i in range(shards):
            parent_conn, child_conn = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_shard_main,
                args=(url, requests_log[i::shards], timeout_s,
                      transport_kind, child_conn),
                daemon=True,
            )
            proc.start()
            child_conn.close()
            workers.append((proc, parent_conn))
        results = []
        timeouts = 0
        errors = []
        for i, (proc, conn) in enumerate(workers):
            try:
                outcome = conn.recv()
            except EOFError:
                outcome = ("error", f"shard {i} died without a result")
            if outcome[0] == "ok":
                results.extend(outcome[1])
                timeouts += outcome[2]
            else:
                errors.append(f"shard {i}: {outcome[1]}")
            proc.join(timeout=30)
        if errors:
            raise RuntimeError(
                "sharded open-loop drive failed: " + "; ".join(errors)
            )
        max_in_flight = _merged_max_in_flight(results)

    if results_log:
        # per-request JSONL, in scheduled-arrival order (the log the
        # harness joins against server-side spans by trace id)
        from pathlib import Path as _Path

        path = _Path(results_log)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for r in sorted(results, key=lambda r: r.t_s):
                f.write(json.dumps({
                    "t_s": _round6(r.t_s),
                    # scheduled-vs-actual send, both explicit: the
                    # tuner reconstructs the ACHIEVED arrival process
                    # (and driver health) from the log alone
                    "sent_t_s": _round6(r.t_s + r.send_lag_s),
                    "rows": r.rows,
                    "status": r.status,
                    "latency_s": _round6(r.latency_s),
                    "send_lag_s": _round6(r.send_lag_s),
                    "retry_after_s": r.retry_after_s,
                    "model_key": r.model_key,
                    "trace_id": r.trace_id,
                }) + "\n")

    ok = [r for r in results if r.status == 200]
    ok_in_window = sum(1 for r in ok if r.t_s + r.latency_s <= span)
    shed = sum(1 for r in results if r.status == 429)
    unavailable = sum(1 for r in results if r.status == 503)
    client_error = sum(
        1 for r in results if 400 <= r.status < 500 and r.status != 429
    )
    server_error = sum(
        1 for r in results if r.status >= 500 and r.status != 503
    )
    transport_errors = sum(1 for r in results if r.status == 0) - timeouts
    ok_lat = sorted(r.latency_s for r in ok)
    lags = sorted(r.send_lag_s for r in results)
    with_retry = [r.retry_after_s for r in results
                  if r.retry_after_s is not None]
    # per-responding-model-key breakdown over OK responses: how a canary
    # sweep attributes latency/goodput per version ("unknown" = no
    # attribution header — e.g. a pre-canary server or custom transport)
    by_key: dict[str, list] = {}
    for r in ok:
        by_key.setdefault(r.model_key or "unknown", []).append(r)
    per_model_key = {}
    for key, rs in sorted(by_key.items()):
        key_lat = sorted(x.latency_s for x in rs)
        per_model_key[key] = {
            "ok": len(rs),
            "ok_in_window": sum(
                1 for x in rs if x.t_s + x.latency_s <= span
            ),
            "goodput_rps": round(len(rs) / span, 3),
            "latency": {
                "p50_s": _round6(_percentile(key_lat, 50)),
                "p99_s": _round6(_percentile(key_lat, 99)),
            },
        }
    report = LoadReport(
        requests=len(results),
        duration_s=round(span, 6),
        offered_rps=round(len(results) / span, 3),
        ok=len(ok),
        ok_in_window=ok_in_window,
        shed=shed,
        unavailable=unavailable,
        client_error=client_error,
        server_error=server_error,
        transport_errors=transport_errors,
        timeouts=timeouts,
        goodput_rps=round(len(ok) / span, 3),
        goodput_in_window_rps=round(ok_in_window / span, 3),
        shed_fraction=round(shed / len(results), 6),
        latency={
            "p50_s": _round6(_percentile(ok_lat, 50)),
            "p99_s": _round6(_percentile(ok_lat, 99)),
            "p999_s": _round6(_percentile(ok_lat, 99.9)),
        },
        retry_after={
            "responses": len(with_retry),
            "mean_s": _round6(sum(with_retry) / len(with_retry))
            if with_retry else None,
            "max_s": _round6(max(with_retry)) if with_retry else None,
        },
        send_lag_p99_s=_round6(_percentile(lags, 99)),
        max_in_flight=max_in_flight,
        max_blackout_s=_max_blackout_s(results),
        traced_responses=sum(1 for r in results if r.trace_id is not None),
        per_model_key=per_model_key,
        shards=shards,
    )
    log.info(
        f"open-loop run: offered {report.offered_rps:.0f} rps x "
        f"{report.duration_s:.1f}s -> goodput {report.goodput_rps:.0f} rps, "
        f"shed {report.shed_fraction:.1%}, "
        f"p99 {report.latency['p99_s']}s"
    )
    return report


def _round6(value: float | None) -> float | None:
    return round(value, 6) if value is not None else None


def _max_blackout_s(results: list) -> float:
    """Longest run of consecutive scheduled arrivals with zero 200s,
    as a time-span: from the first failed arrival's scheduled time to
    the scheduled time of the next 200 (or of the last arrival when the
    run never recovers). A lone failure between two successes scores
    the gap to the next success — a blackout is measured by how long
    the service was dark, not by how many arrivals fell into the hole.
    Returns 0.0 when every scheduled arrival got a 200.
    """
    worst = 0.0
    run_start: float | None = None
    for r in sorted(results, key=lambda x: x.t_s):
        if r.status == 200:
            if run_start is not None:
                worst = max(worst, r.t_s - run_start)
                run_start = None
        elif run_start is None:
            run_start = r.t_s
        last_t = r.t_s
    if run_start is not None:
        worst = max(worst, last_t - run_start)
    return round(worst, 6)


def format_report(report: LoadReport) -> str:
    """The CLI's stdout shape: one JSON document."""
    return json.dumps(report.to_dict(), indent=2)
