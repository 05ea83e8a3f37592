"""SLO watchdog: the error-budget engine that closes the live release loop
(the port's copy of ``bodywork_tpu.ops.slo``: the same policy, verdicts,
metric names and flight-record documents, over the port's
``obs.registry``).

The registry gate adjudicates *offline* signals — but a model that passes
every offline gate can still degrade on real traffic: NaN or absurd
predictions under drifted inputs, latency blowups, error spikes. The
canary machinery (``registry`` canary slot + ``serve.app`` routing)
exposes a candidate to a seeded fraction of live traffic; THIS module is
the judge. It runs inside the reload-watcher loop
(:class:`~bodywork_tpu_torch.serve.reload.CheckpointWatcher`), reads the
per-model-key stream metrics the serving layer records into the obs
registry while a canary is live, and decides:

- **Abort** (breach): the canary is retired with ONE compare-and-swap of
  the alias document (:meth:`~bodywork_tpu_torch.registry.manager.
  ModelRegistry.canary_abort` — the same CAS primitive as the
  rollback), the lineage event records why, and in-process routing is
  cleared immediately — no operator, no pager, no second write.
- **Promote** (survived the window healthy): the canary graduates to
  production in one CAS and the already-warm canary bundle starts
  taking 100% of traffic in-process.

Breach signals (:class:`SloPolicy`), all computed over a sliding window
of the last ``window_requests`` canary requests — windowing is what
makes the burn rate a RATE (a canary must not be condemned forever for
one bad minute, nor saved by a long healthy prefix):

- **Error-budget burn** — the canary stream's windowed error rate
  divided by ``max_error_rate`` (the budget). Burn >= ``burn_rate_
  threshold`` with at least ``min_requests`` observed is a breach.
- **Sanity violations** — predictions the firewall caught (non-finite /
  outside the training-label band). More than
  ``max_sanity_violations`` in the window is an immediate breach: the
  firewall already kept the garbage off the wire, the watchdog's job is
  to stop paying for it.
- **p99 latency ratio** — canary windowed p99 over production windowed
  p99 (both from the same histogram family, measured on comparable
  traffic by construction of the hash router). Ratio >=
  ``max_p99_latency_ratio`` with ``min_latency_samples`` on each stream
  is a breach.

Determinism: verdicts are pure functions of the window's metric deltas
(:func:`SloPolicy.verdict`), so a seeded traffic replay reproduces the
same abort at the same poll — the property the canary chaos acceptance
(``chaos/canary.py``) pins.

Every verdict additionally ships its evidence: the tracer's in-process
flight recorder (``obs/tracing.py`` — the ring buffer of completed
sampled request traces) is dumped to the store under ``obs/flightrec/``
at each abort AND promote, so an auto-rollback arrives with the very
requests that convicted the canary (firewall-fallback child spans
included) and an auto-promote with the healthy window that acquitted
it. The dump key lands in the published watchdog state (``/healthz``
``watchdog.flight_record``), and ``cli trace show|tail|export`` reads
it. A dump failure is logged and swallowed — the CAS verdict must never
block on evidence I/O.

Metrics: ``bodywork_tpu_slo_watchdog_state`` (0 idle / 1 watching / 2
breached), ``bodywork_tpu_slo_burn_rate_ratio``,
``bodywork_tpu_slo_p99_latency_ratio``,
``bodywork_tpu_slo_breaches_total{reason}``,
``bodywork_tpu_slo_canary_promotions_total``,
``bodywork_tpu_flight_record_dumps_total{verdict}``.
"""
from __future__ import annotations

import dataclasses
import math

from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("ops.slo")

__all__ = [
    "SERVICE_LATENCY_METRIC",
    "SERVICE_REQUESTS_METRIC",
    "SloPolicy",
    "SloWatchdog",
    "histogram_quantile",
    "policy_from_env",
    "serve_window_snapshot",
    "serve_window_delta",
]

#: bodywork_tpu_slo_watchdog_state encoding
STATE_IDLE, STATE_WATCHING, STATE_BREACHED = 0.0, 1.0, 2.0

#: metric families the watchdog reads (written by serve.app while a
#: canary is live) — one place, so the reader and writer cannot drift
REQUESTS_METRIC = "bodywork_tpu_serve_model_requests_total"
ERRORS_METRIC = "bodywork_tpu_serve_model_errors_total"
LATENCY_METRIC = "bodywork_tpu_serve_model_latency_seconds"
VIOLATIONS_METRIC = "bodywork_tpu_serve_sanity_violations_total"

#: families the CONFIG guard reads (:func:`serve_window_snapshot`).
#: Deliberately NOT the per-stream families above: those are observed
#: only while a model canary is live (zero hot-path cost otherwise),
#: but a config change affects every request, always — so its guard
#: reads the always-on whole-service counters
SERVICE_REQUESTS_METRIC = "bodywork_tpu_http_requests_total"
SERVICE_LATENCY_METRIC = "bodywork_tpu_scoring_latency_seconds"


@dataclasses.dataclass
class SloPolicy:
    """The watchdog's knobs. Defaults are sized for the coalesced
    serving regime: a 200-request window judges a canary within seconds
    under even light production traffic, while ``min_requests`` keeps a
    handful of unlucky first requests from condemning it."""

    #: sliding evaluation window, in canary requests
    window_requests: int = 200
    #: canary requests observed before error/latency verdicts may fire
    min_requests: int = 25
    #: the error budget: tolerated windowed error rate on the canary
    max_error_rate: float = 0.02
    #: breach when windowed error rate >= threshold x budget
    burn_rate_threshold: float = 1.0
    #: breach when canary windowed p99 >= this multiple of production's
    max_p99_latency_ratio: float = 3.0
    #: latency samples required on EACH stream before the ratio fires.
    #: Calibrated live: nearest-rank p99 over a few dozen samples IS the
    #: window max, and one GIL-contention outlier on a loaded box read
    #: as a 4x "regression" — 100 samples puts p99 at the 99th value,
    #: not the worst
    min_latency_samples: int = 100
    #: consecutive polls the latency verdict must persist before it
    #: aborts: a one-poll spike is scheduling noise, a real latency
    #: regression is still there next poll (sanity and error-budget
    #: verdicts stay immediate — they are counts, not tail estimates)
    latency_breach_polls: int = 2
    #: sanity violations tolerated per window (0: any violation aborts)
    max_sanity_violations: int = 0
    #: canary requests a healthy canary must survive to auto-promote
    promote_after_requests: int = 200

    def validate(self) -> None:
        if self.window_requests < 1:
            raise ValueError("window_requests must be >= 1")
        if self.min_requests < 1:
            raise ValueError("min_requests must be >= 1")
        if not 0.0 < self.max_error_rate <= 1.0:
            raise ValueError("max_error_rate must be in (0, 1]")
        if self.burn_rate_threshold <= 0.0:
            raise ValueError("burn_rate_threshold must be > 0")
        if self.max_p99_latency_ratio <= 0.0:
            raise ValueError("max_p99_latency_ratio must be > 0")
        if self.min_latency_samples < 1:
            raise ValueError("min_latency_samples must be >= 1")
        if self.latency_breach_polls < 1:
            raise ValueError("latency_breach_polls must be >= 1")
        if self.max_sanity_violations < 0:
            raise ValueError("max_sanity_violations must be >= 0")
        if self.promote_after_requests < 1:
            raise ValueError("promote_after_requests must be >= 1")

    def verdict(self, window: dict) -> str | None:
        """The breach decision for one evaluation window — a pure
        function of the window's deltas (no clocks, no RNG), so seeded
        replays reproduce the same abort. ``window`` carries
        ``requests``, ``errors``, ``violations``, ``canary_p99_s``,
        ``production_p99_s``, ``canary_latency_samples``,
        ``production_latency_samples``. Returns the breach reason
        (``"sanity"`` | ``"error_budget"`` | ``"latency"``) or None."""
        if window.get("violations", 0) > self.max_sanity_violations:
            return "sanity"
        requests = window.get("requests", 0)
        if requests >= self.min_requests:
            error_rate = window.get("errors", 0) / max(requests, 1)
            if error_rate / self.max_error_rate >= self.burn_rate_threshold:
                return "error_budget"
        c_p99 = window.get("canary_p99_s")
        p_p99 = window.get("production_p99_s")
        if (
            c_p99 is not None
            and p_p99 is not None
            and p_p99 > 0.0
            and window.get("canary_latency_samples", 0)
            >= self.min_latency_samples
            and window.get("production_latency_samples", 0)
            >= self.min_latency_samples
            and c_p99 / p_p99 >= self.max_p99_latency_ratio
        ):
            return "latency"
        return None


def policy_from_env() -> SloPolicy:
    """The deployed watchdog knobs from the pod environment — a serve
    Deployment sets them as ``BODYWORK_TPU_SLO_*`` env vars (the JAX
    package's ``pipeline/k8s.py`` writes them) so an operator retunes the breach
    thresholds with a ``kubectl set env``, no image rebuild. Malformed
    values are ignored with a warning (the same contract as the serving
    engine knobs): a typo degrades to the default, never crashes the
    serving pod."""
    import os

    policy = SloPolicy()
    for env_name, field, cast, floor in (
        ("BODYWORK_TPU_SLO_WINDOW_REQUESTS", "window_requests", int, 1),
        ("BODYWORK_TPU_SLO_MIN_REQUESTS", "min_requests", int, 1),
        ("BODYWORK_TPU_SLO_MAX_ERROR_RATE", "max_error_rate", float, None),
        (
            "BODYWORK_TPU_SLO_MAX_P99_RATIO",
            "max_p99_latency_ratio", float, None,
        ),
        (
            "BODYWORK_TPU_SLO_MAX_SANITY_VIOLATIONS",
            "max_sanity_violations", int, 0,
        ),
        (
            "BODYWORK_TPU_SLO_PROMOTE_AFTER_REQUESTS",
            "promote_after_requests", int, 1,
        ),
    ):
        raw = os.environ.get(env_name, "").strip()
        if not raw:
            continue
        try:
            value = cast(raw)
            # floor None = strictly-positive float; else integer floor
            if (floor is None and value <= 0.0) or (
                floor is not None and value < floor
            ):
                raise ValueError(raw)
        except ValueError:
            log.warning(f"ignoring {env_name}={raw!r} (malformed or out of range)")
            continue
        # per-knob degrade contract: validate the FULL field range here,
        # so one out-of-range value (e.g. max_error_rate=1.5) reverts
        # only ITS field — the operator's other overrides must survive
        previous = getattr(policy, field)
        setattr(policy, field, value)
        try:
            policy.validate()
        except ValueError as exc:
            log.warning(f"ignoring {env_name}={raw!r} ({exc})")
            setattr(policy, field, previous)
    return policy


def histogram_quantile(bounds, bucket_counts, q: float) -> float | None:
    """Nearest-rank quantile over fixed-bucket histogram counts
    (``bucket_counts`` has ``len(bounds) + 1`` entries, the last being
    +Inf). Returns the upper bound of the bucket holding the target
    rank — the standard Prometheus-style conservative estimate — or
    None on an empty window."""
    total = sum(bucket_counts)
    if total <= 0:
        return None
    target = max(1, math.ceil(q * total))
    cumulative = 0
    for bound, n in zip(list(bounds) + [math.inf], bucket_counts):
        cumulative += n
        if cumulative >= target:
            return float(bound)
    return math.inf


def _sum_counter(name: str, **labels) -> float:
    """Sum a counter's samples whose labels are a superset match of
    ``labels`` (the violations counter carries an extra ``reason``
    label the watchdog aggregates over)."""
    from bodywork_tpu_torch.obs import get_registry

    metric = get_registry().get(name)
    if metric is None:
        return 0.0
    total = 0.0
    for sample in metric.snapshot_samples():
        if all(sample["labels"].get(k) == v for k, v in labels.items()):
            total += sample["value"]
    return total


def _hist_buckets(name: str, **labels):
    """``(bounds, bucket_counts, count)`` summed over matching samples;
    bucket_counts has the +Inf slot appended."""
    from bodywork_tpu_torch.obs import get_registry

    metric = get_registry().get(name)
    if metric is None:
        return (), [], 0
    bounds = list(getattr(metric, "buckets", ()))
    counts = [0] * (len(bounds) + 1)
    total = 0
    for sample in metric.snapshot_samples():
        if all(sample["labels"].get(k) == v for k, v in labels.items()):
            for i, n in enumerate(sample["buckets"]):
                counts[i] += n
            total += sample["count"]
    return bounds, counts, total


def serve_window_snapshot() -> dict:
    """Cumulative WHOLE-SERVICE serving counters: scoring requests,
    errors, and the success-latency histogram. The watchdog above
    judges one canary STREAM against another through the stream
    families (which only flow while a canary is live); a config change
    (tuned knobs going live, the JAX package's ``tune.online``) affects
    every request, always, so its guard reads the always-on families:
    ``bodywork_tpu_http_requests_total`` over the scoring routes and
    ``bodywork_tpu_scoring_latency_seconds``. An error here is a 5xx
    OR a 429 — a config that sheds traffic the previous config served
    (an absurd ``max_pending``) is exactly as reverted as one that
    crashes requests, and it leaves no latency samples to catch it
    otherwise."""
    from bodywork_tpu_torch.obs import get_registry

    requests = errors = 0.0
    metric = get_registry().get(SERVICE_REQUESTS_METRIC)
    if metric is not None:
        for sample in metric.snapshot_samples():
            labels = sample["labels"]
            if not labels.get("route", "").startswith("/score"):
                continue
            requests += sample["value"]
            status = labels.get("status", "")
            if status == "429" or status.startswith("5"):
                errors += sample["value"]
    bounds, buckets, count = _hist_buckets(SERVICE_LATENCY_METRIC)
    return {
        "requests": requests,
        "errors": errors,
        "bounds": bounds,
        "buckets": buckets,
        "count": count,
    }


def serve_window_delta(base: dict, now: dict) -> dict:
    """The service-wide window between two :func:`serve_window_snapshot`
    calls — a pure function of the two snapshots (no clocks, no RNG),
    the same determinism contract as :meth:`SloPolicy.verdict`. Returns
    ``requests``, ``errors``, ``error_rate``, ``p99_s`` (None on an
    empty window), and ``latency_samples``."""
    if len(base.get("buckets", [])) == len(now["buckets"]):
        delta_buckets = [
            b - a for a, b in zip(base["buckets"], now["buckets"])
        ]
    else:
        # the histogram family first appeared mid-window: the base has
        # no buckets to subtract, the cumulative counts ARE the delta
        delta_buckets = list(now["buckets"])
    requests = int(now["requests"] - base.get("requests", 0))
    errors = int(now["errors"] - base.get("errors", 0))
    return {
        "requests": requests,
        "errors": errors,
        "error_rate": errors / max(requests, 1),
        "p99_s": histogram_quantile(now["bounds"], delta_buckets, 0.99),
        "latency_samples": int(now["count"] - base.get("count", 0)),
    }


class SloWatchdog:
    """Watches the live canary from inside the reload-watcher loop.

    ``poll()`` is called once per watcher cycle (and directly by tests /
    the chaos acceptance): it snapshots the stream metrics, evaluates
    the policy over the sliding window, and applies the verdict through
    the registry — abort and promote are each ONE alias CAS. The
    watchdog holds no lock against the request path: it reads counters
    the serving threads write, and its registry mutations race other
    watchdogs safely (the CAS loser finds the slot already cleared)."""

    def __init__(self, store, apps, policy: SloPolicy | None = None,
                 registry=None):
        from bodywork_tpu_torch.obs import get_registry
        from bodywork_tpu_torch.registry import ModelRegistry

        self.store = store
        self.apps = list(apps) if isinstance(apps, (list, tuple)) else [apps]
        self.policy = policy or SloPolicy()
        self.policy.validate()
        self.manager = registry or ModelRegistry(store)
        #: the canary the current window belongs to + its baseline
        self._canary_key: str | None = None
        self._snapshots: list[dict] = []
        #: the canary stream's request count when this canary appeared —
        #: total-exposure floor for the auto-promote decision
        self._exposure_floor: float = 0.0
        #: consecutive polls the latency verdict has held (see
        #: SloPolicy.latency_breach_polls)
        self._latency_streak: int = 0
        self._last_state: dict = {"state": "idle"}
        reg = get_registry()
        self._g_state = reg.gauge(
            "bodywork_tpu_slo_watchdog_state",
            "SLO watchdog: 0=idle (no canary), 1=watching, 2=breached "
            "(abort applied this poll)",
            aggregate="max",
        )
        self._g_burn = reg.gauge(
            "bodywork_tpu_slo_burn_rate_ratio",
            "Canary windowed error rate over the error budget "
            "(>= threshold aborts)",
            aggregate="max",
        )
        self._g_p99_ratio = reg.gauge(
            "bodywork_tpu_slo_p99_latency_ratio",
            "Canary windowed p99 latency over production's",
            aggregate="max",
        )
        self._m_breaches = reg.counter(
            "bodywork_tpu_slo_breaches_total",
            "Canary SLO breaches by reason "
            "(sanity|error_budget|latency) — each one auto-aborted",
        )
        self._m_promotions = reg.counter(
            "bodywork_tpu_slo_canary_promotions_total",
            "Canaries auto-promoted after surviving their window healthy",
        )
        self._m_dumps = reg.counter(
            "bodywork_tpu_flight_record_dumps_total",
            "Flight-recorder dumps written to obs/flightrec/ at watchdog "
            "verdicts, by verdict (abort|promote)",
        )
        self._g_state.set(STATE_IDLE)

    # -- state -------------------------------------------------------------

    def state(self) -> dict:
        """The /healthz watchdog block (also pushed onto each app's
        ``slo_state`` every poll)."""
        return dict(self._last_state)

    def _publish(self, state: dict) -> None:
        self._last_state = state
        for app in self.apps:
            app.slo_state = dict(state)

    # -- metric snapshots --------------------------------------------------

    def _snapshot(self, canary_key: str, production_key: str) -> dict:
        c_bounds, c_buckets, c_count = _hist_buckets(
            LATENCY_METRIC, model_key=canary_key, stream="canary"
        )
        p_bounds, p_buckets, p_count = _hist_buckets(
            LATENCY_METRIC, model_key=production_key, stream="production"
        )
        return {
            # the baseline the production-stream numbers belong to: a
            # mid-canary production change (gate promote/rollback keeps
            # the slot live) must restart the window, or deltas would
            # subtract the OLD key's cumulative counts from the new
            # key's
            "production_key": production_key,
            "requests": _sum_counter(
                REQUESTS_METRIC, model_key=canary_key, stream="canary"
            ),
            "errors": _sum_counter(
                ERRORS_METRIC, model_key=canary_key, stream="canary"
            ),
            "violations": _sum_counter(
                VIOLATIONS_METRIC, model_key=canary_key, stream="canary"
            ),
            "canary_bounds": c_bounds,
            "canary_buckets": c_buckets,
            "canary_count": c_count,
            "production_bounds": p_bounds,
            "production_buckets": p_buckets,
            "production_count": p_count,
        }

    @staticmethod
    def _window_deltas(base: dict, now: dict) -> dict:
        """The sliding window's deltas between two snapshots — what the
        pure :meth:`SloPolicy.verdict` consumes."""
        canary_delta = [
            b - a for a, b in zip(base["canary_buckets"], now["canary_buckets"])
        ]
        production_delta = [
            b - a
            for a, b in zip(
                base["production_buckets"], now["production_buckets"]
            )
        ]
        return {
            "requests": int(now["requests"] - base["requests"]),
            "errors": int(now["errors"] - base["errors"]),
            "violations": int(now["violations"] - base["violations"]),
            "canary_p99_s": histogram_quantile(
                now["canary_bounds"], canary_delta, 0.99
            ),
            "production_p99_s": histogram_quantile(
                now["production_bounds"], production_delta, 0.99
            ),
            "canary_latency_samples": int(
                now["canary_count"] - base["canary_count"]
            ),
            "production_latency_samples": int(
                now["production_count"] - base["production_count"]
            ),
        }

    # -- the loop ----------------------------------------------------------

    def poll(self) -> str | None:
        """One watchdog cycle. Returns the action applied this poll:
        ``"abort"``, ``"promote"``, or None (idle/still watching).
        Exceptions never escape to the caller's loop beyond what the
        registry raises on a genuinely broken store."""
        app = self.apps[0]
        canary_key = app.canary_key
        if canary_key is None:
            if self._canary_key is not None:
                self._canary_key = None
                self._snapshots = []
            self._g_state.set(STATE_IDLE)
            self._publish({"state": "idle"})
            return None
        production_key = app.model_key or "unknown"
        snap = self._snapshot(canary_key, production_key)
        if canary_key != self._canary_key:
            # a new canary: this snapshot is the window's floor
            self._canary_key = canary_key
            self._snapshots = [snap]
            self._exposure_floor = snap["requests"]
            self._latency_streak = 0
            self._g_state.set(STATE_WATCHING)
            self._publish({
                "state": "watching", "canary_key": canary_key,
                "window": {"requests": 0},
            })
            return None
        if self._snapshots[-1].get("production_key") != production_key:
            # production moved under a live canary (gate promote /
            # rollback preserves the slot): the old snapshots' production
            # stream belongs to a different key — restart the breach
            # window on the new baseline (exposure keeps accumulating:
            # the canary-stream counters are unaffected). The append
            # below rebuilds the floor, so this poll's deltas are zero.
            log.info(
                "production baseline changed mid-canary "
                f"({self._snapshots[-1].get('production_key')} -> "
                f"{production_key}); restarting the breach window"
            )
            self._snapshots = []
            self._latency_streak = 0
        self._snapshots.append(snap)
        # slide: drop leading snapshots once the NEXT one still spans >=
        # window_requests — the base stays the oldest snapshot within
        # (or just beyond) the window
        while (
            len(self._snapshots) >= 2
            and snap["requests"] - self._snapshots[1]["requests"]
            >= self.policy.window_requests
        ):
            self._snapshots.pop(0)
        window = self._window_deltas(self._snapshots[0], snap)
        burn = (
            (window["errors"] / max(window["requests"], 1))
            / self.policy.max_error_rate
        )
        p99_ratio = None
        if (
            window["canary_p99_s"] is not None
            and window["production_p99_s"]
            and window["production_p99_s"] > 0.0
        ):
            p99_ratio = window["canary_p99_s"] / window["production_p99_s"]
        self._g_burn.set(burn)
        if p99_ratio is not None:
            self._g_p99_ratio.set(p99_ratio)
        reason = self.policy.verdict(window)
        state = {
            "state": "watching",
            "canary_key": canary_key,
            "window": {
                "requests": window["requests"],
                "errors": window["errors"],
                "violations": window["violations"],
                "burn_rate": round(burn, 6),
                "p99_ratio": (
                    round(p99_ratio, 6) if p99_ratio is not None else None
                ),
            },
        }
        breach_pending = False
        if reason == "latency":
            # a tail-estimate verdict must PERSIST before it aborts: one
            # poll's p99 spike is scheduling noise on a loaded box, a
            # real regression is still breaching next poll
            self._latency_streak += 1
            if self._latency_streak >= self.policy.latency_breach_polls:
                return self._abort(canary_key, reason, state, window)
            state["window"]["latency_breach_streak"] = self._latency_streak
            breach_pending = True  # mid-streak: promotion must wait too
            reason = None
        else:
            self._latency_streak = 0
        if reason is not None:
            return self._abort(canary_key, reason, state, window)
        # auto-promote reads TOTAL exposure since this canary appeared
        # (the sliding window above is for breach detection only): a
        # canary promotes once promote_after_requests landed on it with
        # no breach verdict outstanding — a mid-streak latency verdict
        # IS outstanding, so the promote defers to the next poll's
        # abort-or-clear decision
        exposure = int(snap["requests"] - self._exposure_floor)
        state["window"]["exposure"] = exposure
        if not breach_pending and exposure >= self.policy.promote_after_requests:
            return self._promote(canary_key, state)
        self._publish(state)
        return None

    def _dump_flight_record(self, verdict: str, reason: str,
                            canary_key: str, window: dict | None) -> str | None:
        """Persist the tracer's flight recorder at a verdict — each
        auto-rollback (and promote) ships the sampled request traces
        that decided it. Best-effort by design: evidence I/O must never
        block or fail the one-CAS verdict itself."""
        from bodywork_tpu_torch.obs.tracing import (
            flight_record_doc,
            get_tracer,
            write_flight_record,
        )

        tracer = get_tracer()
        if not tracer.enabled:
            return None
        try:
            doc = flight_record_doc(
                tracer.recorder.snapshot(),
                verdict=verdict,
                reason=reason,
                canary_key=canary_key,
                production_key=self.apps[0].model_key,
                window=window,
                sampling={
                    "seed": tracer.seed,
                    "fraction": tracer.sample_fraction,
                },
            )
            key = write_flight_record(self.store, doc)
        except Exception as exc:  # noqa: BLE001 — evidence, not verdict
            log.error(f"flight-record dump failed: {exc!r}")
            return None
        self._m_dumps.inc(verdict=verdict)
        log.info(
            f"flight record: {doc['n_traces']} trace(s) -> {key} "
            f"({verdict}: {reason})"
        )
        return key

    def _abort(self, canary_key: str, reason: str, state: dict,
               window: dict) -> str:
        """The breach action: ONE CAS retiring the canary + immediate
        in-process routing clear. Idempotent against concurrent
        watchdogs: a lost race means another worker already applied it."""
        from bodywork_tpu_torch.registry import PromotionConflict

        detail = (
            f"slo breach: {reason} "
            f"(requests={window['requests']}, errors={window['errors']}, "
            f"violations={window['violations']})"
        )
        log.error(f"canary {canary_key} BREACHED — auto-aborting: {detail}")
        try:
            self.manager.canary_abort(reason=detail)
        except PromotionConflict:
            log.warning("canary abort lost the alias race (already applied)")
        for app in self.apps:
            app.clear_canary()
        dump_key = self._dump_flight_record(
            "abort", reason, canary_key, state.get("window")
        )
        self._m_breaches.inc(reason=reason)
        self._g_state.set(STATE_BREACHED)
        self._canary_key = None
        self._snapshots = []
        self._publish({
            **state, "state": "breached", "verdict": reason,
            "detail": detail, "flight_record": dump_key,
        })
        return "abort"

    def _promote(self, canary_key: str, state: dict) -> str | None:
        """The healthy-window action: one CAS graduating the canary,
        then the already-warm bundle takes 100% in-process."""
        from bodywork_tpu_torch.registry import PromotionConflict, RegistryError

        log.info(
            f"canary {canary_key} survived its SLO window healthy — "
            "auto-promoting"
        )
        try:
            self.manager.canary_promote()
        except PromotionConflict:
            log.warning(
                "canary promotion lost the alias race; leaving routing "
                "for the next poll to reconcile"
            )
            return None
        except RegistryError as exc:
            # e.g. another watchdog already promoted (slot empty)
            log.warning(f"canary promotion not applied: {exc}")
            return None
        for app in self.apps:
            app.promote_canary_bundle()
        dump_key = self._dump_flight_record(
            "promote", "healthy window survived", canary_key,
            state.get("window"),
        )
        self._m_promotions.inc()
        self._g_state.set(STATE_IDLE)
        self._canary_key = None
        self._snapshots = []
        self._publish({
            **state, "state": "promoted", "verdict": "healthy",
            "flight_record": dump_key,
        })
        return "promote"
