"""Online re-tune controller: the tuning loop closed against live traffic
(the port of ``bodywork_tpu.tune.online``: the same policy, decisions,
states, documents and metric names).

The offline tuner (``cli tune``) fits knobs from archived traces and an
operator applies them at the NEXT boot. That leaves the lifecycle loop
open exactly where the paper closes it for models: drift. A serving
process that boots into a uniform single-row workload and drifts into a
bursty wide-batch one is running knobs fitted for traffic that no
longer exists — and nobody re-runs the tuner, because re-running it
means noticing. This module is the noticing:

- :class:`OnlineTuneController` runs inside the reload-watcher loop
  (``serve/reload.py`` polls it right after the SLO watchdog — the two
  are siblings: one judges model releases, this one judges CONFIG
  releases). Each poll it ingests its watch logs INCREMENTALLY
  (byte-offset cursors, ``tune.collect.IngestCursor`` — O(new entries)
  per poll, counted on ``bodywork_tpu_tune_ingest_bytes_total``) into a
  sliding window of per-poll observation tables.
- **Drift detection** is a pure comparison of the merged window's
  arrival rate / row shape against the reference shape the ACTIVE
  config was fitted on. Past ``drift_threshold`` (with enough
  samples), the controller refits: ``fit_tuned_config`` over the
  merged window — priced by the learned cost model
  (``tune/costmodel.py``) wherever the window lacks probe evidence —
  writes the new document through the existing writer, records the
  apply in the config log (``registry/configlog.py``, ONE CAS), and
  applies the knobs MID-FLIGHT: coalescer window/max-rows mutate in
  place (``RequestCoalescer.reconfigure``), the admission budget is an
  attribute store, and a bucket-ladder change is a warmed predictor
  swap on the watcher's thread (its ``apply_bucket_ladder``): rungs
  already captured for the architecture rebind nothing and capture
  nothing, a new rung is captured there, never on a request.
- **Config-as-canary**: every applied config opens a guard window
  against the service-wide baseline captured at apply
  (``ops.slo.serve_window_snapshot``). A post-apply window that burns
  the error budget or regresses p99 past ``revert_p99_ratio`` is
  auto-reverted — previous knob values re-applied in place, the revert
  recorded in exactly ONE CAS, the flight recorder dumped as evidence
  (verdict ``config_revert``) — within ``verdict_polls`` polls, by the
  same verdict style the model watchdog uses. A healthy window
  graduates silently (no CAS: the log already says what is active).

Determinism: NOTHING in this module reads a clock or draws randomness —
poll decisions are pure functions of (window deltas, cursor state,
policy, seed), the property the no-wall-clock guard test pins
statically. "Time" only enters as the poll cadence the watcher imposes
and the timestamps already recorded in the logs it reads.
"""
from __future__ import annotations

import dataclasses
from datetime import date

from bodywork_tpu_torch.tune.collect import (
    IngestCursor,
    ObservationTable,
    ingest_request_log_incremental,
    ingest_results_log_incremental,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tune.online")

__all__ = [
    "MUTABLE_LIVE_KNOBS",
    "OnlineTunePolicy",
    "OnlineTuneController",
    "policy_from_env",
]

#: every knob the controller can mutate on a LIVE service — pinned
#: by tests/test_torch_online_tune.py (== the tuner's fittable knobs ==
#: validate_knobs' accepted keys == TUNED_KNOB_ENV): a knob the tuner
#: can fit but the controller cannot apply would silently partial-apply
#: every online refit
MUTABLE_LIVE_KNOBS = (
    "batch_window_ms",
    "batch_max_rows",
    "buckets",
    "max_pending",
)

#: bodywork_tpu_tune_online_state encoding
STATE_IDLE, STATE_GUARDING, STATE_REVERTED = 0.0, 1.0, 2.0


@dataclasses.dataclass
class OnlineTunePolicy:
    """The controller's knobs. Defaults are sized like the SLO
    watchdog's: decisive within seconds of a real shift under even
    light traffic, while the sample floors keep a handful of unlucky
    requests from triggering a refit or a revert."""

    #: merged-window interarrival samples required before the drift
    #: decision may fire (and before the reference shape is pinned)
    min_window_requests: int = 200
    #: relative change in arrival rate OR row-shape p90 vs the active
    #: config's reference shape that counts as drift
    drift_threshold: float = 0.5
    #: per-poll tables kept in the sliding window
    window_polls: int = 10
    #: polls to sit out after an apply/revert before the next drift
    #: decision (the new regime needs a window of its own evidence)
    cooldown_polls: int = 3
    #: the guard window's poll budget: a breach must fire within this
    #: many polls of an apply; surviving them healthy graduates
    verdict_polls: int = 6
    #: service-wide requests required in the post-apply window before a
    #: guard verdict may fire
    min_verdict_requests: int = 20
    #: guard breach: post-apply windowed error rate at/above this
    revert_error_rate: float = 0.02
    #: guard breach: post-apply p99 at/above this multiple of the
    #: pre-apply window's p99
    revert_p99_ratio: float = 2.0
    #: latency samples required on BOTH windows before the p99 verdict
    revert_min_latency_samples: int = 20
    #: recorded into every refit state dump; reserved for future
    #: sampled decisions — determinism demands it be pinned NOW so a
    #: replay of today's records stays bit-stable when it is used
    seed: int = 0

    def validate(self) -> None:
        if self.min_window_requests < 1:
            raise ValueError("min_window_requests must be >= 1")
        if self.drift_threshold <= 0.0:
            raise ValueError("drift_threshold must be > 0")
        if self.window_polls < 1:
            raise ValueError("window_polls must be >= 1")
        if self.cooldown_polls < 0:
            raise ValueError("cooldown_polls must be >= 0")
        if self.verdict_polls < 1:
            raise ValueError("verdict_polls must be >= 1")
        if self.min_verdict_requests < 1:
            raise ValueError("min_verdict_requests must be >= 1")
        if not 0.0 < self.revert_error_rate <= 1.0:
            raise ValueError("revert_error_rate must be in (0, 1]")
        if self.revert_p99_ratio <= 1.0:
            raise ValueError("revert_p99_ratio must be > 1")
        if self.revert_min_latency_samples < 1:
            raise ValueError("revert_min_latency_samples must be >= 1")


def policy_from_env() -> OnlineTunePolicy:
    """The deployed controller knobs from ``BODYWORK_TPU_TUNE_*`` env
    vars (the k8s serve Deployment materialises them —
    ``pipeline/k8s.py``), with the SLO policy's per-field degrade
    contract: a malformed or out-of-range value is warned and ignored,
    every other override survives, the pod never crashes on a typo."""
    import os

    policy = OnlineTunePolicy()
    for env_name, field, cast in (
        ("BODYWORK_TPU_TUNE_MIN_WINDOW_REQUESTS", "min_window_requests", int),
        ("BODYWORK_TPU_TUNE_DRIFT_THRESHOLD", "drift_threshold", float),
        ("BODYWORK_TPU_TUNE_COOLDOWN_POLLS", "cooldown_polls", int),
        ("BODYWORK_TPU_TUNE_VERDICT_POLLS", "verdict_polls", int),
        (
            "BODYWORK_TPU_TUNE_MIN_VERDICT_REQUESTS",
            "min_verdict_requests", int,
        ),
        ("BODYWORK_TPU_TUNE_REVERT_ERROR_RATE", "revert_error_rate", float),
        ("BODYWORK_TPU_TUNE_REVERT_P99_RATIO", "revert_p99_ratio", float),
    ):
        raw = os.environ.get(env_name, "").strip()
        if not raw:
            continue
        try:
            value = cast(raw)
        except ValueError:
            log.warning(f"ignoring {env_name}={raw!r} (malformed)")
            continue
        previous = getattr(policy, field)
        setattr(policy, field, value)
        try:
            policy.validate()
        except ValueError as exc:
            log.warning(f"ignoring {env_name}={raw!r} ({exc})")
            setattr(policy, field, previous)
    return policy


def _merge_window(tables) -> ObservationTable:
    """Fold the sliding window's per-poll tables into the one merged
    table a refit fits against. List evidence concatenates; the
    saturation measurement takes the max (it is a rate, the strongest
    observation wins)."""
    merged = ObservationTable()
    for t in tables:
        merged.interarrival_s.extend(t.interarrival_s)
        merged.row_counts.extend(t.row_counts)
        merged.latency_s.extend(t.latency_s)
        merged.queue_delay_s.extend(t.queue_delay_s)
        merged.dispatch_cost_s.update(t.dispatch_cost_s)
        if t.saturated_goodput_rps is not None:
            merged.saturated_goodput_rps = max(
                merged.saturated_goodput_rps or 0.0, t.saturated_goodput_rps
            )
        merged.sources.extend(t.sources)
    return merged


class OnlineTuneController:
    """Drift -> refit -> guarded apply -> (graduate | one-CAS revert).

    ``poll()`` is driven once per reload-watcher cycle (and directly by
    tests / the bench). The controller never blocks the request path:
    it reads logs and counters the serving threads write, and its two
    store writes (the tuned document, the config-log CAS) happen off
    the hot path inside the watcher thread.
    """

    def __init__(
        self,
        store,
        app,
        policy: OnlineTunePolicy | None = None,
        request_logs=(),
        results_logs=(),
        defaults: dict | None = None,
        cost_model_ref: str | None = "latest",
        apply_buckets=None,
    ):
        from pathlib import Path

        from bodywork_tpu_torch.obs import get_registry

        self.store = store
        self.app = app
        self.policy = policy or OnlineTunePolicy()
        self.policy.validate()
        self.request_logs = [Path(p) for p in request_logs]
        self.results_logs = [Path(p) for p in results_logs]
        self.defaults = defaults
        #: cost-model reference priced into every refit (None = off)
        self.cost_model_ref = cost_model_ref
        #: callable(tuple_of_buckets) applying a ladder change as a
        #: warmed predictor swap — the reload watcher wires its
        #: ``apply_bucket_ladder``; None skips ladder changes (counted)
        self.apply_buckets = apply_buckets
        self._cursors: dict = {}
        self._window: list = []
        #: the shape the active knobs were fitted for (None until the
        #: first adequate window pins it)
        self._reference: dict | None = None
        self._guard: dict | None = None
        self._cooldown = 0
        #: cumulative serve snapshot at boot / last verdict — the
        #: pre-apply window every guard baseline p99 is computed from
        self._anchor: dict | None = None
        self._last_state: dict = {"state": "idle"}
        reg = get_registry()
        self._g_state = reg.gauge(
            "bodywork_tpu_tune_online_state",
            "Online tune controller: 0=idle (watching for drift), "
            "1=guarding a freshly applied config, 2=reverted one this "
            "poll",
            aggregate="max",
        )
        self._g_drift = reg.gauge(
            "bodywork_tpu_tune_drift_ratio",
            "Observed traffic-shape drift vs the active config's "
            "reference shape (>= threshold refits)",
            aggregate="max",
        )
        self._m_refits = reg.counter(
            "bodywork_tpu_tune_online_refits_total",
            "Online refit attempts by outcome (applied, skipped_no_"
            "knobs=fit kept every default, skipped_conflict=lost the "
            "config-log CAS to a concurrent controller)",
        )
        self._m_reverts = reg.counter(
            "bodywork_tpu_tune_online_reverts_total",
            "Tuned configs auto-reverted by the guard verdict, by "
            "breach reason (error_budget|latency)",
        )
        self._g_state.set(STATE_IDLE)

    # -- state ---------------------------------------------------------------

    def state(self) -> dict:
        """The /healthz ``tuning`` block (also pushed onto the app
        every poll)."""
        return dict(self._last_state)

    def _publish(self, state: dict) -> None:
        state["seed"] = self.policy.seed
        self._last_state = state
        self.app.tune_state = dict(state)

    # -- ingestion -----------------------------------------------------------

    def _ingest(self) -> ObservationTable:
        """One poll's table: every complete line appended to a watch
        file since the last poll. A broken/missing file degrades to an
        empty contribution (warned once per failure) — the controller
        outlives its log files."""
        table = ObservationTable()
        for kind, paths, ingest in (
            ("request", self.request_logs, ingest_request_log_incremental),
            ("results", self.results_logs, ingest_results_log_incremental),
        ):
            for path in paths:
                cursor = self._cursors.get(path)
                try:
                    self._cursors[path] = ingest(
                        table, path, cursor or IngestCursor()
                    )
                except FileNotFoundError:
                    continue  # not written yet — normal before a drive
                except Exception as exc:  # torn/foreign file: skip poll
                    log.warning(f"{kind} log {path}: ingest failed: {exc!r}")
        self._window.append(table)
        if len(self._window) > self.policy.window_polls:
            self._window = self._window[-self.policy.window_polls:]
        return table

    # -- shape + drift -------------------------------------------------------

    @staticmethod
    def _shape(table: ObservationTable) -> dict | None:
        rate = table.arrival_rate_rps()
        rows = table.row_quantiles()
        if rate is None or rows is None:
            return None
        return {"arrival_rate_rps": rate, "row_p90": rows["p90"]}

    def _drift_ratio(self, shape: dict) -> float:
        ref = self._reference
        rate_drift = abs(shape["arrival_rate_rps"] - ref["arrival_rate_rps"]) / max(
            ref["arrival_rate_rps"], 1e-9
        )
        rows_drift = abs(shape["row_p90"] - ref["row_p90"]) / max(
            ref["row_p90"], 1.0
        )
        return max(rate_drift, rows_drift)

    # -- live knob application ----------------------------------------------

    def _live_knobs(self) -> dict:
        """The knob values currently live in the process — captured
        before an apply so a revert-to-boot restores exactly them."""
        cfg = self.app.effective_config()
        return {
            k: cfg.get(k) for k in MUTABLE_LIVE_KNOBS
            if cfg.get(k) is not None
        }

    def _apply_knobs(self, knobs: dict) -> dict:
        """Mutate the live service to ``knobs``; returns what was
        actually applied. Each knob that cannot be applied here (no
        coalescer/admission/ladder callback) is skipped with a warning
        — the config log still records the intent, and /healthz
        ``effective_config`` reads the live objects, so a partial
        apply is visible, never silent."""
        applied: dict = {}
        batcher = self.app.batcher
        window_ms = knobs.get("batch_window_ms")
        max_rows = knobs.get("batch_max_rows")
        if window_ms is not None or max_rows is not None:
            if batcher is not None and (window_ms is None or window_ms > 0):
                applied.update(batcher.reconfigure(
                    window_ms=window_ms, max_rows=max_rows,
                ))
            else:
                log.warning(
                    "skipping live coalescer knobs "
                    f"(window_ms={window_ms}, max_rows={max_rows}): "
                    + ("no coalescer is running" if batcher is None
                       else "0=off is a boot-time topology decision")
                )
        max_pending = knobs.get("max_pending")
        if max_pending is not None:
            admission = self.app.admission
            if admission is not None:
                admission.max_pending = int(max_pending)
                applied["max_pending"] = int(max_pending)
            else:
                log.warning(
                    f"skipping live max_pending={max_pending}: no "
                    "admission controller is armed"
                )
        buckets = knobs.get("buckets")
        if buckets is not None:
            current = self.app.effective_config().get("buckets")
            if current is not None and tuple(current) == tuple(buckets):
                pass  # same ladder: nothing to swap, zero device work
            elif self.apply_buckets is not None:
                try:
                    self.apply_buckets(tuple(buckets))
                    applied["buckets"] = list(buckets)
                except Exception as exc:
                    log.error(f"bucket-ladder apply failed: {exc!r}")
            else:
                log.warning(
                    "skipping bucket-ladder change: no apply_buckets "
                    "callback wired (watcher not attached)"
                )
        return applied

    # -- refit + guarded apply -----------------------------------------------

    def _config_day(self) -> date:
        """The date key for an online-written tuned document, WITHOUT
        reading a clock: the served model's date (the day whose traffic
        is being tuned for), falling back to the epoch for a dateless
        boot — the key is an address, the document's digest is its
        identity."""
        model_date = self.app.model_date
        if model_date:
            try:
                return date.fromisoformat(str(model_date))
            except ValueError:
                pass
        return date(1970, 1, 1)

    def _load_cost_model(self):
        if self.cost_model_ref is None:
            return None
        from bodywork_tpu_torch.tune.costmodel import load_cost_model

        doc, _digest = load_cost_model(self.store, self.cost_model_ref)
        return doc

    def _refit(self, merged: ObservationTable, shape: dict,
               drift: float) -> str | None:
        from bodywork_tpu_torch.tune.config import write_tuned_config
        from bodywork_tpu_torch.tune.model import fit_tuned_config

        doc = fit_tuned_config(
            merged, defaults=self.defaults,
            cost_model=self._load_cost_model(),
        )
        if not doc["knobs"]:
            log.info("drift refit kept every default; nothing to apply")
            self._m_refits.inc(outcome="skipped_no_knobs")
            self._reference = shape  # the new regime IS the reference now
            self._cooldown = self.policy.cooldown_polls
            return None
        key, digest = write_tuned_config(self.store, doc, day=self._config_day())
        reason = f"drift_refit(ratio={round(drift, 3)})"
        return self.apply_tuned(
            doc["knobs"], key, digest, reason=reason, shape=shape
        )

    def apply_tuned(self, knobs: dict, key: str, digest: str,
                    reason: str = "manual", shape: dict | None = None,
                    ) -> str | None:
        """Apply a tuned config to the LIVE service under guard: record
        it in the config log (ONE CAS), mutate the live knobs, open the
        guard window. The refit path calls this; so can an operator /
        the bench (that is how the sabotage acceptance injects its
        absurd config through the same machinery it expects to catch
        it)."""
        from bodywork_tpu_torch.ops.slo import (
            serve_window_delta,
            serve_window_snapshot,
        )
        from bodywork_tpu_torch.registry.configlog import (
            ConfigLogConflict,
            record_config_applied,
        )

        baseline = serve_window_snapshot()
        pre_window = (
            serve_window_delta(self._anchor, baseline)
            if self._anchor is not None else None
        )
        prior = self._live_knobs()
        baseline_summary = {
            "requests": baseline["requests"],
            "errors": baseline["errors"],
            "latency_samples": baseline["count"],
            "p99_s": pre_window["p99_s"] if pre_window else None,
            "pre_window_latency_samples": (
                pre_window["latency_samples"] if pre_window else 0
            ),
        }
        try:
            record_config_applied(
                self.store, key, digest, knobs,
                baseline=baseline_summary, reason=reason,
            )
        except ConfigLogConflict:
            log.warning(
                "config apply lost the config-log CAS; a concurrent "
                "controller acted — deferring to it"
            )
            self._m_refits.inc(outcome="skipped_conflict")
            self._cooldown = self.policy.cooldown_polls
            return None
        applied = self._apply_knobs(knobs)
        self.app.tuned_config_digest = digest
        self._guard = {
            "key": key,
            "digest": digest,
            "knobs": dict(knobs),
            "prior": prior,
            "baseline": baseline,
            "baseline_p99_s": baseline_summary["p99_s"],
            "baseline_latency_samples":
                baseline_summary["pre_window_latency_samples"],
            "polls": 0,
            "reason": reason,
        }
        if shape is not None:
            self._reference = shape
        self._m_refits.inc(outcome="applied")
        self._g_state.set(STATE_GUARDING)
        self._cooldown = self.policy.cooldown_polls
        log.info(
            f"tuned config applied LIVE ({digest[:23]}…, {reason}): "
            f"{applied} — guarding for {self.policy.verdict_polls} polls"
        )
        self._publish({
            "state": "guarding", "config": digest, "key": key,
            "applied": applied, "reason": reason, "polls": 0,
        })
        return "applied"

    # -- the guard window ----------------------------------------------------

    def _guard_verdict(self, window: dict) -> str | None:
        """The revert decision — a pure function of the post-apply
        window deltas and the guard's pinned baseline (no clocks, no
        RNG): same contract as ``SloPolicy.verdict``."""
        policy = self.policy
        if window["requests"] < policy.min_verdict_requests:
            return None
        if window["error_rate"] >= policy.revert_error_rate:
            return "error_budget"
        g = self._guard
        base_p99 = g.get("baseline_p99_s")
        if (
            base_p99
            and window["p99_s"] is not None
            and window["latency_samples"]
            >= policy.revert_min_latency_samples
            and g.get("baseline_latency_samples", 0)
            >= policy.revert_min_latency_samples
            and window["p99_s"] / base_p99 >= policy.revert_p99_ratio
        ):
            return "latency"
        return None

    def _dump_flight_record(self, reason: str, digest: str,
                            window: dict | None) -> str | None:
        """The revert's evidence: the tracer's ring of sampled request
        traces, dumped under ``obs/flightrec/`` with verdict
        ``config_revert`` — best-effort, never blocking the CAS."""
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
                verdict="config_revert",
                reason=reason,
                canary_key=f"tuned-config:{digest}",
                production_key=self.app.model_key,
                window=window,
                sampling={
                    "seed": tracer.seed,
                    "fraction": tracer.sample_fraction,
                },
            )
            key = write_flight_record(self.store, doc)
        except Exception as exc:  # noqa: BLE001 — evidence, not verdict
            log.error(f"config-revert flight-record dump failed: {exc!r}")
            return None
        from bodywork_tpu_torch.obs import get_registry

        get_registry().counter(
            "bodywork_tpu_flight_record_dumps_total",
            "Flight-recorder dumps written to obs/flightrec/ at "
            "watchdog verdicts, by verdict (abort|promote)",
        ).inc(verdict="config_revert")
        log.info(
            f"flight record: {doc['n_traces']} trace(s) -> {key} "
            f"(config_revert: {reason})"
        )
        return key

    def _revert(self, breach: str, window: dict) -> str:
        from bodywork_tpu_torch.registry.configlog import (
            ConfigLogConflict,
            record_config_reverted,
        )

        g = self._guard
        detail = (
            f"config guard breach: {breach} "
            f"(requests={window['requests']}, errors={window['errors']}, "
            f"p99_s={window['p99_s']}, "
            f"baseline_p99_s={g.get('baseline_p99_s')})"
        )
        log.error(
            f"tuned config {g['digest'][:23]}… BREACHED — "
            f"auto-reverting: {detail}"
        )
        # evidence first, so the ONE CAS can carry the dump key
        dump_key = self._dump_flight_record(detail, g["digest"], window)
        restored_entry = None
        try:
            restored_entry, _reverted = record_config_reverted(
                self.store, reason=detail, flight_record=dump_key,
            )
        except (ConfigLogConflict, ValueError) as exc:
            # a concurrent controller already reverted (or the log moved
            # under us): the in-process knobs still need restoring —
            # the local apply was ours
            log.warning(f"config-log revert not recorded here: {exc}")
        if restored_entry is not None:
            self._apply_knobs(restored_entry["knobs"])
            self.app.tuned_config_digest = restored_entry["digest"]
        else:
            self._apply_knobs(g["prior"])
            self.app.tuned_config_digest = None
        from bodywork_tpu_torch.ops.slo import serve_window_snapshot

        self._m_reverts.inc(reason=breach)
        self._g_state.set(STATE_REVERTED)
        self._guard = None
        self._cooldown = self.policy.cooldown_polls
        self._anchor = serve_window_snapshot()
        self._publish({
            "state": "reverted", "verdict": breach, "detail": detail,
            "config": g["digest"], "restored": (
                restored_entry["digest"] if restored_entry else None
            ),
            "flight_record": dump_key,
        })
        return "reverted"

    def _poll_guard(self) -> str | None:
        from bodywork_tpu_torch.ops.slo import (
            serve_window_delta,
            serve_window_snapshot,
        )

        g = self._guard
        g["polls"] += 1
        now = serve_window_snapshot()
        window = serve_window_delta(g["baseline"], now)
        breach = self._guard_verdict(window)
        if breach is not None:
            return self._revert(breach, window)
        if g["polls"] >= self.policy.verdict_polls:
            # survived the budget healthy: graduate. No CAS — the
            # config log already records it as active; the guard state
            # simply closes and the post-apply regime becomes the
            # anchor for the NEXT apply's baseline p99.
            log.info(
                f"tuned config {g['digest'][:23]}… survived its guard "
                f"window healthy ({window['requests']} requests)"
            )
            self._guard = None
            self._anchor = now
            self._g_state.set(STATE_IDLE)
            self._publish({
                "state": "idle", "graduated": g["digest"],
                "window": {
                    "requests": window["requests"],
                    "errors": window["errors"],
                    "p99_s": window["p99_s"],
                },
            })
            return "graduated"
        self._publish({
            "state": "guarding", "config": g["digest"],
            "polls": g["polls"],
            "window": {
                "requests": window["requests"],
                "errors": window["errors"],
                "p99_s": window["p99_s"],
            },
        })
        return None

    # -- the loop ------------------------------------------------------------

    def poll(self) -> str | None:
        """One controller cycle. Returns the action applied this poll
        (``"applied"`` | ``"reverted"`` | ``"graduated"``) or None."""
        from bodywork_tpu_torch.ops.slo import serve_window_snapshot

        if self._anchor is None:
            self._anchor = serve_window_snapshot()
        self._ingest()
        if self._guard is not None:
            return self._poll_guard()
        self._g_state.set(STATE_IDLE)
        if self._cooldown > 0:
            self._cooldown -= 1
            self._publish({"state": "idle", "cooldown": self._cooldown})
            return None
        merged = _merge_window(self._window)
        if len(merged.interarrival_s) < self.policy.min_window_requests:
            self._publish({
                "state": "idle",
                "window_samples": len(merged.interarrival_s),
            })
            return None
        shape = self._shape(merged)
        if shape is None:
            self._publish({"state": "idle", "window_samples": 0})
            return None
        if self._reference is None:
            # first adequate window: pin the reference, don't refit —
            # the knobs the service booted with were (presumably)
            # chosen for the shape it boots into
            self._reference = shape
            self._publish({"state": "idle", "reference": shape})
            return None
        drift = self._drift_ratio(shape)
        self._g_drift.set(drift)
        if drift < self.policy.drift_threshold:
            self._publish({
                "state": "idle", "drift_ratio": round(drift, 4),
            })
            return None
        log.info(
            f"traffic shape drifted {round(drift, 3)}x past threshold "
            f"{self.policy.drift_threshold} "
            f"(now {shape}, reference {self._reference}); refitting"
        )
        return self._refit(merged, shape, drift)
