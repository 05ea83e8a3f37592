"""Canary release-safety acceptance: sabotage the canary, prove the loop
(the port of ``bodywork_tpu.chaos.canary``; the same scenarios, checks
and summary).

The closed live-traffic release loop (canary routing + prediction-sanity
firewall + SLO watchdog) claims four things this module turns into a
seeded, reproducible PASS/FAIL:

1. A sabotaged canary — NaN weights in its checkpoint, or chaos-injected
   latency addressed to its stream — is auto-aborted via EXACTLY ONE
   compare-and-swap of the alias document, within the configured breach
   window (counted in requests).
2. Zero sanity-violating predictions are ever serialized: every response
   body a client received parses finite and inside the production
   model's training-label band.
3. The production stream is untouched throughout: every request the
   canary run answered from production is byte-identical to what a
   canary-free twin app answered for the same request, and the
   production checkpoint's bytes never change.
4. A healthy canary auto-promotes at window end, in one CAS.

Everything is a pure function of ``(seed, scenario, knobs)``: the
request stream is seeded, canary routing is a request hash, chaos
latency draws ride the fault plan's deterministic streams, and watchdog
verdicts are pure functions of windowed metric deltas — re-running a
scenario replays the identical abort at the identical poll
(``routing_digest`` in the summary pins it).

The port drives the app in-process through ``ScoringApp.handle`` (the
JAX harness uses werkzeug's test client; the request bodies are the same
bytes). The two trained checkpoints are linear models by default, as in
the JAX harness; ``model_type="mlp"`` with ``model_kwargs`` runs the
scenario on an MLP on ``device``, where the canary serves from the graph
cache's weight-slot lane beside production's, so neither stream rebinds
the other's weights.

Exposed as ``cli chaos canary --store DIR --scenario nan|latency|healthy``.
"""
from __future__ import annotations

import gc
import hashlib
import io
import json
from datetime import date, timedelta

import numpy as np

from bodywork_tpu_torch.store.base import ArtefactStore, DelegatingStore
from bodywork_tpu_torch.store.schema import REGISTRY_ALIAS_KEY
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("chaos.canary")

__all__ = ["CANARY_SCENARIOS", "run_canary_chaos", "sabotage_checkpoint_nan"]

#: the sabotage scenarios the acceptance run covers (cli choices pinned
#: to this by tests/test_canary.py)
CANARY_SCENARIOS = ("nan", "latency", "healthy")

#: fixed simulated start day — part of what makes (seed, scenario)
#: fully determine the run
_START_DAY = date(2026, 1, 1)


def sabotage_checkpoint_nan(store: ArtefactStore, key: str) -> None:
    """Overwrite every floating-point weight leaf of a checkpoint with
    NaN, in place — the stage-4 live-scoring failure mode (a model that
    passed every offline gate and then emits garbage on real traffic),
    injected at the artefact layer so the WHOLE serving path (load,
    warm, route, predict, firewall) runs against it."""
    data = store.get_bytes(key)
    with np.load(io.BytesIO(data)) as npz:
        arrays = {name: npz[name] for name in npz.files}
    for name, arr in arrays.items():
        if np.issubdtype(arr.dtype, np.floating):
            arrays[name] = np.full_like(arr, np.nan)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    store.put_bytes(key, buf.getvalue())
    log.warning(f"sabotaged checkpoint {key}: all float leaves -> NaN")


class _AliasCasCountingStore(DelegatingStore):
    """Counts CAS writes against the alias document — the witness that
    an auto-abort/promote is exactly ONE compare-and-swap."""

    def __init__(self, inner: ArtefactStore):
        super().__init__(inner)
        self.alias_cas_writes = 0

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        if key == REGISTRY_ALIAS_KEY:
            self.alias_cas_writes += 1
        return self._inner.put_bytes_if_match(key, data, expected_token)


def _seed_two_model_registry(store: ArtefactStore, samples_per_day: int,
                             model_type: str = "linear", model_kwargs=None,
                             device=None):
    """Two trained checkpoints on a fresh store: day 1's promoted to
    production, day 2's left a registered candidate (the canary-to-be).
    Returns ``(production_key, candidate_key)``."""
    from bodywork_tpu_torch.data import Dataset, generate_day, persist_dataset
    from bodywork_tpu_torch.data.drift_config import DriftConfig
    from bodywork_tpu_torch.registry import ModelRegistry
    from bodywork_tpu_torch.train import train_on_history

    drift = DriftConfig(n_samples=samples_per_day)
    keys = []
    for offset in (0, 1):
        day = _START_DAY + timedelta(days=offset)
        X, y = generate_day(day, drift, device=device)
        persist_dataset(store, Dataset(X, y, day))
        result = train_on_history(store, model_type, model_kwargs=model_kwargs,
                                  device=device)
        keys.append(result.model_artefact_key)
    production_key, candidate_key = keys
    ModelRegistry(store).promote(
        production_key, day=_START_DAY, reason="canary-chaos baseline"
    )
    return production_key, candidate_key


def _drive(
    app,
    twin_app,
    watcher,
    xs: np.ndarray,
    poll_every: int,
    bounds: tuple[float, float],
) -> dict:
    """Fire the seeded request stream at the canary'd app and its
    canary-free twin, polling the watcher (and therefore the SLO
    watchdog) every ``poll_every`` requests. Returns the per-request
    trace the checks below consume."""
    from bodywork_tpu_torch.serve.wire import MODEL_KEY_HEADER

    trace = {
        "bodies": [], "twin_bodies": [], "keys": [], "statuses": [],
        "violating_serialized": 0, "abort_at": None, "promote_at": None,
    }
    for i, x in enumerate(xs):
        payload = json.dumps({"X": [float(x)]}).encode()
        status, headers, body = app.handle("POST", "/score/v1", payload,
                                           "application/json")
        _twin_status, _twin_headers, twin_body = twin_app.handle(
            "POST", "/score/v1", payload, "application/json")
        trace["bodies"].append(body)
        trace["twin_bodies"].append(twin_body)
        trace["keys"].append(headers.get(MODEL_KEY_HEADER))
        trace["statuses"].append(status)
        if status == 200:
            prediction = json.loads(body)["prediction"]
            lo, hi = bounds
            if not np.isfinite(prediction) or not lo <= prediction <= hi:
                trace["violating_serialized"] += 1
        if (i + 1) % poll_every == 0:
            watcher.check_once()
            state = (app.slo_state or {}).get("state")
            if state == "breached" and trace["abort_at"] is None:
                trace["abort_at"] = i + 1
            if state == "promoted" and trace["promote_at"] is None:
                trace["promote_at"] = i + 1
    return trace


def run_canary_chaos(
    store: ArtefactStore,
    scenario: str = "nan",
    seed: int = 0,
    n_requests: int = 240,
    fraction: float = 0.35,
    samples_per_day: int = 96,
    poll_every: int = 20,
    policy=None,
    trace_fraction: float = 0.5,
    model_type: str = "linear",
    model_kwargs: dict | None = None,
    device=None,
) -> dict:
    """One seeded canary release-safety scenario against a FRESH store.
    Returns the acceptance summary (``summary["ok"]`` is the verdict);
    see the module docstring for what each scenario proves.

    The drive runs with request tracing configured at
    ``trace_fraction`` head sampling under the scenario's own seed
    (``obs/tracing.py``), so the watchdog's verdict ships a
    flight-recorder dump — the summary carries the dump key(s), the
    sampled trace ids (a pure function of (seed, request bytes):
    replays reproduce them), and how many sampled canary traces show
    the firewall-fallback child span. ``trace_fraction=0`` runs the
    scenario tracing-off, byte-identical by the header-only rule.

    ``model_type``/``model_kwargs`` pick the two checkpoints' model (the
    JAX harness's linear model by default), trained and served on
    ``device`` (the card unless asked for the CPU)."""
    from bodywork_tpu_torch.chaos.plan import FaultPlan, activate
    from bodywork_tpu_torch.models.checkpoint import load_model
    from bodywork_tpu_torch.obs.tracing import configured_tracing
    from bodywork_tpu_torch.ops.slo import SloPolicy, SloWatchdog
    from bodywork_tpu_torch.registry import ModelRegistry, read_aliases
    from bodywork_tpu_torch.registry.records import load_record
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.serve.app import as_bounds, create_app
    from bodywork_tpu_torch.serve.reload import CheckpointWatcher
    from bodywork_tpu_torch.serve.server import build_predictor

    if scenario not in CANARY_SCENARIOS:
        raise ValueError(
            f"unknown scenario {scenario!r}; expected one of "
            f"{CANARY_SCENARIOS}"
        )
    expected_exposure = n_requests * fraction
    if expected_exposure < 30:
        # too few canary-routed requests for ANY verdict to be
        # meaningful: the healthy scenario could never reach its promote
        # threshold and the verdict would report a release-loop FAILURE
        # when nothing is wrong — refuse up front with the fix
        raise ValueError(
            f"expected canary exposure {expected_exposure:.0f} requests "
            f"(= requests x fraction) is below 30; raise --requests or "
            "--fraction"
        )
    if store.list_keys(""):
        # a reused store replays against stale records/aliases (e.g. a
        # prior run's rejected candidate blocks canary_start) and the
        # PASS/FAIL verdict would measure debris, not the release loop
        raise ValueError(
            "canary chaos needs a FRESH store; the given one already "
            "holds artefacts"
        )
    device = resolve_device(device)
    production_key, candidate_key = _seed_two_model_registry(
        store, samples_per_day, model_type, model_kwargs, device
    )
    registry = ModelRegistry(store)
    registry.canary_start(
        candidate_key, fraction=fraction, seed=seed,
        day=_START_DAY + timedelta(days=1),
    )
    if scenario == "nan":
        sabotage_checkpoint_nan(store, candidate_key)
    production_bytes_before = store.get_bytes(production_key)

    if policy is None:
        # scale the watchdog to the run: the breach window is a third of
        # the offered requests, so "auto-aborts within the window" is a
        # real bound, not vacuously the whole run; the promote threshold
        # sits at 60% of the EXPECTED canary exposure (>= 18 given the
        # exposure floor above) so routing variance cannot starve the
        # healthy scenario at ANY allowed fraction
        window = max(30, n_requests // 3)
        policy = SloPolicy(
            window_requests=window,
            min_requests=10,
            min_latency_samples=8,
            max_p99_latency_ratio=3.0,
            promote_after_requests=max(10, int(expected_exposure * 0.6)),
        )

    # production serving app + its canary-free twin (the twin shares the
    # warmed predictor — read-only — so the comparison isolates ROUTING,
    # not compile noise)
    model, model_date = load_model(store, production_key, device=device)
    production_record = load_record(store, production_key) or {}
    bounds_doc = production_record.get("prediction_bounds")
    app = create_app(
        model, model_date, predictor=build_predictor(model, "auto", buckets=(1,)),
        warmup=True, model_key=production_key, model_source="production",
        model_bounds=bounds_doc,
    )
    twin_app = create_app(
        model, model_date, predictor=app.predictor, warmup=False,
        model_key=production_key, model_source="production",
        model_bounds=bounds_doc,
    )
    # all registry mutations from here on ride the counting wrapper: the
    # one-CAS claim is counted, not assumed
    counting = _AliasCasCountingStore(store)
    watchdog = SloWatchdog(counting, [app], policy=policy)
    watcher = CheckpointWatcher(
        app, counting, poll_interval_s=3600.0, engine="auto",
        served_key=production_key, buckets=(1,), slo_watchdog=watchdog,
        device=device,
    )
    watcher.check_once()  # loads + warms the canary, arms the watchdog

    rng = np.random.default_rng(seed)
    xs = rng.uniform(0.0, 100.0, n_requests)
    # routing is a pure request hash, so the harness can know — without
    # any server cooperation — which requests ROUTED to the canary (the
    # answering header says production after a firewall fallback): the
    # abort budget below is counted in canary-routed requests, the same
    # unit the watchdog's breach window uses
    from bodywork_tpu_torch.serve.app import routes_to_canary

    routed_to_canary = [
        routes_to_canary(seed, fraction, np.asarray([x], dtype=np.float32))
        for x in xs
    ]
    bounds = as_bounds(bounds_doc) or (-np.inf, np.inf)
    plan = FaultPlan(seed=seed, canary_latency_p=1.0, canary_latency_s=0.05)
    # the watchdog judges the drive's request latencies: collect and
    # freeze the heap first, so no cyclic collection of what the process
    # built before (a full one takes milliseconds in a process holding
    # torch) lands inside a request and stands in the window as that
    # stream's latency; the drive's own garbage is still collected
    gc.collect()
    gc.freeze()
    try:
        # the drive (and the final reconcile poll — the watchdog's dump
        # must see the tracer's recorder) runs under scoped tracing config
        with configured_tracing(trace_fraction, seed=seed):
            if scenario == "latency":
                with activate(plan):
                    trace = _drive(app, twin_app, watcher, xs, poll_every, bounds)
            else:
                trace = _drive(app, twin_app, watcher, xs, poll_every, bounds)
            watcher.check_once()  # final reconcile (covers n % poll_every != 0)
    finally:
        gc.unfreeze()
    state = (app.slo_state or {}).get("state")
    if state == "breached" and trace["abort_at"] is None:
        trace["abort_at"] = n_requests
    if state == "promoted" and trace["promote_at"] is None:
        trace["promote_at"] = n_requests

    # -- the checks --------------------------------------------------------
    doc = read_aliases(store) or {}
    record = load_record(store, candidate_key) or {}
    production_compared = production_mismatched = 0
    compare_until = (
        trace["promote_at"] if trace["promote_at"] is not None else n_requests
    )
    for i in range(min(compare_until, n_requests)):
        if trace["keys"][i] == production_key:
            production_compared += 1
            if trace["bodies"][i] != trace["twin_bodies"][i]:
                production_mismatched += 1
    routing_digest = hashlib.sha256(
        b"|".join(
            (k or "none").encode() + b":" + str(s).encode()
            for k, s in zip(trace["keys"], trace["statuses"])
        )
    ).hexdigest()
    # flight-recorder evidence: the verdict's dump(s)
    # under obs/flightrec/, the sampled trace ids (deterministic from
    # (seed, request bytes) — a replay reproduces this exact set), and
    # how many sampled canary-routed traces carry the firewall-fallback
    # child span (the NaN scenario's per-request proof that production
    # answered for the sabotaged canary)
    from bodywork_tpu_torch.obs.tracing import iter_flight_records

    flight_records = list(iter_flight_records(store))
    sampled_trace_ids: set[str] = set()
    fallback_span_traces = 0
    for _key, flight_doc in flight_records:
        for t in flight_doc["traces"]:
            sampled_trace_ids.add(t["trace_id"])
            if (t.get("meta") or {}).get("stream") == "canary" and any(
                s["name"] == "firewall-fallback" for s in t["spans"]
            ):
                fallback_span_traces += 1
    summary = {
        "scenario": scenario,
        "seed": seed,
        "n_requests": n_requests,
        "fraction": fraction,
        "window_requests": policy.window_requests,
        "production_key": production_key,
        "canary_key": candidate_key,
        "aborted": doc.get("last_op") == "canary_abort",
        "promoted": doc.get("production") == candidate_key
        and doc.get("last_op") == "canary_promote",
        "abort_at_request": trace["abort_at"],
        "promote_at_request": trace["promote_at"],
        "alias_cas_writes": counting.alias_cas_writes,
        "violating_responses_serialized": trace["violating_serialized"],
        "production_responses_compared": production_compared,
        "production_responses_mismatched": production_mismatched,
        "production_checkpoint_byte_identical": (
            store.get_bytes(production_key) == production_bytes_before
        ),
        "canary_record_status": record.get("status"),
        "routing_digest": routing_digest,
        "trace_fraction": trace_fraction,
        "flight_record_keys": [k for k, _d in flight_records],
        "sampled_trace_ids": sorted(sampled_trace_ids),
        "fallback_span_traces": fallback_span_traces,
    }
    # budget: the breach must land within one window of CANARY-ROUTED
    # requests past the point the canary went live (plus one poll of
    # slack) — the same unit the watchdog's breach window slides by, so
    # the bound stays meaningful at any --fraction
    canary_routed_at_abort = (
        sum(routed_to_canary[: trace["abort_at"]])
        if trace["abort_at"] is not None else None
    )
    summary["canary_routed_at_abort"] = canary_routed_at_abort
    budget = policy.window_requests + poll_every
    if scenario in ("nan", "latency"):
        summary["ok"] = bool(
            summary["aborted"]
            and not summary["promoted"]
            and canary_routed_at_abort is not None
            and canary_routed_at_abort <= budget
            and summary["alias_cas_writes"] == 1
            and summary["violating_responses_serialized"] == 0
            and production_mismatched == 0
            and summary["production_checkpoint_byte_identical"]
            and record.get("status") == "rejected"
        )
    else:  # healthy
        summary["ok"] = bool(
            summary["promoted"]
            and not summary["aborted"]
            and summary["alias_cas_writes"] == 1
            and summary["violating_responses_serialized"] == 0
            and production_mismatched == 0
            and summary["production_checkpoint_byte_identical"]
            and record.get("status") == "production"
        )
    app.close()
    twin_app.close()
    verdict = "PASS" if summary["ok"] else "FAIL"
    log.info(
        f"canary chaos [{scenario}] {verdict}: aborted={summary['aborted']} "
        f"promoted={summary['promoted']} cas={summary['alias_cas_writes']} "
        f"violations_serialized={summary['violating_responses_serialized']}"
    )
    return summary
