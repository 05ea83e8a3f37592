"""The cost model: one observation table -> a tuned serving config (the
port of ``bodywork_tpu.tune.model``: the same decisions, bases, metric
names and document bytes for the same table).

An analytical-plus-fitted hybrid in the spirit of "A Learned Performance
Model for Tensor Processing Units" (PAPERS.md): where a clean queueing
argument exists the knob is solved in closed form over MEASURED inputs
(arrival rate, per-bucket dispatch cost, saturated service rate), and
where the input is a distribution the knob is fitted to its observed
quantiles (the padding-bucket ladder over the offered row shapes). No
knob is ever guessed: a knob whose evidence is missing keeps its
hand-set default, and the decision trace says so.

Per-knob models (each decision records chosen vs default + its basis):

- ``batch_max_rows`` — the smallest measured bucket achieving
  :data:`THROUGHPUT_KNEE` of the cost curve's peak rows/s. Beyond the
  knee, bigger flushes add latency linearly while adding throughput
  sublinearly; at it, a full flush pads to exactly one compiled shape.
- ``batch_window_ms`` — the coalescer window is worth holding requests
  for only while (a) the measured arrival rate can actually FILL a
  batch within it and (b) the wait it adds is commensurate with the
  dispatch cost it amortises. Window = ``WINDOW_DISPATCH_MULTIPLE`` x
  the measured dispatch cost at the chosen flush size, clamped to
  [:data:`MIN_WINDOW_MS`, :data:`MAX_WINDOW_MS`] — and set to ``0.0``
  (coalescing OFF, direct per-request dispatch) when the expected
  arrivals per maximum window (``rate x MAX_WINDOW``) cannot reach
  :data:`MIN_FILL_ROWS`: a window sparse traffic cannot fill is pure
  latency tax, and on a small box the dispatcher thread's sub-ms
  wakeups are themselves measurable tail cost (the profile-1
  regression the bench measures).
- ``buckets`` — the ladder is fitted to the offered row-shape
  quantiles: next-power-of-two covers of {1, p50, p90, p99, max} (plus
  the flush size, so a full coalesced batch pads to a compiled shape).
  The hand-set ladder pads a 700-row request to 4096; the fitted one
  stops at its 1024 cover — 4x less wasted compute per dispatch.
- ``max_pending`` — Little's-law sizing of the admission budget: the
  queue the service should HOLD is the work it can clear within the
  queue-delay budget, ``service_rate x QUEUE_BUDGET_S`` (clamped).
  Requires a MEASURED service rate (a saturated drive's goodput, or
  the scoring-latency inverse as the closed-loop proxy); without one
  the budget keeps its default — a guessed budget is how SLOs die.

Every decision is exported through obs
(``bodywork_tpu_tune_decisions_total{knob,source}``) and, when a span
recorder is passed, as one span per knob with chosen-vs-default meta —
the decision trace ``cli tune --trace-out`` renders and the tuned
document embeds.
"""
from __future__ import annotations

import math

from bodywork_tpu_torch.tune.collect import ObservationTable
from bodywork_tpu_torch.tune.config import KNOB_DEFAULTS, validate_knobs
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tune.model")

__all__ = [
    "MAX_WINDOW_MS",
    "MIN_WINDOW_MS",
    "QUEUE_BUDGET_S",
    "THROUGHPUT_KNEE",
    "fit_tuned_config",
]

#: window clamp: below ~0.3 ms the dispatcher's own wakeup jitter
#: dominates; above ~10 ms the window is a visible latency tax on every
#: idle-service request
MIN_WINDOW_MS = 0.3
MAX_WINDOW_MS = 10.0
#: the window pays when it can assemble at least this many rows
MIN_FILL_ROWS = 2.0
#: window as a multiple of the measured per-dispatch cost it amortises
WINDOW_DISPATCH_MULTIPLE = 4.0
#: batch_max_rows knee: smallest bucket at >= this fraction of the cost
#: curve's peak throughput
THROUGHPUT_KNEE = 0.7
#: admission sizing: the queue the service may hold is what it can
#: clear in this many seconds (the queue-delay budget a shed's
#: Retry-After is honest about)
QUEUE_BUDGET_S = 0.25
#: admission budget clamp (a tiny budget sheds healthy bursts; a huge
#: one recreates the unbounded queue admission exists to prevent)
MIN_MAX_PENDING = 32
MAX_MAX_PENDING = 4096

#: candidate ladder rungs: powers of two (the compiled-shape-count
#: argument for the hand-set ladder, kept)
_MAX_BUCKET = 4096


def _pow2_cover(n: int) -> int:
    """The smallest power of two >= n (the padded shape covering n)."""
    return 1 if n <= 1 else 2 ** math.ceil(math.log2(n))


def _count_decision(knob: str, source: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_tune_decisions_total",
        "Tuner knob decisions by knob and source (fitted=model chose "
        "from evidence, default=evidence missing, kept default)",
    ).inc(knob=knob, source=source)


def _decide_max_rows(table: ObservationTable, default: int) -> dict:
    curve = table.dispatch_cost_s
    if not curve:
        return {
            "knob": "batch_max_rows", "chosen": default, "default": default,
            "source": "default",
            "basis": "no measured dispatch-cost curve",
        }
    throughput = {
        b: (b / c if c > 0 else 0.0) for b, c in curve.items() if b >= 1
    }
    peak = max(throughput.values())
    knee = min(
        b for b, t in sorted(throughput.items())
        if t >= THROUGHPUT_KNEE * peak
    )
    chosen = max(8, min(512, knee))
    return {
        "knob": "batch_max_rows", "chosen": chosen, "default": default,
        "source": "fitted",
        "basis": (
            f"smallest measured bucket at >={THROUGHPUT_KNEE:.0%} of peak "
            f"dispatch throughput (knee={knee} rows, peak="
            f"{peak:.0f} rows/s), clamped to [8, 512]"
        ),
        "evidence": {
            "throughput_rows_per_s": {
                str(b): round(t, 1) for b, t in sorted(throughput.items())
            },
        },
    }


def _decide_window(table: ObservationTable, default: float,
                   max_rows: int) -> dict:
    rate = table.arrival_rate_rps()
    curve = table.dispatch_cost_s
    if rate is None:
        return {
            "knob": "batch_window_ms", "chosen": default, "default": default,
            "source": "default",
            "basis": "no measured arrival process",
        }
    fill_at_max = rate * (MAX_WINDOW_MS / 1e3)
    if fill_at_max < MIN_FILL_ROWS:
        chosen = 0.0
        basis = (
            f"measured arrival rate {rate:.1f} rps cannot assemble "
            f"{MIN_FILL_ROWS:.0f} rows within the {MAX_WINDOW_MS:.0f} ms "
            f"window cap (expected fill {fill_at_max:.2f}); the window "
            "— and the dispatcher thread's wakeups — is pure latency "
            "tax at this rate, so coalescing is DISABLED (0 = off, "
            "direct per-request dispatch)"
        )
    else:
        # the window is worth the dispatch cost it amortises: hold for
        # a few dispatch-times, bounded by what the arrival rate fills
        flush_cost_s = None
        if curve:
            cover = min(
                (b for b in curve if b >= max_rows), default=max(curve)
            )
            flush_cost_s = curve[cover]
        window_s = (
            WINDOW_DISPATCH_MULTIPLE * flush_cost_s
            if flush_cost_s is not None
            else max_rows / (4.0 * rate)
        )
        fill_bound_s = max_rows / rate  # past this the batch is full anyway
        chosen = min(window_s, fill_bound_s) * 1e3
        chosen = min(max(chosen, MIN_WINDOW_MS), MAX_WINDOW_MS)
        basis = (
            f"{WINDOW_DISPATCH_MULTIPLE:.0f}x the measured "
            f"{(flush_cost_s or 0) * 1e3:.2f} ms flush-size dispatch "
            f"cost, capped by the {max_rows}-row fill time at "
            f"{rate:.0f} rps, clamped to "
            f"[{MIN_WINDOW_MS}, {MAX_WINDOW_MS}] ms"
        )
    chosen = round(chosen, 3)
    return {
        "knob": "batch_window_ms", "chosen": chosen, "default": default,
        "source": "fitted", "basis": basis,
        "evidence": {
            "arrival_rate_rps": round(rate, 2),
            "expected_fill_at_cap": round(fill_at_max, 3),
        },
    }


def _decide_buckets(table: ObservationTable, default: tuple,
                    max_rows: int, coalescing_on: bool) -> dict:
    shape = table.row_quantiles()
    if shape is None:
        return {
            "knob": "buckets", "chosen": list(default),
            "default": list(default), "source": "default",
            "basis": "no observed row-shape distribution",
        }
    rungs = {1}
    for q in ("p50", "p90", "p99", "max"):
        rungs.add(min(_pow2_cover(shape[q]), _MAX_BUCKET))
    if coalescing_on:
        # coalesced flushes take EVERY size from 1 to max_rows, not
        # just the offered per-request shapes: without intermediate
        # rungs a 5-row flush pads to the flush-size cover — the exact
        # padding waste the ladder exists to avoid (found empirically:
        # a {1, 512} ladder under moderate coalesced load inflated
        # per-flush compute ~100x)
        flush_cover = _pow2_cover(max_rows)
        rungs.add(flush_cover)
        rungs.update(b for b in (8, 64) if b < flush_cover)
    chosen = tuple(sorted(rungs))[:8]
    basis = (
        "power-of-two covers of the observed row-shape quantiles "
        f"(p50={shape['p50']}, p90={shape['p90']}, "
        f"p99={shape['p99']}, max={shape['max']} over "
        f"{shape['n']} requests)"
    )
    if coalescing_on:
        basis += (
            " plus the geometric coalesced-flush ladder up to the "
            "flush size (flushes take every size from 1 to max_rows)"
        )
    basis += f" — the largest rung is the max cover, not {max(default)}"
    return {
        "knob": "buckets", "chosen": list(chosen),
        "default": list(default), "source": "fitted",
        "basis": basis,
        "evidence": {"row_shape": shape},
    }


def _decide_max_pending(table: ObservationTable, default: int) -> dict:
    service = table.service_rate_rps()
    if service is None:
        return {
            "knob": "max_pending", "chosen": default, "default": default,
            "source": "default",
            "basis": "no measured service rate (no saturated drive, no "
                     "scoring-latency evidence)",
        }
    chosen = int(
        min(max(round(service * QUEUE_BUDGET_S), MIN_MAX_PENDING),
            MAX_MAX_PENDING)
    )
    measured_how = (
        "saturated-drive goodput"
        if table.saturated_goodput_rps is not None
        else "inverse mean scoring latency"
    )
    return {
        "knob": "max_pending", "chosen": chosen, "default": default,
        "source": "fitted",
        "basis": (
            f"Little's law over the measured service rate "
            f"({service:.0f} rps by {measured_how}) x the "
            f"{QUEUE_BUDGET_S}s queue-delay budget, clamped to "
            f"[{MIN_MAX_PENDING}, {MAX_MAX_PENDING}]"
        ),
        "evidence": {
            "service_rate_rps": round(service, 1),
            "queue_budget_s": QUEUE_BUDGET_S,
        },
    }


def _price_unprobed_rungs(table: ObservationTable, cost_model: dict):
    """Augment the measured dispatch-cost curve with LEARNED prices for
    every candidate power-of-two rung the probe never timed
    (``tune/costmodel.py``) — measured entries always win. Returns
    ``(augmented_table, provenance)`` without mutating the caller's
    table; provenance (model digest + priced rungs + the model's own
    held-out error bound) rides the tuned document so an audit can see
    exactly which decisions leaned on extrapolation."""
    import dataclasses as _dc

    from bodywork_tpu_torch.tune.costmodel import predict_cost

    samples = cost_model.get("samples") or []
    if not samples:
        return table, None

    def _majority(field, default):
        counts: dict = {}
        for s in samples:
            v = s.get(field, default)
            counts[v] = counts.get(v, 0) + 1
        return max(counts.items(), key=lambda kv: (kv[1], str(kv[0])))[0]

    n_features = int(_majority("n_features", 1))
    dtype = str(_majority("dtype", "float32"))
    mesh = int(_majority("mesh_devices", 1))
    candidates = [2 ** i for i in range(int(math.log2(_MAX_BUCKET)) + 1)]
    priced = {
        b: predict_cost(cost_model, b, n_features, dtype, mesh)
        for b in candidates if b not in table.dispatch_cost_s
    }
    provenance = {
        "digest": cost_model.get("doc_digest"),
        "priced_buckets": sorted(priced),
        "measured_buckets": sorted(table.dispatch_cost_s),
        "holdout": cost_model.get("holdout"),
    }
    if not priced:
        return table, provenance
    augmented = _dc.replace(
        table,
        dispatch_cost_s={**priced, **table.dispatch_cost_s},
        sources=list(table.sources) + ["cost_model"],
    )
    return augmented, provenance


def fit_tuned_config(
    table: ObservationTable,
    defaults: dict | None = None,
    recorder=None,
    cost_model: dict | None = None,
) -> dict:
    """Fit every knob from ``table``; returns the tuned-config document
    body (knobs + decision trace + observation summary — the writer
    stamps schema and digest). A PURE function of the table: the same
    observations always produce the same config, which is what makes a
    tune replayable from archived traces.

    ``recorder`` (an ``obs.spans.SpanRecorder``) gets one span per knob
    with chosen-vs-default meta — the decision trace ``cli tune
    --trace-out`` renders through the existing Chrome emitter.

    ``cost_model`` (a loaded ``tune.costmodel`` document) prices the
    candidate ladder rungs the probe never measured, so the knee and
    window decisions see the FULL power-of-two curve instead of
    degrading wherever the probe was thin; the document records which
    rungs were priced vs measured (still a pure function — of the table
    AND the model document)."""
    defaults = {**KNOB_DEFAULTS, **(defaults or {})}
    cost_model_provenance = None
    if cost_model is not None:
        table, cost_model_provenance = _price_unprobed_rungs(
            table, cost_model
        )
    max_rows_decision = _decide_max_rows(table, defaults["batch_max_rows"])
    max_rows = max_rows_decision["chosen"]
    window_decision = _decide_window(
        table, defaults["batch_window_ms"], max_rows
    )
    decisions = [
        max_rows_decision,
        window_decision,
        _decide_buckets(
            table, tuple(defaults["buckets"]), max_rows,
            # the ladder must cover coalesced flush sizes whenever the
            # served config coalesces — fitted OR default window > 0
            coalescing_on=window_decision["chosen"] > 0,
        ),
        _decide_max_pending(table, defaults["max_pending"]),
    ]
    # ONLY fitted knobs enter the document: for the window and the
    # admission budget the default VALUE is not the default BEHAVIOUR
    # (a bare boot leaves coalescing off and thread-engine admission
    # unarmed) — writing a default-sourced 2.0 ms / 512 would turn
    # both ON the moment the document is applied, which is exactly the
    # "knob whose evidence is missing keeps its hand-set default"
    # contract violated. The decision trace still records every kept
    # default.
    knobs = {
        d["knob"]: d["chosen"] for d in decisions if d["source"] == "fitted"
    }
    accepted, rejected = validate_knobs(knobs)
    assert not rejected, f"cost model produced invalid knob(s): {rejected}"
    for d in decisions:
        _count_decision(d["knob"], d["source"])
        if recorder is not None:
            with recorder.span(
                f"tune-{d['knob']}", category="tune",
                knob=d["knob"], chosen=d["chosen"], default=d["default"],
                source=d["source"], basis=d["basis"],
            ):
                pass
    fitted = sum(1 for d in decisions if d["source"] == "fitted")
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_tune_runs_total",
        "Tuner fits by outcome (fitted=at least one knob left its "
        "default on evidence, insufficient_data=every knob kept its "
        "default)",
    ).inc(outcome="fitted" if fitted else "insufficient_data")
    log.info(
        f"tuned {fitted}/{len(decisions)} knobs from "
        f"{len(table.sources)} source(s): "
        + ", ".join(
            f"{d['knob']}={d['chosen']}" for d in decisions
            if d["source"] == "fitted"
        )
    )
    doc = {
        "knobs": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in accepted.items()
        },
        "decisions": decisions,
        "observations": table.summary(),
        "defaults": {
            k: (list(v) if isinstance(v, tuple) else v)
            for k, v in defaults.items()
        },
    }
    if cost_model_provenance is not None:
        doc["cost_model"] = cost_model_provenance
    return doc
