"""The promotion gate: candidate against production (the port of
``bodywork_tpu.registry.gates``).

A freshly trained checkpoint is a *candidate* until this gate decides.
It reads three signals, cheapest first, with the JAX package's rules and
defaults:

1. **The candidate's held-out metrics** (the train stage's MAPE /
   r_squared CSV): they must exist, parse and be finite, with r_squared
   at least ``min_r2`` (and MAPE under ``max_mape``, an opt-in ceiling:
   healthy days reach MAPE of about 52 when the drift pushes labels
   through zero, so every MAPE rule is off by default). A candidate with
   no readable quality signal never promotes.
2. **Against production**: r_squared may drop at most
   ``max_r2_drop_vs_production`` below production's (the opt-in MAPE
   ratio ``max_mape_vs_production`` besides). A degradation is
   overridden only when the live drift verdict
   (:func:`bodywork_tpu_torch.monitor.analytics.detect_drift` over
   ``drift_window`` days) says production itself has drifted.
3. **Shadow evaluation** (``shadow_days > 0``): both models score the
   last K days in process (:mod:`.shadow`), blocking on the mean
   prediction delta or the shadow-window MAPE ratio.

Decisions are pure functions of artefact bytes (no wall clock, no
randomness): the decision events are byte-identical to the JAX
package's for the same store.
"""
from __future__ import annotations

import csv
import dataclasses
import io
import math
from datetime import date

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("registry.gates")

DECISION_SCHEMA = "bodywork_tpu.registry_decision/1"


@dataclasses.dataclass
class GatePolicy:
    """Promotion-gate knobs, with the JAX package's defaults: the
    correlation checks are the bounded, calibrated signal; every
    MAPE-based rule is OPT-IN because day-level MAPE is unbounded tail
    noise when labels touch zero (healthy days measured at MAPE≈52 under
    the drift sinusoid)."""

    #: OPT-IN absolute ceiling on the candidate's held-out MAPE (None =
    #: off; only for label distributions bounded away from zero)
    max_mape: float | None = None
    #: absolute floor on the candidate's held-out score/label
    #: correlation — catches uncorrelated-garbage fits outright
    min_r2: float = 0.2
    #: DEFAULT relative check: candidate r_squared may drop at most this
    #: far below production's (bounded statistic, robust to the
    #: near-zero-label tails that make day-level MAPE ratios noise)
    max_r2_drop_vs_production: float = 0.2
    #: OPT-IN relative check (None = off, the default — see the module
    #: docstring's measured MAPE-ratio pathology): candidate MAPE may be
    #: at most this multiple of production's…
    max_mape_vs_production: float | None = None
    #: …plus this absolute slack (two tiny MAPEs must not trip the
    #: ratio); also the slack under the shadow-window MAPE ratio
    mape_slack: float = 0.05
    #: shadow-window MAPE ratio (shadow scores BOTH models on the SAME
    #: rows, so the ratio is a fair same-denominator comparison there)
    shadow_max_mape_ratio: float = 1.5
    #: trailing days of drift test-metrics consulted for the
    #: production-has-drifted override of the degradation check
    drift_window: int = 7
    #: shadow evaluation over the last K dataset days; 0 = off
    shadow_days: int = 0
    #: block when the candidate-vs-production mean |prediction delta|
    #: over the shadow window exceeds this (None = record, never block)
    shadow_max_mean_abs_delta: float | None = None
    #: shadow window (dataset days) for the QUANTIZED-serving quality
    #: gate: a quantized predictor scores the last K days next to the f32
    #: predictor of the SAME checkpoint, and may only take traffic when
    #: the delta passes the candidate shadow check's ceilings
    #: (:func:`evaluate_quantization`; its serving half is ROADMAP Queue
    #: 1 item 5)
    quantized_shadow_days: int = 3


@dataclasses.dataclass
class GateDecision:
    model_key: str
    promote: bool
    checks: list[dict]
    reasons: list[str]
    day: date | None = None
    shadow: dict | None = None

    def to_event(self) -> dict:
        """The decision as a record-history event (deterministic JSON)."""
        return {
            "event": "gate_decision",
            "schema": DECISION_SCHEMA,
            "day": str(self.day) if self.day else None,
            "promote": self.promote,
            "checks": self.checks,
            "reasons": self.reasons,
            **({"shadow": self.shadow} if self.shadow is not None else {}),
        }


def read_model_metrics(store: ArtefactStore, metrics_key: str | None) -> dict | None:
    """Parse the one-row train-metrics CSV (``date,MAPE,r_squared,
    max_residual``) with the stdlib csv module — the gate runs inside
    serving-adjacent processes and must not pull pandas into their
    closure. None when absent/unparseable."""
    if not metrics_key:
        return None
    try:
        text = store.get_bytes(metrics_key).decode("utf-8")
    except (ArtefactNotFound, UnicodeDecodeError):
        return None
    try:
        rows = list(csv.DictReader(io.StringIO(text)))
    except csv.Error:
        return None
    if not rows:
        return None
    row = rows[0]
    try:
        return {
            "MAPE": float(row["MAPE"]),
            "r_squared": float(row["r_squared"]),
        }
    except (KeyError, TypeError, ValueError):
        return None


def _production_drifted(store: ArtefactStore, window: int) -> bool:
    """The live drift verdict over the trailing window (the calibrated
    bias rule), read only on the degradation-override path."""
    try:
        from bodywork_tpu_torch.monitor.analytics import detect_drift, drift_report

        report = drift_report(store)
        if not report:
            return False
        return bool(detect_drift(report, window=window)["drifted"])
    except Exception as exc:  # a broken report must not wedge the gate
        log.warning(f"drift check failed (treating as not-drifted): {exc!r}")
        return False


def evaluate_quantization(
    report: dict, policy: GatePolicy | None = None
) -> tuple[bool, str]:
    """The quantized-serving quality verdict over a shadow-comparison
    report (``registry.shadow.shadow_compare``: quantized = candidate,
    f32 = production — the SAME checkpoint, two dtypes). Applies exactly
    the candidate shadow check's ceilings (``shadow_max_mape_ratio`` +
    ``mape_slack``, ``shadow_max_mean_abs_delta``): the question "may
    this lower-precision variant answer for that model" IS the shadow
    question, so it gets the shadow rulebook, not a new one. Returns
    ``(ok, detail)``; the serving boot path keeps f32 on a False."""
    policy = policy or GatePolicy()
    ok = True
    detail = (
        f"mean|Δ|={report['mean_abs_delta']:.6f} over "
        f"{report['days']} day(s)/{report['rows']} rows"
    )
    if (
        policy.shadow_max_mean_abs_delta is not None
        and report["mean_abs_delta"] > policy.shadow_max_mean_abs_delta
    ):
        ok = False
        detail += f" exceeds {policy.shadow_max_mean_abs_delta}"
    q_mape = report.get("candidate_mape")
    f32_mape = report.get("production_mape")
    if (
        q_mape is not None
        and f32_mape is not None
        and math.isfinite(q_mape)
        and math.isfinite(f32_mape)
    ):
        ceiling = f32_mape * policy.shadow_max_mape_ratio + policy.mape_slack
        if q_mape > ceiling:
            ok = False
            detail += (
                f"; quantized shadow MAPE {q_mape:.6f} exceeds ceiling "
                f"{ceiling:.6f} (f32 {f32_mape:.6f})"
            )
    else:
        # a non-finite quantized MAPE is a broken variant, full stop
        if q_mape is None or not math.isfinite(q_mape):
            ok = False
            detail += f"; quantized shadow MAPE unusable ({q_mape})"
    return ok, detail


def evaluate_candidate(
    store: ArtefactStore,
    candidate: dict,
    production: dict | None,
    policy: GatePolicy | None = None,
    day: date | None = None,
    device=None,
) -> GateDecision:
    """Run the gate checks for one candidate record against the current
    production record (None = bootstrap: no production yet, only the
    absolute checks apply). Returns the full decision — the manager
    applies it (promote / reject) and appends it to the record. A shadow
    evaluation scores on ``device`` (the card unless asked for the CPU)."""
    policy = policy or GatePolicy()
    checks: list[dict] = []
    reasons: list[str] = []
    promote = True
    shadow_report = None

    def check(name: str, ok: bool, detail: str) -> bool:
        checks.append({"name": name, "ok": bool(ok), "detail": detail})
        if not ok:
            reasons.append(f"{name}: {detail}")
        return ok

    cand_metrics = read_model_metrics(store, candidate.get("metrics_key"))
    if cand_metrics is None or not all(
        math.isfinite(v) for v in cand_metrics.values()
    ):
        check(
            "candidate-metrics", False,
            "no readable finite train metrics for the candidate",
        )
        return GateDecision(
            candidate["model_key"], False, checks, reasons, day=day
        )
    mape, r2 = cand_metrics["MAPE"], cand_metrics["r_squared"]
    absolute_ok = r2 >= policy.min_r2 and (
        policy.max_mape is None or mape <= policy.max_mape
    )
    promote &= check(
        "candidate-metrics",
        absolute_ok,
        f"r_squared={r2:.6f} (min {policy.min_r2}), MAPE={mape:.6f} "
        + (
            f"(max {policy.max_mape})"
            if policy.max_mape is not None
            else "(no ceiling: MAPE rules are opt-in)"
        ),
    )

    prod_metrics = (
        read_model_metrics(store, production.get("metrics_key"))
        if production is not None
        else None
    )
    if production is not None and prod_metrics is None:
        # not the candidate's fault, so it does not block promotion —
        # but the audit trail must show the comparison was SKIPPED, not
        # passed (an operator reading the decision event would otherwise
        # assume the relative check ran)
        check(
            "vs-production", True,
            "production train metrics unreadable; relative comparison "
            "SKIPPED (absolute checks only)",
        )
    if prod_metrics is not None:
        degraded: list[str] = []
        compared = False  # did ANY relative comparison actually run?
        prod_r2 = prod_metrics["r_squared"]
        if math.isfinite(prod_r2):
            compared = True
            r2_floor = prod_r2 - policy.max_r2_drop_vs_production
            if r2 < r2_floor:
                degraded.append(
                    f"r_squared={r2:.6f} below floor {r2_floor:.6f} "
                    f"(production {prod_r2:.6f})"
                )
        if (
            policy.max_mape_vs_production is not None
            and math.isfinite(prod_metrics["MAPE"])
        ):
            compared = True
            ceiling = (
                prod_metrics["MAPE"] * policy.max_mape_vs_production
                + policy.mape_slack
            )
            if mape > ceiling:
                degraded.append(
                    f"MAPE={mape:.6f} exceeds ceiling {ceiling:.6f} "
                    f"(production {prod_metrics['MAPE']:.6f})"
                )
        if not compared:
            # production's metrics read but every compared figure is
            # non-finite (e.g. a hand-promoted model with r_squared=nan):
            # same audit contract as the unreadable case above — the
            # trail must say SKIPPED, not claim a comparison that never
            # ran passed
            check(
                "vs-production", True,
                f"production metrics non-finite (r_squared={prod_r2}); "
                "relative comparison SKIPPED (absolute checks only)",
            )
        elif not degraded:
            check(
                "vs-production", True,
                f"r_squared={r2:.6f} vs production {prod_r2:.6f} "
                f"(max drop {policy.max_r2_drop_vs_production})",
            )
        elif _production_drifted(store, policy.drift_window):
            # production is stale per the live drift signal: a fresh
            # candidate wins even though its held-out metrics look
            # worse — the held-out set itself has drifted under
            # production
            check(
                "vs-production", True,
                f"{'; '.join(degraded)} — but production drifted over "
                f"the last {policy.drift_window} day(s); promoting "
                "fresh candidate",
            )
        else:
            promote &= check(
                "vs-production", False,
                f"{'; '.join(degraded)} and production shows no live drift",
            )

    if policy.shadow_days > 0 and production is not None:
        from bodywork_tpu_torch.registry.shadow import shadow_evaluate

        try:
            shadow_report = shadow_evaluate(
                store,
                candidate["model_key"],
                production["model_key"],
                days=policy.shadow_days,
                device=device,
            )
        except Exception as exc:
            promote &= check(
                "shadow", False, f"shadow evaluation failed: {exc!r}"
            )
        else:
            ok = True
            detail = (
                f"mean|Δ|={shadow_report['mean_abs_delta']:.6f} over "
                f"{shadow_report['days']} day(s)/{shadow_report['rows']} rows"
            )
            if (
                policy.shadow_max_mean_abs_delta is not None
                and shadow_report["mean_abs_delta"]
                > policy.shadow_max_mean_abs_delta
            ):
                ok = False
                detail += (
                    f" exceeds {policy.shadow_max_mean_abs_delta}"
                )
            cand_shadow = shadow_report.get("candidate_mape")
            prod_shadow = shadow_report.get("production_mape")
            if (
                cand_shadow is not None
                and prod_shadow is not None
                and math.isfinite(cand_shadow)
                and math.isfinite(prod_shadow)
            ):
                shadow_ceiling = (
                    prod_shadow * policy.shadow_max_mape_ratio
                    + policy.mape_slack
                )
                if cand_shadow > shadow_ceiling:
                    ok = False
                    detail += (
                        f"; shadow MAPE {cand_shadow:.6f} exceeds "
                        f"ceiling {shadow_ceiling:.6f} "
                        f"(production {prod_shadow:.6f})"
                    )
            promote &= check("shadow", ok, detail)

    return GateDecision(
        candidate["model_key"], bool(promote), checks, reasons,
        day=day, shadow=shadow_report,
    )
