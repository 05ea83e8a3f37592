"""The learned dispatch-cost model (the port of
``bodywork_tpu.tune.costmodel``: the same features, ridge and documents,
so the same samples and seed give byte-equal weights in both packages).

The tuner prices a bucket ladder with a MEASURED per-bucket probe
(``tune.collect.probe_dispatch_costs``): honest, but blind outside the
probed rungs — a candidate ladder containing an unprobed bucket keeps
its default, and admission cannot price a request at all. Following "A
Learned Performance Model for TPUs" (PAPERS.md), this module fits a
small closed-form ridge regressor over engineered shape features on the
(bucket, n_features, dtype, mesh) -> dispatch-seconds samples the probe
and exemplar-tagged traces already produce, so that:

- ``tune.model.fit_tuned_config`` can price UNPROBED ladder rungs
  (``cost_model=`` parameter) instead of skipping them;
- the admission layer can estimate a request's dispatch cost BEFORE
  parse-side queueing (``serve.admission`` cost-priced shed, via
  :func:`cost_pricer`);
- the online controller (``tune.online``) re-prices drifted traffic
  without re-running the probe on the serving box.

Model choice, deliberately boring: ridge over log-cost in float64 on
the host. Dispatch cost spans ~4 decades over the ladder, so fitting
``log(seconds)`` makes RELATIVE error the objective (the quantity the
tuner's knee/window arguments consume) and keeps every prediction
positive by construction. Closed-form normal equations — no iterations,
no learning rate, bit-deterministic for a given (samples, seed); the
seeded part is only the held-out split whose relative error the
artefact reports about itself.

The fitted model persists as a digest-stamped JSON artefact under the
``tuning/`` prefix (``tuning/cost-model-<day>.json``), loaded through
the same degrade-never-crash contract as the tuned config: any
validation failure returns ``(None, None)`` and callers fall back to
measured-curve-only behaviour.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass

from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import (
    COST_MODEL_SCHEMA,
    TUNING_PREFIX,
    cost_model_key,
)
from bodywork_tpu_torch.utils.integrity import doc_digest, stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tune.costmodel")

__all__ = [
    "COST_MODEL_SCHEMA",
    "CostSample",
    "FEATURE_NAMES",
    "cost_pricer",
    "fit_cost_model",
    "load_cost_model",
    "predict_cost",
    "samples_from_probe",
    "write_cost_model",
]

#: engineered features, in weight order. Chosen for what actually moves
#: dispatch cost on this serving path: a fixed per-dispatch floor
#: (bias), the padded row count and total element count (linear terms),
#: their logs (the sub-linear small-shape regime where launch overhead
#: dominates), bytes-per-element for the quantized dtypes, and the
#: per-device row share for sharded meshes.
FEATURE_NAMES = (
    "bias",
    "log2_bucket",
    "bucket",
    "bucket_x_features",
    "log2_bucket_x_features",
    "dtype_bytes",
    "mesh_devices",
    "rows_per_device",
)

#: bytes per element for the serving dtypes (serve.predictor
#: SERVE_DTYPES); unknown dtypes price as float32 rather than failing —
#: a pricer must degrade, never crash the admission path
_DTYPE_BYTES = {"float32": 4.0, "bfloat16": 2.0, "int8": 1.0}

#: cost floor: predictions are clamped here so a wild extrapolation can
#: never return zero/negative seconds to a divider
_MIN_COST_S = 1e-7

#: minimum samples for a fit (one per weight would interpolate noise;
#: the probe's default 7-rung curve clears this)
MIN_SAMPLES = 4


@dataclass(frozen=True)
class CostSample:
    """One measured dispatch: shape in, seconds out."""

    bucket: int
    n_features: int
    seconds: float
    dtype: str = "float32"
    mesh_devices: int = 1


def _features(bucket: int, n_features: int, dtype: str,
              mesh_devices: int) -> list[float]:
    b = float(max(1, int(bucket)))
    f = float(max(1, int(n_features)))
    m = float(max(1, int(mesh_devices)))
    return [
        1.0,
        math.log2(b + 1.0),
        b,
        b * f,
        math.log2(b * f + 1.0),
        _DTYPE_BYTES.get(dtype, 4.0),
        m,
        b / m,
    ]


def samples_from_probe(
    curve: dict[int, float],
    n_features: int,
    dtype: str = "float32",
    mesh_devices: int = 1,
) -> list[CostSample]:
    """The probe's per-bucket median curve
    (``tune.collect.probe_dispatch_costs``) as training samples."""
    return [
        CostSample(bucket=int(b), n_features=int(n_features),
                   seconds=float(s), dtype=dtype,
                   mesh_devices=mesh_devices)
        for b, s in sorted(curve.items())
        if s is not None and s > 0
    ]


def fit_cost_model(
    samples: list[CostSample],
    seed: int = 0,
    ridge: float = 1e-6,
    holdout_fraction: float = 0.25,
) -> dict:
    """Closed-form ridge over log-cost, float64 host numpy. Returns the
    model DOCUMENT body (weights + the held-out relative error it is
    honest about); the writer stamps schema and digest. Deterministic:
    the same (samples, seed) always produce byte-identical weights.

    The held-out split (seeded permutation, ``holdout_fraction`` of the
    samples, at least one) is fitted WITHOUT its members and scored on
    them — ``holdout.mean_rel_err``/``max_rel_err`` are the honest
    extrapolation bound consumers read before trusting a priced rung.
    The shipped weights are then refitted on ALL samples (discarding
    the holdout's information would make the artefact strictly worse
    than its own evaluation).

    Raises ``ValueError`` below :data:`MIN_SAMPLES` — a curve that thin
    should keep the measured-only behaviour, not ship a fake model.
    """
    import numpy as np

    rows = [s for s in samples if s.seconds > 0]
    if len(rows) < MIN_SAMPLES:
        raise ValueError(
            f"cost model needs >= {MIN_SAMPLES} positive samples, "
            f"got {len(rows)}"
        )

    def _design(subset):
        X = np.array(
            [_features(s.bucket, s.n_features, s.dtype, s.mesh_devices)
             for s in subset],
            dtype=np.float64,
        )
        y = np.log(np.array([s.seconds for s in subset], dtype=np.float64))
        return X, y

    def _solve(X, y):
        k = X.shape[1]
        reg = ridge * np.eye(k, dtype=np.float64)
        reg[0, 0] = 0.0  # never shrink the per-dispatch floor
        return np.linalg.solve(X.T @ X + reg, X.T @ y)

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(rows))
    n_holdout = max(1, int(round(holdout_fraction * len(rows))))
    # never hold out so much the train side drops below identifiability
    n_holdout = min(n_holdout, len(rows) - MIN_SAMPLES + 1)
    n_holdout = max(1, n_holdout)
    holdout = [rows[i] for i in order[:n_holdout]]
    train = [rows[i] for i in order[n_holdout:]]
    if not train:  # degenerate tiny set: score in-sample, say so
        train = rows

    Xt, yt = _design(train)
    w_eval = _solve(Xt, yt)
    Xh, yh = _design(holdout)
    pred = np.exp(Xh @ w_eval)
    truth = np.exp(yh)
    rel = np.abs(pred - truth) / truth
    mean_rel = float(rel.mean())
    max_rel = float(rel.max())

    Xa, ya = _design(rows)
    weights = _solve(Xa, ya)

    from bodywork_tpu_torch.obs import get_registry

    get_registry().gauge(
        "bodywork_tpu_tune_costmodel_holdout_error_ratio",
        "Mean held-out relative error of the last fitted dispatch-cost "
        "model (|predicted - measured| / measured)",
    ).set(mean_rel)
    get_registry().counter(
        "bodywork_tpu_tune_costmodel_fits_total",
        "Dispatch-cost-model fits by outcome",
    ).inc(outcome="fitted")
    log.info(
        f"cost model fitted on {len(rows)} samples; held-out relative "
        f"error mean {mean_rel:.1%} / max {max_rel:.1%} over "
        f"{len(holdout)} sample(s)"
    )
    return {
        "schema": COST_MODEL_SCHEMA,
        "target": "log_seconds",
        "feature_names": list(FEATURE_NAMES),
        "weights": [float(v) for v in weights],
        "ridge": ridge,
        "seed": seed,
        "n_samples": len(rows),
        "samples": [
            {"bucket": s.bucket, "n_features": s.n_features,
             "seconds": s.seconds, "dtype": s.dtype,
             "mesh_devices": s.mesh_devices}
            for s in rows
        ],
        "holdout": {
            "n": len(holdout),
            "fraction": holdout_fraction,
            "mean_rel_err": mean_rel,
            "max_rel_err": max_rel,
            "in_sample": train is rows,
        },
    }


def predict_cost(
    doc: dict,
    bucket: int,
    n_features: int,
    dtype: str = "float32",
    mesh_devices: int = 1,
) -> float:
    """Predicted dispatch seconds for one padded shape, floored at
    :data:`_MIN_COST_S` (an extrapolation must never hand a divider
    zero)."""
    weights = doc["weights"]
    feats = _features(bucket, n_features, dtype, mesh_devices)
    log_cost = sum(w * f for w, f in zip(weights, feats))
    # exp() overflow guard: a corrupt weight vector prices as "huge",
    # which every consumer treats as "don't" — the safe direction
    return max(_MIN_COST_S, math.exp(min(log_cost, 50.0)))


def cost_pricer(
    doc: dict,
    n_features: int,
    buckets: tuple[int, ...] | None = None,
    dtype: str = "float32",
    mesh_devices: int = 1,
):
    """A ``rows -> estimated dispatch seconds`` callable for the
    admission layer's cost-priced shed: the request prices as the cost
    of the LADDER RUNG it would pad to (the shape the device actually
    runs), or its own pow2 cover when no ladder is given."""
    ladder = tuple(sorted(buckets)) if buckets else None

    def price(rows: int = 1) -> float:
        rows = max(1, int(rows))
        if ladder:
            cover = next((b for b in ladder if b >= rows), ladder[-1])
        else:
            cover = 1 if rows <= 1 else 2 ** math.ceil(math.log2(rows))
        return predict_cost(doc, cover, n_features, dtype, mesh_devices)

    return price


# -- the persisted artefact ------------------------------------------------


def write_cost_model(store: ArtefactStore, doc: dict, day) -> tuple[str, str]:
    """Persist one fitted model under ``tuning/cost-model-<day>.json``
    (stamped; same prefix and audit coverage as the tuned config).
    Returns ``(key, doc_digest)``."""
    if doc.get("schema") != COST_MODEL_SCHEMA or not isinstance(
        doc.get("weights"), list
    ):
        raise ValueError("not a cost-model document")
    stamped = stamp_doc(dict(doc))
    key = cost_model_key(day)
    store.put_bytes(
        key, json.dumps(stamped, sort_keys=True, indent=1).encode("utf-8")
    )
    log.info(f"wrote cost model {key} ({stamped['doc_digest'][:23]}…)")
    return key, stamped["doc_digest"]


def load_cost_model(store: ArtefactStore, ref: str = "latest"):
    """``(doc, digest)`` for a stored cost model, degrading to
    ``(None, None)`` on ANY failure (absent, unparseable, wrong schema,
    digest mismatch, malformed weights) — consumers then price nothing
    and the measured curve carries on alone, exactly the tuned-config
    loader's contract."""
    try:
        if ref == "latest":
            candidates = [
                k for k in store.list_keys(TUNING_PREFIX)
                if k.rsplit("/", 1)[-1].startswith("cost-model-")
            ]
            if not candidates:
                return None, None
            key = max(candidates)  # date-keyed: lexicographic == newest
        else:
            key = ref
        raw = store.get_bytes(key)
        doc = json.loads(raw.decode("utf-8"))
        if (
            not isinstance(doc, dict)
            or doc.get("schema") != COST_MODEL_SCHEMA
            or verify_doc(doc) is False
            or not isinstance(doc.get("weights"), list)
            or len(doc["weights"]) != len(FEATURE_NAMES)
            or not all(
                isinstance(w, (int, float)) and math.isfinite(w)
                for w in doc["weights"]
            )
        ):
            log.warning(f"cost model {key!r} failed validation; ignoring it")
            return None, None
        return doc, doc.get("doc_digest") or doc_digest(doc)
    except Exception as exc:
        log.warning(f"cost model {ref!r} unreadable ({exc!r}); ignoring it")
        return None, None
