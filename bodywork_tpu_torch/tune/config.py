"""The tuned-config artifact: how a fitted knob set reaches serving (the
port of ``bodywork_tpu.tune.config``, its names, documents and texts).

``cli tune`` (``tune/model.py``) closes the loop by turning
observed traces into a small JSON document of serving knobs — the four
throughput-critical hand-set values the serving plane exposes today:

- ``batch_window_ms`` / ``batch_max_rows`` — the request coalescer's
  flush policy (``serve/batcher.py``),
- ``buckets`` — the padded-shape ladder the predictor captures
  (``serve/predictor.py DEFAULT_BUCKETS``),
- ``max_pending`` — the admission budget (``serve/admission.py
  DEFAULT_MAX_PENDING``).

The document lives under the ``tuning/`` store prefix (date-keyed, so
the standard ``history``/``latest`` protocol versions it), is
schema-tagged (:data:`TUNED_CONFIG_SCHEMA`), embeds a ``doc_digest``
(``utils/integrity.py``) plus the full decision trace that produced it,
and gets a digest sidecar + compressed replica through the audit layer
(``audit/manifest.py``) so at-rest rot is detectable and restorable.

Consumption contract (the part that must never take serving down):

- ``cli serve --tuned-config REF`` / env :data:`TUNED_CONFIG_ENV`
  (materialised on the k8s serve Deployment) name a store key or the
  literal ``"latest"``;
- per knob, an EXPLICIT caller value (CLI flag, spec arg, or the knob's
  own env var) always wins over the tuned value, which wins over the
  built-in default — tuning fills gaps, it never overrides an operator;
- a missing, malformed, digest-failing, or out-of-range document
  DEGRADES: bad knob values are dropped one at a time (the
  ``policy_from_env`` convention), an unreadable document reverts every
  knob to its built-in default — with a warning and the
  ``bodywork_tpu_tune_config_state`` gauge flipped to 2, never a
  crash-looping pod. Deleting the whole ``tuning/`` prefix is therefore
  always safe: serving reverts to the hand-set defaults.

Standard library only, no torch: the fsck checker, the cli parser and
the serve stage's boot import this module.
"""
from __future__ import annotations

import dataclasses
import json
from datetime import date

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore
from bodywork_tpu_torch.store.schema import (
    TUNED_CONFIG_SCHEMA,
    TUNING_PREFIX,
    tuned_config_key,
)
from bodywork_tpu_torch.utils.integrity import doc_digest, stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tune.config")

__all__ = [
    "TUNED_CONFIG_ENV",
    "TUNED_CONFIG_SCHEMA",
    "TUNED_KNOB_ENV",
    "KNOB_DEFAULTS",
    "DISPATCHER_SCOPED_KNOBS",
    "ResolvedKnobs",
    "load_tuned_config",
    "resolve_serving_knobs",
    "validate_knobs",
    "write_tuned_config",
]

#: the env knob naming WHICH tuned config a serving pod consumes: a
#: ``tuning/`` store key or the literal ``latest`` (empty = off). The
#: k8s serve Deployment materialises it next to the per-knob env vars.
TUNED_CONFIG_ENV = "BODYWORK_TPU_TUNED_CONFIG"

#: tuned-config schema keys -> the per-knob env var that OVERRIDES each
#: (parsed at pod boot by ``stages._serve_tuned_env_knobs`` /
#: ``stages._serve_env_knobs`` and materialised on the k8s serve
#: Deployment). Pinned against both by tests/test_torch_tune.py: a knob
#: in only some layers would be unreachable or silently dead.
TUNED_KNOB_ENV = {
    "batch_window_ms": "BODYWORK_TPU_BATCH_WINDOW_MS",
    "batch_max_rows": "BODYWORK_TPU_BATCH_MAX_ROWS",
    "buckets": "BODYWORK_TPU_BUCKETS",
    "max_pending": "BODYWORK_TPU_MAX_PENDING",
}

#: the hand-set defaults the tuner competes against (duplicated as
#: plain values so this module — imported by fsck and the CLI parser —
#: never pays the serving modules' torch import; pinned == their own
#: constants by tests/test_torch_tune.py)
KNOB_DEFAULTS = {
    "batch_window_ms": 2.0,   # serve.batcher.DEFAULT_WINDOW_MS
    "batch_max_rows": 64,     # serve.batcher.DEFAULT_MAX_ROWS
    "buckets": (1, 8, 64, 512, 4096),  # serve.predictor.DEFAULT_BUCKETS
    "max_pending": 512,       # serve.admission.DEFAULT_MAX_PENDING
}

#: which tuned knobs bind in the device-owning dispatcher of the JAX
#: package's disaggregated serving (``serve --frontends N``, ROADMAP
#: Queue 1 item 15): the coalescer's two and the ladder; ``max_pending``
#: binds upstream, in every front end's shared budget. In the port's
#: topologies (one process, or ``serve --workers N`` replicas that each
#: resolve the document) every knob binds in the serving process.
DISPATCHER_SCOPED_KNOBS = ("batch_window_ms", "batch_max_rows", "buckets")


def _valid_window(v) -> float | None:
    # 0.0 is a VALID fitted value: "coalescing off" — at arrival rates
    # that cannot fill a batch, the window (and the dispatcher thread's
    # wakeups) is pure latency tax and the cost model disables it
    try:
        v = float(v)
    except (TypeError, ValueError):
        return None
    return v if 0.0 <= v <= 1000.0 else None


def _valid_max_rows(v) -> int | None:
    try:
        v = int(v)
    except (TypeError, ValueError):
        return None
    return v if 1 <= v <= 8192 else None


def _valid_buckets(v) -> tuple[int, ...] | None:
    if isinstance(v, (str, bytes)):
        # a string is iterable character-by-character — "18" must not
        # validate as the ladder (1, 8)
        return None
    try:
        buckets = tuple(int(b) for b in v)
    except (TypeError, ValueError):
        return None
    if not 1 <= len(buckets) <= 8:
        return None
    if list(buckets) != sorted(set(buckets)) or buckets[0] < 1:
        return None
    if buckets[-1] > 65536:
        return None
    return buckets


def _valid_max_pending(v) -> int | None:
    try:
        v = int(v)
    except (TypeError, ValueError):
        return None
    return v if 1 <= v <= 1_000_000 else None


_VALIDATORS = {
    "batch_window_ms": _valid_window,
    "batch_max_rows": _valid_max_rows,
    "buckets": _valid_buckets,
    "max_pending": _valid_max_pending,
}


def validate_knobs(knobs: dict) -> tuple[dict, list[str]]:
    """Per-knob validation with the policy_from_env contract: each bad
    value is DROPPED individually (returned in the rejects list) so one
    typo'd knob cannot discard the rest of the tuned document. Unknown
    keys are rejected too — a future schema's knob must not be applied
    by a reader that cannot validate it."""
    if knobs is not None and not isinstance(knobs, dict):
        # a parseable document whose knobs field is the wrong SHAPE
        # (list/string/number) must degrade like any other malformed
        # input, not crash the serving boot with an AttributeError
        return {}, ["knobs"]
    accepted: dict = {}
    rejected: list[str] = []
    for key, value in (knobs or {}).items():
        validator = _VALIDATORS.get(key)
        valid = validator(value) if validator is not None else None
        if valid is None:
            rejected.append(key)
        else:
            accepted[key] = valid
    return accepted, rejected


def _tune_state_gauge():
    from bodywork_tpu_torch.obs import get_registry

    return get_registry().gauge(
        "bodywork_tpu_tune_config_state",
        "Tuned serving config: 0=built-in defaults (no config named), "
        "1=tuned config applied, 2=named config missing/malformed — "
        "degraded to defaults",
        aggregate="max",
    )


def write_tuned_config(store: ArtefactStore, doc: dict,
                       day: date | None = None) -> tuple[str, str]:
    """Persist a tuned-config document (stamping schema + doc_digest)
    at its date-keyed ``tuning/`` location; returns ``(key, digest)``.
    ``doc`` is the tuner's output (``tune.model.fit_tuned_config``):
    knobs + decision trace + observation summary."""
    payload = dict(doc)
    payload["schema"] = TUNED_CONFIG_SCHEMA
    accepted, rejected = validate_knobs(payload.get("knobs"))
    if rejected:
        raise ValueError(
            f"refusing to write a tuned config with invalid knob(s) "
            f"{sorted(rejected)} — the writer must never rely on the "
            "reader's degrade path"
        )
    payload["knobs"] = {
        k: (list(v) if isinstance(v, tuple) else v)
        for k, v in accepted.items()
    }
    payload = stamp_doc(payload)
    key = tuned_config_key(day or date.today())
    store.put_bytes(
        key,
        json.dumps(payload, indent=2, sort_keys=True).encode("utf-8"),
    )
    log.info(
        f"tuned config -> {key} "
        f"({payload['doc_digest'][:23]}..., {len(accepted)} knobs)"
    )
    return key, payload["doc_digest"]


def _resolve_ref(store: ArtefactStore, ref: str) -> str | None:
    """A tuned-config reference -> a concrete store key: ``latest``
    resolves through the standard date-key protocol, restricted to
    ``tuned-config-*`` basenames — ``tuning/`` also holds the learned
    cost model (date-keyed) and the config-lifecycle log, and a cost
    model fitted AFTER the newest tuned config must not shadow it.
    Anything else is taken as the key itself."""
    if ref == "latest":
        try:
            hist = [
                (key, d) for key, d in store.history(TUNING_PREFIX)
                if key.rsplit("/", 1)[-1].startswith("tuned-config-")
            ]
            if not hist:
                return None
            return hist[-1][0]
        except ArtefactNotFound:
            return None
    return ref


def load_tuned_config(
    store: ArtefactStore, ref: str | None
) -> tuple[dict | None, str | None, dict | None]:
    """Load + validate a tuned config; returns ``(knobs, digest, doc)``.

    EVERY failure degrades to ``(None, None, None)`` with a warning —
    an absent key, unparseable bytes, a wrong schema tag, a failing
    doc_digest. Individually invalid knob values are dropped (warned,
    rest kept). The read retries ride the store's own resilience layer;
    this function adds no retry of its own (a corrupt read past the
    store's budget IS the degrade signal)."""
    if not ref:
        return None, None, None
    key = _resolve_ref(store, ref)
    if key is None:
        log.warning(
            f"tuned config {ref!r}: no tuning/ artefacts in the store; "
            "serving with built-in defaults"
        )
        return None, None, None
    try:
        raw = store.get_bytes(key)
    except ArtefactNotFound:
        log.warning(
            f"tuned config {key!r} not found; serving with built-in "
            "defaults"
        )
        return None, None, None
    except Exception as exc:
        log.warning(
            f"tuned config {key!r} unreadable ({exc!r}); serving with "
            "built-in defaults"
        )
        return None, None, None
    try:
        doc = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        log.warning(
            f"tuned config {key!r} is not valid JSON; serving with "
            "built-in defaults"
        )
        return None, None, None
    if not isinstance(doc, dict) or doc.get("schema") != TUNED_CONFIG_SCHEMA:
        log.warning(
            f"tuned config {key!r} has schema "
            f"{doc.get('schema') if isinstance(doc, dict) else None!r} "
            f"(expected {TUNED_CONFIG_SCHEMA!r}); serving with built-in "
            "defaults"
        )
        return None, None, None
    if verify_doc(doc) is False:
        log.warning(
            f"tuned config {key!r} fails its embedded doc_digest "
            "(at-rest corruption?); serving with built-in defaults"
        )
        return None, None, None
    knobs, rejected = validate_knobs(doc.get("knobs"))
    if rejected:
        log.warning(
            f"tuned config {key!r}: dropping invalid knob(s) "
            f"{sorted(rejected)}; keeping the {len(knobs)} valid one(s)"
        )
    if not knobs:
        log.warning(
            f"tuned config {key!r} holds no applicable knobs; serving "
            "with built-in defaults"
        )
        return None, None, None
    return knobs, doc_digest(doc), doc


@dataclasses.dataclass
class ResolvedKnobs:
    """The effective serving knobs after the explicit > tuned > default
    merge, plus the evidence /healthz surfaces: the applied document's
    digest (None = defaults) and, per knob, where its value came from
    (``explicit`` | ``tuned`` | ``default``)."""

    batch_window_ms: float | None
    batch_max_rows: int | None
    buckets: tuple[int, ...] | None
    max_pending: int | None
    tuned_digest: str | None
    sources: dict

    def tuned_knob_count(self) -> int:
        return sum(1 for s in self.sources.values() if s == "tuned")


def resolve_serving_knobs(
    store: ArtefactStore | None,
    tuned_ref: str | None,
    batch_window_ms: float | None = None,
    batch_max_rows: int | None = None,
    buckets: tuple[int, ...] | None = None,
    max_pending: int | None = None,
) -> ResolvedKnobs:
    """The ONE merge point serving boots through (``serve_latest_model``,
    ``serve_stage``, the multiproc workers): explicit caller values win,
    then the tuned config's, then None (each consumer's built-in
    default applies downstream, exactly as before this layer existed —
    byte-identical with no tuned config named).

    Sets the ``bodywork_tpu_tune_config_state`` gauge: 0 = no config
    named, 1 = tuned values applied, 2 = a config was NAMED but could
    not be applied (the operator-visible degrade)."""
    explicit = {
        "batch_window_ms": batch_window_ms,
        "batch_max_rows": batch_max_rows,
        "buckets": buckets,
        "max_pending": max_pending,
    }
    knobs = digest = None
    if tuned_ref and store is not None:
        knobs, digest, _doc = load_tuned_config(store, tuned_ref)
    sources: dict = {}
    values: dict = {}
    for name, explicit_value in explicit.items():
        if explicit_value is not None:
            values[name], sources[name] = explicit_value, "explicit"
        elif knobs is not None and name in knobs:
            values[name], sources[name] = knobs[name], "tuned"
        else:
            values[name], sources[name] = None, "default"
    applied = any(s == "tuned" for s in sources.values())
    if tuned_ref:
        _tune_state_gauge().set(1.0 if applied else 2.0)
        if applied:
            log.info(
                f"tuned config applied ({digest[:23]}...): "
                + ", ".join(
                    f"{k}={values[k]}" for k, s in sources.items()
                    if s == "tuned"
                )
            )
    else:
        _tune_state_gauge().set(0.0)
    raw_buckets = values["buckets"]
    return ResolvedKnobs(
        batch_window_ms=values["batch_window_ms"],
        batch_max_rows=values["batch_max_rows"],
        buckets=tuple(raw_buckets) if raw_buckets else None,
        max_pending=values["max_pending"],
        tuned_digest=digest if applied else None,
        sources=sources,
    )
