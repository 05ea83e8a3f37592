"""Config lifecycle events: the tuned-config release ledger (the port of
``bodywork_tpu.registry.configlog``: the same document bytes, CAS budget,
errors and event counter).

The paper's lifecycle thesis — train, serve, drift, test, repeat —
applies to CONFIGS exactly as the registry already applies it to
models: a tuned config that goes live is a release, and a release needs
an authoritative "what is active, what preceded it, what happened"
document with the same write discipline as the model alias ledger
(``registry/records.py``). This module is that document for the online
tuning control plane (``tune/online.py``):

- **The config log** ``tuning/config-log.json`` — a live CAS-mutated
  pointer (no embedded date; invisible to ``history``/``latest`` like
  ``registry/aliases.json`` and the trainstate doc). It carries the
  ACTIVE tuned config (key + digest + the exact knobs applied + the
  pre-apply baseline window), the PREVIOUS one (the revert target), a
  monotonically increasing ``rev``, and a bounded applied/reverted
  event history ``cli tune status`` renders.
- **Write discipline**: mutated EXCLUSIVELY through
  ``put_bytes_if_match``. Each lifecycle transition (apply, revert) is
  EXACTLY ONE CAS — the same budget the model canary machinery pins
  for abort/promote — and a lost race raises
  :class:`ConfigLogConflict` instead of retrying: a concurrent
  controller already acted, and the loser's next poll re-reads truth.
- **Revert without re-reads**: entries embed the applied ``knobs``
  verbatim, so a revert re-applies the previous knob VALUES directly —
  it cannot be confused by the previous document having been
  overwritten (date-keyed tuned configs are re-fit in place on a
  same-day refit).

Corrupt-read handling mirrors the alias document's strict side: the
log names which knobs are live in the fleet, so a corrupt log raises
:class:`ConfigLogCorrupt` (``cli tune status`` exits 1 on it) rather
than silently reading as "nothing applied".
"""
from __future__ import annotations

import json

from bodywork_tpu_torch.store.base import ArtefactStore, CasConflict
from bodywork_tpu_torch.store.schema import CONFIG_LOG_KEY, CONFIG_LOG_SCHEMA
from bodywork_tpu_torch.utils.integrity import stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("registry.configlog")

#: bounded event history: the log is a live pointer, not an archive —
#: the flight recorder and the tuned documents themselves carry the
#: deep evidence
MAX_HISTORY = 50


class ConfigLogCorrupt(RuntimeError):
    """The config log exists but fails validation. Callers must NOT
    treat this as "nothing applied" — the knobs it named may be live in
    the fleet; surface the corruption instead (``cli tune status``
    exits 1)."""


class ConfigLogConflict(RuntimeError):
    """A concurrent controller won the CAS race for this lifecycle
    transition. Deliberately NOT retried inside this module: each
    transition's budget is exactly one CAS, and the loser's next poll
    re-reads the document another writer just made true."""


def _count_event(event: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_registry_config_events_total",
        "Tuned-config lifecycle transitions recorded in the config log",
    ).inc(event=event)


def _entry(key: str, digest: str, knobs: dict, baseline: dict | None) -> dict:
    return {
        "key": key,
        "digest": digest,
        "knobs": dict(knobs),
        "baseline": dict(baseline) if baseline else None,
    }


def read_config_log(store: ArtefactStore, with_token: bool = False):
    """The config log (validated), or None when absent. ``with_token``
    returns ``(doc, version_token)`` with the token read BEFORE the
    payload — the registry alias reader's CAS-safety ordering. Raises
    :class:`ConfigLogCorrupt` when the document exists but fails
    schema/digest validation."""
    token = store.version_token(CONFIG_LOG_KEY)
    if token is None and not store.exists(CONFIG_LOG_KEY):
        return (None, None) if with_token else None
    try:
        raw = store.get_bytes(CONFIG_LOG_KEY)
        doc = json.loads(raw.decode("utf-8"))
    except Exception as exc:
        raise ConfigLogCorrupt(
            f"config log {CONFIG_LOG_KEY!r} unreadable: {exc!r}"
        )
    if (
        not isinstance(doc, dict)
        or doc.get("schema") != CONFIG_LOG_SCHEMA
        or verify_doc(doc) is False
        or not isinstance(doc.get("history"), list)
    ):
        raise ConfigLogCorrupt(
            f"config log {CONFIG_LOG_KEY!r} fails schema/doc-digest "
            "validation"
        )
    return (doc, token) if with_token else doc


def _write(store: ArtefactStore, doc: dict, expected_token) -> None:
    """The ONE CAS write every lifecycle transition funnels through."""
    assert doc.get("schema") == CONFIG_LOG_SCHEMA, doc
    try:
        store.put_bytes_if_match(
            CONFIG_LOG_KEY,
            json.dumps(
                stamp_doc(doc), sort_keys=True, indent=1
            ).encode("utf-8"),
            expected_token,
        )
    except CasConflict as exc:
        raise ConfigLogConflict(
            f"config log CAS lost ({exc}); a concurrent controller "
            "acted — re-read on the next poll"
        ) from exc


def record_config_applied(
    store: ArtefactStore,
    key: str,
    digest: str,
    knobs: dict,
    baseline: dict | None = None,
    reason: str = "drift_refit",
) -> dict:
    """Record that a tuned config went LIVE: the current active entry
    (if any) becomes the revert target, ``key``/``digest``/``knobs``
    become active with their pre-apply ``baseline`` window attached
    (what the guard verdict compares the post-apply window against).
    Exactly one CAS; returns the written document."""
    doc, token = read_config_log(store, with_token=True)
    if doc is None:
        doc = {
            "schema": CONFIG_LOG_SCHEMA, "rev": 0,
            "active": None, "previous": None, "history": [],
        }
    rev = int(doc.get("rev", 0)) + 1
    new_doc = {
        "schema": CONFIG_LOG_SCHEMA,
        "rev": rev,
        "last_op": "applied",
        "active": _entry(key, digest, knobs, baseline),
        "previous": doc.get("active"),
        "history": (doc.get("history") or [])[-(MAX_HISTORY - 1):] + [{
            "event": "applied", "rev": rev, "key": key,
            "digest": digest, "reason": reason,
        }],
    }
    _write(store, new_doc, token)
    _count_event("applied")
    log.info(
        f"config log: applied {key} ({digest[:23]}…, rev {rev}, "
        f"{reason})"
    )
    return new_doc


def record_config_reverted(
    store: ArtefactStore,
    reason: str,
    flight_record: str | None = None,
) -> tuple[dict | None, dict]:
    """Record that the ACTIVE config was auto-reverted (the breach
    verdict's action): the previous entry becomes active again (None =
    back to built-in defaults / boot-time knobs), with the reverted
    config's key, digest, reason, and the flight-recorder dump key in
    the event. Exactly one CAS; returns ``(restored_entry_or_None,
    reverted_entry)``. Raises ``ValueError`` when nothing is active —
    a revert needs something to revert."""
    doc, token = read_config_log(store, with_token=True)
    if doc is None or not doc.get("active"):
        raise ValueError("config log has no active config to revert")
    reverted = doc["active"]
    restored = doc.get("previous")
    rev = int(doc.get("rev", 0)) + 1
    event = {
        "event": "reverted", "rev": rev, "key": reverted["key"],
        "digest": reverted["digest"], "reason": reason,
    }
    if flight_record:
        event["flight_record"] = flight_record
    new_doc = {
        "schema": CONFIG_LOG_SCHEMA,
        "rev": rev,
        "last_op": "reverted",
        "active": restored,
        # one level of undo, like the alias document's previous slot:
        # a revert consumes it (reverting back onto the config that
        # just breached would be a flap loop, not an undo)
        "previous": None,
        "history": (doc.get("history") or [])[-(MAX_HISTORY - 1):] + [event],
    }
    _write(store, new_doc, token)
    _count_event("reverted")
    log.warning(
        f"config log: REVERTED {reverted['key']} "
        f"({reverted['digest'][:23]}…, rev {rev}): {reason}"
    )
    return restored, reverted
