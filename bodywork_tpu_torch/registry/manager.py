"""Registry operations: register, gate, promote, rollback, demote (the
port of ``bodywork_tpu.registry.manager``).

:class:`ModelRegistry` is the one mutation surface over the records and
the alias document (:mod:`.records`). Every alias mutation is ONE
compare-and-swap against the token the document was read under: of two
concurrent promoters the loser gets a clean :class:`PromotionConflict`
and the document never holds a half-updated state. Rollback is the same
single CAS, flipping ``production`` and ``previous``.

Records are updated after the alias CAS lands: the alias is the truth
and the records its audit trail, so a crash between the two leaves
serving right and the ledger repairable, never the reverse.

The canary lifecycle (``canary_start``, ``canary_abort``,
``canary_repair``, ``canary_promote``) is one alias CAS per transition
too: a breaching canary is gone after exactly one write, and of two
concurrent watchdogs the loser finds the slot already cleared. An
ordinary promotion or rollback keeps a live canary's slot.

Counters, the JAX package's: ``bodywork_tpu_registry_promotions_total
{outcome}`` (promoted, rejected, conflict), ``..._rollbacks_total``,
``..._rollback_refusals_total{reason}`` and
``..._canary_events_total{event}`` (start, abort, promote, repair).
"""
from __future__ import annotations

from datetime import date

from bodywork_tpu_torch.registry import records as rec
from bodywork_tpu_torch.registry.gates import GateDecision, GatePolicy, evaluate_candidate
from bodywork_tpu_torch.store.base import ArtefactStore, CasConflict
from bodywork_tpu_torch.store.schema import REGISTRY_RECORDS_PREFIX
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("registry.manager")


class RegistryError(RuntimeError):
    """A registry operation could not be applied (unknown model, nothing
    to roll back to, ...): an operator-facing error, not a crash."""


class PromotionConflict(RegistryError):
    """Another writer's alias CAS landed first. The alias is intact;
    re-read and retry if still relevant."""


class RollbackBlocked(RegistryError):
    """The rollback target failed pre-verification: the ``previous``
    checkpoint is missing, its record unreadable, or its bytes no longer
    match the record's lineage digest. The alias did not move, and the
    target's record carries a ``rollback_refused`` event."""


def _count_promotion(outcome: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_registry_promotions_total",
        "Registry promotion gate outcomes",
    ).inc(outcome=outcome)


def _count_rollback() -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_registry_rollbacks_total",
        "Registry rollbacks (production alias flipped back to previous)",
    ).inc()


def _count_rollback_refused(reason: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_registry_rollback_refusals_total",
        "Rollbacks refused because the restore target failed "
        "pre-verification, by reason",
    ).inc(reason=reason)


def _count_canary_event(event: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_registry_canary_events_total",
        "Canary lifecycle transitions (start/abort/promote/repair)",
    ).inc(event=event)


#: the canary lifecycle verbs: the ``cli registry canary`` actions and the
#: :class:`ModelRegistry` methods they call (the JAX package's list)
CANARY_ACTIONS = ("start", "stop", "promote", "status")
CANARY_ACTION_METHODS = {
    "start": "canary_start",
    "stop": "canary_abort",
    "promote": "canary_promote",
    "status": "canary_status",
}


def _day(day: date | None) -> str | None:
    return str(day) if day else None


class ModelRegistry:
    def __init__(self, store: ArtefactStore, policy: GatePolicy | None = None,
                 device=None):
        self.store = store
        self.policy = policy or GatePolicy()
        #: where a shadow evaluation scores (the card unless asked for the CPU)
        self.device = device

    # -- reads -------------------------------------------------------------

    def resolve(self, alias: str = "production") -> str | None:
        return rec.resolve_alias(self.store, alias)

    def records(self) -> list[dict]:
        return rec.list_records(self.store)

    def newest_candidate(self) -> dict | None:
        """The most recent record still in ``candidate`` status. Walks the
        records newest first and stops at the first ``production`` or
        ``archived`` one: older candidates are stale history the gate
        never picks, so the daily gate reads one or two records."""
        for key, _d in reversed(self.store.history(REGISTRY_RECORDS_PREFIX)):
            record = rec._validated_read(self.store, key, rec.RECORD_SCHEMA, "record")
            if record is None:
                continue
            status = record.get("status")
            if status == "candidate":
                return record
            if status in ("production", "archived"):
                return None
        return None

    def production_record(self) -> dict | None:
        key = self.resolve("production")
        return rec.load_record(self.store, key) if key else None

    # -- mutations ---------------------------------------------------------

    def register(self, model_key: str, metrics_key: str | None = None,
                 day: date | None = None) -> dict:
        return rec.register_candidate(self.store, model_key, metrics_key=metrics_key, day=day)

    def promote(self, model_key: str, day: date | None = None,
                reason: str = "promoted") -> dict:
        """Point ``production`` at a registered ``model_key`` in one alias
        CAS; the old production becomes ``previous``. Returns the new
        alias document."""
        record = rec.load_record(self.store, model_key)
        if record is None:
            raise RegistryError(
                f"cannot promote unregistered model {model_key!r}; register it first"
            )
        doc, token = rec.read_aliases(self.store, with_token=True)
        old_production = doc.get("production") if doc else None
        if old_production == model_key:
            # the alias already points here: repair a ledger that says otherwise
            if record.get("status") != "production":
                rec.append_event(
                    self.store, model_key,
                    {"event": "promoted", "day": _day(day),
                     "reason": "repair: alias already points here"},
                    status="production",
                )
            log.info(f"{model_key} is already production; no-op")
            return doc
        new_doc = {
            "schema": rec.ALIAS_SCHEMA,
            "production": model_key,
            "previous": old_production,
            "rev": (doc.get("rev", 0) + 1) if doc else 1,
            "updated_day": _day(day),
            "last_op": "promote",
            # a live canary survives a promotion, unless it is the
            # promoted key itself
            **{k: doc[k] for k in (rec.CANARY_DOC_KEYS if doc else ())
               if k in doc and doc.get("canary") != model_key},
        }
        try:
            rec.write_aliases(self.store, new_doc, token)
        except CasConflict as exc:
            _count_promotion("conflict")
            raise PromotionConflict(
                f"promotion of {model_key!r} lost the alias race: {exc}"
            ) from exc
        rec.append_event(
            self.store, model_key,
            {"event": "promoted", "day": _day(day), "reason": reason,
             "replaced": old_production},
            status="production",
        )
        if old_production and old_production != model_key:
            rec.append_event(
                self.store, old_production,
                {"event": "superseded", "day": _day(day), "by": model_key},
                status="archived",
            )
        _count_promotion("promoted")
        log.info(f"promoted {model_key} to production (previous: {old_production or 'none'})")
        return new_doc

    def _verify_restorable(self, model_key: str, day: date | None) -> None:
        """Pre-verify a rollback target before the alias CAS: the
        checkpoint exists and its bytes still match the record's lineage
        digest. A refusal raises :class:`RollbackBlocked` and leaves a
        ``rollback_refused`` event on the target's record."""
        reason = None
        if not self.store.exists(model_key):
            reason = "checkpoint_missing"
            detail = f"previous checkpoint {model_key!r} is missing"
        else:
            record = rec.load_record(self.store, model_key)
            expected = record.get("model_digest") if record else None
            if record is None:
                reason = "record_unreadable"
                detail = (f"record for {model_key!r} is absent or corrupt; "
                          "cannot verify the checkpoint's lineage digest")
            elif expected and rec.model_digest(self.store.get_bytes(model_key)) != expected:
                reason = "digest_mismatch"
                detail = (f"checkpoint {model_key!r} no longer matches its record "
                          f"digest {expected[:15]}… (at-rest corruption?)")
        if reason is None:
            return
        _count_rollback_refused(reason)
        # best effort: with the record unreadable there is nowhere to write it
        rec.append_event(
            self.store, model_key,
            {"event": "rollback_refused", "day": _day(day), "reason": reason},
        )
        log.error(f"rollback REFUSED ({reason}): {detail}")
        raise RollbackBlocked(detail)

    def rollback(self, day: date | None = None, reason: str = "rollback") -> dict:
        """Back to the previous production in ONE alias CAS flipping
        ``production`` and ``previous``, after the target is pre-verified
        (:meth:`_verify_restorable`). No artefact moves."""
        doc, token = rec.read_aliases(self.store, with_token=True)
        if doc is None:
            raise RegistryError("no registry alias document; nothing to roll back")
        current, previous = doc.get("production"), doc.get("previous")
        if not previous:
            raise RegistryError("no previous production recorded; nothing to roll back to")
        self._verify_restorable(previous, day)
        new_doc = {
            "schema": rec.ALIAS_SCHEMA,
            "production": previous,
            "previous": current,
            "rev": doc.get("rev", 0) + 1,
            "updated_day": _day(day),
            "last_op": "rollback",
            **{k: doc[k] for k in rec.CANARY_DOC_KEYS
               if k in doc and doc.get("canary") != previous},
        }
        try:
            rec.write_aliases(self.store, new_doc, token)
        except CasConflict as exc:
            raise PromotionConflict(f"rollback lost the alias race: {exc}") from exc
        rec.append_event(
            self.store, previous,
            {"event": "restored", "day": _day(day), "reason": reason},
            status="production",
        )
        if current:
            rec.append_event(
                self.store, current,
                {"event": "rolled_back", "day": _day(day), "reason": reason},
                status="rejected",
            )
        _count_rollback()
        log.info(f"rolled back production {current} -> {previous}")
        return new_doc

    def demote(self, model_key: str, day: date | None = None,
               reason: str = "demoted") -> dict:
        """Mark a non-production record ``rejected``. Demoting production
        is refused: :meth:`rollback` retires it and decides what serves."""
        if self.resolve("production") == model_key:
            raise RegistryError(f"{model_key!r} is production; use rollback instead of demote")
        record = rec.append_event(
            self.store, model_key,
            {"event": "demoted", "day": _day(day), "reason": reason},
            status="rejected",
        )
        if record is None:
            raise RegistryError(f"no registry record for {model_key!r}")
        return record

    # -- the canary lifecycle: one alias CAS per transition ------------------

    def canary_state(self, doc: dict | None = None) -> dict | None:
        """What the canary slot says (``{"key", "fraction", "seed",
        "day"}``), or None; unlike :func:`records.resolve_canary` it does
        not check that the canary can serve."""
        if doc is None:
            doc = rec.read_aliases(self.store)
        if not doc or not doc.get("canary"):
            return None
        return {
            "key": doc.get("canary"),
            "fraction": doc.get("canary_fraction"),
            "seed": doc.get("canary_seed"),
            "day": doc.get("canary_day"),
        }

    def canary_start(self, model_key: str, fraction: float = 0.1, seed: int = 0,
                     day: date | None = None) -> dict:
        """Point the ``canary`` slot at a registered candidate, so serving
        routes ``fraction`` of the scoring traffic to it by seeded request
        hash. Refused without a production baseline, for production
        itself, for a gate-rejected record and while another canary is
        live. One alias CAS."""
        if not 0.0 < fraction <= 1.0:
            raise RegistryError(f"canary fraction must be in (0, 1], got {fraction!r}")
        record = rec.load_record(self.store, model_key)
        if record is None:
            raise RegistryError(
                f"cannot canary unregistered model {model_key!r}; register it first"
            )
        if record.get("status") == "rejected":
            raise RegistryError(
                f"{model_key!r} is gate-rejected; a rejected checkpoint "
                "must not take live traffic"
            )
        doc, token = rec.read_aliases(self.store, with_token=True)
        if doc is None or not doc.get("production"):
            raise RegistryError(
                "no production model; a canary needs a baseline to "
                "fall back to — promote one first"
            )
        if doc.get("production") == model_key:
            raise RegistryError(f"{model_key!r} already is production")
        if doc.get("canary"):
            raise RegistryError(
                f"a canary is already live ({doc['canary']!r}); stop it "
                "before starting another"
            )
        new_doc = {
            **{k: v for k, v in doc.items() if k not in rec.CANARY_DOC_KEYS},
            "rev": doc.get("rev", 0) + 1,
            "updated_day": _day(day),
            "last_op": "canary_start",
            "canary": model_key,
            "canary_fraction": float(fraction),
            "canary_seed": int(seed),
            "canary_day": _day(day),
        }
        try:
            rec.write_aliases(self.store, new_doc, token)
        except CasConflict as exc:
            raise PromotionConflict(
                f"canary start of {model_key!r} lost the alias race: {exc}"
            ) from exc
        rec.append_event(
            self.store, model_key,
            {"event": "canary_started", "day": _day(day),
             "fraction": float(fraction), "seed": int(seed)},
        )
        _count_canary_event("start")
        log.info(f"canary started: {model_key} at fraction {fraction} (seed {seed})")
        return new_doc

    def _canary_clear(self, last_op: str, event: str, day: date | None, reason: str,
                      record_status: str | None, count_as: str) -> dict | None:
        """Clear the slot in one alias write, then record the lineage
        event. None when no canary was live (another watchdog may have
        cleared it first)."""
        doc, token = rec.read_aliases(self.store, with_token=True)
        if doc is None or not doc.get("canary"):
            return None
        canary_key = doc["canary"]
        new_doc = {
            **{k: v for k, v in doc.items() if k not in rec.CANARY_DOC_KEYS},
            "rev": doc.get("rev", 0) + 1,
            "updated_day": _day(day),
            "last_op": last_op,
        }
        try:
            rec.write_aliases(self.store, new_doc, token)
        except CasConflict as exc:
            raise PromotionConflict(
                f"{last_op} of {canary_key!r} lost the alias race: {exc}"
            ) from exc
        rec.append_event(
            self.store, canary_key,
            {"event": event, "day": _day(day), "reason": reason},
            status=record_status,
        )
        _count_canary_event(count_as)
        return new_doc

    def canary_abort(self, day: date | None = None,
                     reason: str = "canary aborted") -> dict | None:
        """Retire the live canary in one CAS (the SLO watchdog's breach
        action, and ``cli registry canary stop``): production never moved,
        the slot clears and the canary's record becomes ``rejected``.
        None when no canary was live."""
        doc = self._canary_clear("canary_abort", "canary_aborted", day, reason,
                                 record_status="rejected", count_as="abort")
        if doc is not None:
            log.warning(f"canary ABORTED: {reason}")
        return doc

    def canary_repair(self, day: date | None = None,
                      reason: str = "dangling canary slot") -> dict | None:
        """Clear a dangling canary slot (its checkpoint deleted or record
        rejected) in one CAS; the record keeps its status."""
        doc = self._canary_clear("canary_repair", "canary_repaired", day, reason,
                                 record_status=None, count_as="repair")
        if doc is not None:
            log.warning(f"dangling canary slot repaired: {reason}")
        return doc

    def canary_promote(self, day: date | None = None,
                       reason: str = "canary: survived SLO window healthy") -> dict:
        """Graduate the live canary in one CAS: ``production`` becomes the
        canary, the old production ``previous``, the slot clears."""
        doc, token = rec.read_aliases(self.store, with_token=True)
        if doc is None or not doc.get("canary"):
            raise RegistryError("no live canary to promote")
        canary_key = doc["canary"]
        old_production = doc.get("production")
        new_doc = {
            **{k: v for k, v in doc.items() if k not in rec.CANARY_DOC_KEYS},
            "production": canary_key,
            "previous": old_production,
            "rev": doc.get("rev", 0) + 1,
            "updated_day": _day(day),
            "last_op": "canary_promote",
        }
        try:
            rec.write_aliases(self.store, new_doc, token)
        except CasConflict as exc:
            _count_promotion("conflict")
            raise PromotionConflict(
                f"canary promotion of {canary_key!r} lost the alias race: {exc}"
            ) from exc
        rec.append_event(
            self.store, canary_key,
            {"event": "promoted", "day": _day(day), "reason": reason,
             "replaced": old_production},
            status="production",
        )
        if old_production and old_production != canary_key:
            rec.append_event(
                self.store, old_production,
                {"event": "superseded", "day": _day(day), "by": canary_key},
                status="archived",
            )
        _count_promotion("promoted")
        _count_canary_event("promote")
        log.info(f"canary promoted to production: {canary_key} "
                 f"(previous: {old_production or 'none'})")
        return new_doc

    def canary_status(self) -> dict:
        """The operator's canary snapshot (``cli registry canary
        status``): the slot, whether it can serve, and its record's
        status."""
        doc = rec.read_aliases(self.store)
        state, dangling = rec.resolve_canary(self.store, doc)
        slot = self.canary_state(doc)
        record = rec.load_record(self.store, slot["key"]) if slot else None
        return {
            "canary": slot,
            "live": state is not None,
            "dangling_reason": dangling,
            "record_status": record.get("status") if record else None,
            "production": (doc or {}).get("production"),
        }

    # -- the gate ----------------------------------------------------------

    def gate(self, day: date | None = None, model_key: str | None = None,
             policy: GatePolicy | None = None, dry_run: bool = False) -> GateDecision | None:
        """Adjudicate one candidate (named, or the newest in ``candidate``
        status): evaluate the policy, then promote or reject. Returns the
        decision, or None when there is nothing to gate. ``dry_run``
        evaluates and writes nothing. With no production yet, a candidate
        passing the absolute checks is promoted (bootstrap)."""
        policy = policy or self.policy
        if model_key is not None:
            if self.resolve("production") == model_key:
                raise RegistryError(
                    f"{model_key!r} is production; the gate adjudicates "
                    "candidates — use rollback to retire production"
                )
            candidate = rec.load_record(self.store, model_key)
            if candidate is None:
                raise RegistryError(f"no registry record for {model_key!r}")
        else:
            candidate = self.newest_candidate()
            if candidate is None:
                return None
        decision = evaluate_candidate(self.store, candidate, self.production_record(),
                                      policy=policy, day=day, device=self.device)
        if dry_run:
            return decision
        if decision.promote:
            rec.append_event(self.store, candidate["model_key"], decision.to_event())
            self.promote(candidate["model_key"], day=day, reason="gate: passed")
        else:
            # one CAS carries both the decision event and the status move
            written = rec.append_event(self.store, candidate["model_key"],
                                       decision.to_event(), status="rejected")
            if written is None:
                log.error(
                    f"gate rejection of {candidate['model_key']} could not be "
                    "recorded (record unreadable); the checkpoint stays a fallback "
                    "candidate until its record is repaired"
                )
            _count_promotion("rejected")
            log.warning(f"gate REJECTED {candidate['model_key']}: "
                        f"{'; '.join(decision.reasons) or 'policy'}")
        return decision
