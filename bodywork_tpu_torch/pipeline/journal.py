"""Durable day-run journal: crash-resumable pipeline runs (the port of
``bodywork_tpu.pipeline.journal``).

A runner that dies between or inside stages (pod eviction, OOM kill,
preemption) must leave enough durable state behind that a restart
converges to the same artefacts without re-running work that completed.
This module is that state: one JSON document per simulated day at
``runs/<date>/journal.json``, mutated only through the store's
compare-and-swap write (``put_bytes_if_match``), as the registry's alias
document is. Its bytes are the JAX package's, so either package resumes,
and is fenced by, a day the other journalled.

Two records live in the document:

- per-stage entries: write-ahead ``intent`` marks before a stage runs
  and ``complete`` marks after, each ``complete`` carrying the stage's
  artefact keys and content digests (sha256 of the bytes, never a
  backend version token). A resuming run skips a completed stage only
  after re-hashing every recorded artefact against the store; a
  mismatch or a missing artefact re-runs the stage. Stages left at
  ``intent`` re-run: every batch stage is a deterministic writer of
  date-keyed keys, so a half-written attempt is overwritten;
- the run lease, ``(owner, expires_at, fence)``, acquired and renewed
  by the same CAS writes. A second runner that finds a live foreign
  lease stops with :class:`LeaseLost` (``cli run-day`` exits 5), and a
  takeover of an expired lease bumps the fence, so the previous holder's
  next CAS fails cleanly.

A corrupt journal degrades to a safe full re-run, never an error: every
read validates the JSON, the schema and the embedded digest and retries
a bounded number of times; a document still unreadable past the budget
keeps its version token, and the next acquire CAS-overwrites it with a
fresh journal.

Counters, the JAX package's: ``bodywork_tpu_runner_journal_corrupt_total``
(reads still invalid past the budget), ``bodywork_tpu_runner_resumes_total
{outcome}`` (how each journalled ``run_day`` started, counted by the
runner: ``fresh``, ``resumed``, ``noop``, ``rerun_mismatch``,
``rerun_corrupt``) and ``bodywork_tpu_runner_lease_events_total{event}``
(``acquired``, ``takeover``, ``lost``). A journal written through a
tenant-scoped store carries the JAX journal's ``tenant`` field; the root
namespace's documents omit it, so they stay byte-identical to
pre-tenancy ones.
"""
from __future__ import annotations

import json
import os
import socket
import time
import uuid
from datetime import date

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.store.schema import run_journal_key
from bodywork_tpu_torch.utils.integrity import sha256_digest, stamp_doc, verify_doc
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("pipeline.journal")

__all__ = [
    "JOURNAL_SCHEMA",
    "LEASE_LOST_EXIT",
    "LeaseLost",
    "RESUMED_NOOP_EXIT",
    "RunJournal",
    "artefact_digest",
    "default_owner",
]

JOURNAL_SCHEMA = "bodywork_tpu.run_journal/1"

#: ``cli run-day`` exit when another runner holds the day's lease — the
#: loser stops cleanly and a CronJob backoff retries later. Distinct
#: from 1 (stage failure), 2 (usage), 8 (rollback refused), 86 (chaos
#: kill), 143 (SIGTERM), and the JAX package's 3, 4 and 7.
LEASE_LOST_EXIT = 5

#: ``cli run-day`` exit when the journal already marked the day complete
#: and every recorded artefact digest verified — nothing re-ran. NOT 0:
#: an operator re-running a day wants to KNOW it was a no-op (and a
#: wrapper that considers it success can `|| test $? -eq 6`).
RESUMED_NOOP_EXIT = 6

#: default lease time-to-live. Renewed on every journal write (one per
#: DAG step boundary), so a live holder effectively never expires; a
#: dead holder's lease blocks a rescheduled twin for at most this long.
#: Env ``BODYWORK_TPU_RUN_LEASE_TTL_S`` overrides (the crash-resume
#: harness shrinks it so restarted runners take over in ~1 s); size it
#: above your longest DAG step in production.
DEFAULT_LEASE_TTL_S = 900.0

#: validation-read retry budget: 1 + retries attempts, as the registry
#: readers', above the JAX package's chaos plan's default cap of 2
#: consecutive corrupt reads, so a seeded soak never escalates to a
#: spurious full re-run.
CORRUPT_READ_RETRIES = 2

#: CAS attempts per journal write before concluding the race is real
_CAS_ATTEMPTS = 4


class LeaseLost(RuntimeError):
    """Another runner holds (or took) this day's run lease. The loser
    must stop writing and exit cleanly — ``cli run-day`` maps this to
    its documented lease-lost exit code so a CronJob's backoff retries
    later instead of fighting the holder."""


def default_owner() -> str:
    """An identity unique per runner process: ``host:pid:nonce`` (the
    nonce disambiguates pid reuse across pod restarts)."""
    return f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"


def artefact_digest(data: bytes) -> str:
    """Content digest recorded per artefact: backend-independent (a
    version token would tie the journal to one backend instance), and
    what resume verification re-hashes (``"sha256:<hex>"``, the registry's
    lineage format)."""
    return sha256_digest(data)


def _journal_tenant(store) -> str | None:
    """The tenant namespace this journal's store is scoped to, or None
    for the root namespace (whose journals omit the field)."""
    from bodywork_tpu_torch.store.schema import DEFAULT_TENANT
    from bodywork_tpu_torch.tenancy.namespace import tenant_of

    tenant = tenant_of(store)
    return None if tenant == DEFAULT_TENANT else tenant


def _count_corrupt() -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_runner_journal_corrupt_total",
        "Run-journal reads that stayed invalid past the retry budget "
        "(each one degrades that day to a safe full re-run)",
    ).inc()


def count_resume(outcome: str) -> None:
    """``bodywork_tpu_runner_resumes_total{outcome}``: how each
    journal-aware ``run_day`` started — ``fresh`` (no prior journal),
    ``resumed`` (some stages skipped), ``noop`` (day already complete,
    nothing re-run), ``rerun_mismatch`` (a recorded digest no longer
    matched the store), ``rerun_corrupt`` (journal unreadable past the
    budget — full re-run)."""
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_runner_resumes_total",
        "run_day journal outcomes by kind",
    ).inc(outcome=outcome)


def _count_lease(event: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_runner_lease_events_total",
        "Run-lease protocol events (acquired/takeover/lost)",
    ).inc(event=event)


def lease_ttl_from_env(default: float = DEFAULT_LEASE_TTL_S) -> float:
    from bodywork_tpu_torch.utils.env import positive_float_env

    return positive_float_env("BODYWORK_TPU_RUN_LEASE_TTL_S", default)


class RunJournal:
    """One day's write-ahead run journal + lease (module docstring).

    Lifecycle::

        journal = RunJournal(store, today)
        prior = journal.acquire()        # raises LeaseLost to a loser
        ... journal.completed_stages() -> what MAY be skipped ...
        journal.record_intents([...])    # before a DAG step executes
        journal.record_completes({stage: {key: digest}})  # after
        journal.record_day_complete()    # releases the lease

    Every mutation is a CAS read-modify-write that re-verifies lease
    ownership; a conflict whose re-read shows a foreign owner raises
    :class:`LeaseLost` and the caller must stop.
    """

    def __init__(
        self,
        store: ArtefactStore,
        day: date,
        owner: str | None = None,
        lease_ttl_s: float | None = None,
        clock=time.time,
    ):
        self.store = store
        self.day = day
        self.key = run_journal_key(day)
        self.owner = owner or default_owner()
        self.lease_ttl_s = (
            lease_ttl_s if lease_ttl_s is not None else lease_ttl_from_env()
        )
        self.clock = clock
        #: True when acquire() found the prior document corrupt past the
        #: retry budget (the runner then re-runs the whole day)
        self.was_corrupt = False
        self._doc: dict | None = None
        self._token = None
        self._prior_status: str | None = None
        self._prior_complete: dict[str, dict] = {}

    # -- reads -------------------------------------------------------------

    def _load(self) -> tuple[dict | None, object, bool]:
        """``(doc_or_None, version_token, corrupt)``. The token is read
        BEFORE the payload (the registry-reader pattern), so a CAS
        against it can only win if nothing changed since; a
        ``(None, token, True)`` triple means the key EXISTS but stays
        invalid past the retry budget — the CAS repair-overwrite case."""
        token = self.store.version_token(self.key)
        corrupt = False
        for _attempt in range(1 + CORRUPT_READ_RETRIES):
            try:
                raw = self.store.get_bytes(self.key)
            except ArtefactNotFound:
                return None, None, False
            try:
                doc = json.loads(raw.decode("utf-8"))
                if (
                    isinstance(doc, dict)
                    and doc.get("schema") == JOURNAL_SCHEMA
                    # embedded content digest (utils.integrity): a bit
                    # flip that leaves the JSON parseable — a digit in a
                    # recorded artefact digest, say — must still read as
                    # corrupt, or resume would trust poisoned state
                    and verify_doc(doc) is not False
                ):
                    return doc, token, False
            except (UnicodeDecodeError, ValueError):
                pass
            corrupt = True
            log.warning(f"corrupt run journal at {self.key!r}; re-reading")
        return None, token, corrupt

    @property
    def doc(self) -> dict | None:
        return self._doc

    @property
    def prior_status(self) -> str | None:
        """The day status the journal held when acquired (``running`` /
        ``complete`` / ``interrupted``), or None for a fresh day."""
        return self._prior_status

    def completed_stages(self) -> dict[str, dict]:
        """Stage entries recorded ``complete`` by a PRIOR run (captured
        at acquire time) — the candidates for verified skipping."""
        return dict(self._prior_complete)

    # -- the lease + write protocol ---------------------------------------

    def _lease_block(self, fence: int) -> dict:
        return {
            "owner": self.owner,
            "expires_at": self.clock() + self.lease_ttl_s,
            "fence": fence,
        }

    def _foreign_live_lease(self, doc: dict) -> dict | None:
        lease = doc.get("lease") or {}
        if (
            lease.get("owner")
            and lease["owner"] != self.owner
            and lease.get("expires_at", 0) > self.clock()
        ):
            return lease
        return None

    def acquire(self) -> dict | None:
        """Take (or retake) the day's run lease, creating the journal if
        absent and CAS-repairing it if corrupt. Returns the PRIOR
        document (None for a fresh day) after stashing its completed
        stages for :meth:`completed_stages`. Raises :class:`LeaseLost`
        when a live foreign lease holds the day."""
        for _attempt in range(_CAS_ATTEMPTS):
            doc, token, corrupt = self._load()
            if corrupt:
                self.was_corrupt = True
                _count_corrupt()
                log.error(
                    f"run journal for {self.day} unreadable past the retry "
                    "budget; repairing with a fresh journal (full re-run)"
                )
                doc = None
            if doc is not None:
                foreign = self._foreign_live_lease(doc)
                if foreign is not None:
                    _count_lease("lost")
                    raise LeaseLost(
                        f"run lease for {self.day} is held by "
                        f"{foreign['owner']!r} until ~{foreign['expires_at']:.0f}"
                    )
            prior = doc
            prior_lease = (doc or {}).get("lease") or {}
            takeover = bool(
                prior_lease.get("owner")
                and prior_lease["owner"] != self.owner
            )
            new_doc = {
                "schema": JOURNAL_SCHEMA,
                "day": str(self.day),
                "status": (doc or {}).get("status", "running"),
                "stages": dict((doc or {}).get("stages") or {}),
                "lease": self._lease_block(
                    int(prior_lease.get("fence", 0)) + 1
                ),
            }
            tenant = _journal_tenant(self.store)
            if tenant is not None:
                new_doc["tenant"] = tenant  # provenance; the root omits it
            try:
                self._token = self.store.put_bytes_if_match(
                    self.key, _dumps(new_doc), token
                )
            except CasConflict:
                continue  # someone raced the acquire: re-read and re-decide
            self._doc = new_doc
            self._prior_status = (prior or {}).get("status")
            self._prior_complete = {
                name: entry
                for name, entry in ((prior or {}).get("stages") or {}).items()
                if entry.get("state") == "complete"
            }
            _count_lease("takeover" if takeover else "acquired")
            if takeover:
                log.warning(
                    f"took over the {self.day} run lease from expired "
                    f"holder {prior_lease.get('owner')!r} "
                    f"(fence {new_doc['lease']['fence']})"
                )
            return prior
        _count_lease("lost")
        raise LeaseLost(
            f"could not acquire the {self.day} run lease in "
            f"{_CAS_ATTEMPTS} attempts (persistent CAS contention)"
        )

    def _write(self, mutate, release: bool = False) -> None:
        """CAS read-modify-write of the journal under our lease:
        ``mutate(doc)`` edits in place; every write renews the lease —
        or, with ``release=True``, clears it in the SAME CAS (fence
        kept, so the next acquirer still bumps past us). A conflict
        re-reads — a foreign owner (live or not: someone ELSE wrote,
        our exclusivity is gone) raises :class:`LeaseLost`."""
        assert self._doc is not None, "acquire() before writing"
        doc = self._doc
        for _attempt in range(_CAS_ATTEMPTS):
            new_doc = {
                **doc,
                "stages": {
                    name: dict(entry)
                    for name, entry in (doc.get("stages") or {}).items()
                },
            }
            mutate(new_doc)
            fence = int((doc.get("lease") or {}).get("fence", 1))
            if release:
                new_doc["lease"] = {
                    "owner": None, "expires_at": 0.0, "fence": fence,
                }
            else:
                new_doc["lease"] = self._lease_block(fence)
            try:
                self._token = self.store.put_bytes_if_match(
                    self.key, _dumps(new_doc), self._token
                )
            except CasConflict:
                fresh, token, corrupt = self._load()
                if corrupt or fresh is None or (
                    (fresh.get("lease") or {}).get("owner") != self.owner
                ):
                    _count_lease("lost")
                    raise LeaseLost(
                        f"run lease for {self.day} was taken over "
                        "mid-run; stopping"
                    ) from None
                doc, self._token = fresh, token
                continue
            self._doc = new_doc
            return
        raise LeaseLost(
            f"journal write for {self.day} kept losing CAS races"
        )

    # -- stage records -----------------------------------------------------

    def record_intents(self, names: list[str]) -> None:
        """Write-ahead marks: these stages are ABOUT to execute (and may
        be found half-done by a resuming run, which re-executes them)."""

        def _mutate(doc: dict) -> None:
            for name in names:
                doc["stages"][name] = {"state": "intent"}
            doc["status"] = "running"

        self._write(_mutate)

    def record_completes(self, artefacts_by_stage: dict[str, dict]) -> None:
        """Mark stages complete, each with its ``{artefact key: content
        digest}`` map (empty for stages with nothing verifiable — a
        resuming run re-executes those rather than trusting blindly)."""

        def _mutate(doc: dict) -> None:
            for name, artefacts in artefacts_by_stage.items():
                doc["stages"][name] = {
                    "state": "complete",
                    "artefacts": dict(artefacts),
                }

        self._write(_mutate)

    def record_day_complete(self) -> None:
        """The whole day converged: ONE CAS marking ``complete`` AND
        releasing the lease (a later duplicate run sees a free, finished
        journal and exits resumed-noop without waiting on any TTL)."""
        self._write(
            lambda doc: doc.__setitem__("status", "complete"), release=True
        )

    def record_interrupted(self) -> None:
        """Graceful-shutdown mark (SIGTERM): the day stops cleanly
        mid-run; in-flight stages keep their ``intent`` entries, the
        lease is released in the same CAS so the rescheduled pod starts
        immediately instead of waiting out the TTL. Best-effort — a
        lease lost here just means a successor is already running."""
        try:
            self._write(
                lambda doc: doc.__setitem__("status", "interrupted"),
                release=True,
            )
        except Exception as exc:  # noqa: BLE001 — shutdown path
            log.warning(f"could not journal the interruption: {exc!r}")

    def release(self) -> None:
        """Release the lease without changing anything else — the
        resumed-noop and stage-failure exits (the day's status already
        says what happened; holding the lease for the TTL would only
        stall the next attempt). Best-effort, same rationale as
        :meth:`record_interrupted`."""
        try:
            self._write(lambda doc: None, release=True)
        except Exception as exc:  # noqa: BLE001 — exit path
            log.warning(f"could not release the run lease: {exc!r}")

    # -- resume verification ----------------------------------------------

    def verify_completed(self) -> tuple[dict[str, dict], bool]:
        """Re-hash every prior-``complete`` stage's recorded artefacts
        against the store. Returns ``(verified entries, any_mismatch)``:
        only stages whose EVERY artefact digest matches are returned;
        entries with no artefacts recorded are never returned (nothing
        verifiable means nothing skippable)."""
        verified: dict[str, dict] = {}
        mismatch = False
        for name, entry in self.completed_stages().items():
            artefacts = entry.get("artefacts") or {}
            if not artefacts:
                continue
            ok = True
            for key, digest in artefacts.items():
                try:
                    data = self.store.get_bytes(key)
                except ArtefactNotFound:
                    ok = False
                    break
                if artefact_digest(data) != digest:
                    ok = False
                    break
            if ok:
                verified[name] = entry
            else:
                mismatch = True
                log.warning(
                    f"journalled stage {name!r} failed digest "
                    "verification; re-running it"
                )
        return verified, mismatch


def _dumps(doc: dict) -> bytes:
    # every write stamps the embedded content digest, so a journal's
    # validity is verifiable without any out-of-band record — the
    # property the integrity scrubber's runs/ auditor rides
    return json.dumps(
        stamp_doc(doc), sort_keys=True, indent=1
    ).encode("utf-8")
