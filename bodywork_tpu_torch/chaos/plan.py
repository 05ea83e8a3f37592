"""Seeded, deterministic fault plans — the chaos subsystem's contract
(the port's copy of ``bodywork_tpu.chaos.plan``: the same fields, the
same decision streams, the same JSON plan documents), consumed by the
fault-injecting store (``chaos.store``), the flaky scoring service
(``chaos.http``, ``serve.aio``), the canary stream's latency
(``serve.app``), the at-rest bit rot (``chaos.bitrot``) and the crash
schedule (``chaos.kill``).

A :class:`FaultPlan` holds per-op fault probabilities (transient store
errors, injected latency, crash-after-partial-write, payload corruption,
flaky HTTP 503/429 responses) plus the seed that makes every decision
reproducible. Decisions are NOT drawn from one shared RNG stream —
concurrent threads (the runner's prefetch/compactor workers) would make
the draw order, and therefore the whole run, timing-dependent. Instead
each decision is a pure function of ``(seed, kind, stream, n)`` where
``stream`` identifies the op/key and ``n`` counts that stream's
decisions: the fault sequence seen by any sequential op stream is
byte-reproducible under the same seed regardless of what other threads
are doing. (``random.Random`` seeds strings via SHA-512, so the mapping
is stable across processes and Python's hash randomisation.)

``max_consecutive`` caps how many times in a row one OP STREAM may fail
(a forced-clean execution follows). The cap is enforced across every
failing fault kind together — a put stream's transient and torn-write
faults share one streak, and a ``get_many`` batch is a single failure
unit with its own stream — because independent per-kind caps would
compose: two capped transient faults followed by a first torn-write
fault is three consecutive failures, one more than either cap admits.
With the default cap of 2 — below the retry policy's 3 attempts —
every retried op is GUARANTEED to succeed within its budget, which is
what lets a seeded soak assert bit-exact final artefacts rather than
"usually survives". Set it to 0 (unlimited) to drive breaker-opening
scenarios.

Fault injections are counted as
``bodywork_tpu_chaos_faults_injected_total{kind}`` and appended to
``plan.injected_log`` (the determinism tests' pinned sequence).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import random
import threading
import time

from bodywork_tpu_torch.utils.retry import TransientError

__all__ = [
    "FaultPlan",
    "InjectedFault",
    "activate",
    "get_active_plan",
]


class InjectedFault(TransientError):
    """A chaos-injected transient failure. Subclasses
    :class:`~bodywork_tpu_torch.utils.retry.TransientError`, so the resilience
    layer classifies it exactly like a real 503/connection drop."""


_PROBABILITY_FIELDS = (
    "store_transient_p",
    "store_latency_p",
    "torn_write_p",
    "corrupt_read_p",
    "bit_rot_p",
    "http_error_p",
    "http_latency_p",
    "canary_latency_p",
)


@dataclasses.dataclass
class FaultPlan:
    """Per-op fault probabilities under one seed. All ``*_p`` fields are
    probabilities in [0, 1]; latencies are seconds (kept small so soaks
    stay fast)."""

    seed: int = 0
    #: store ops (put/get/list/delete/get_many): raise InjectedFault
    store_transient_p: float = 0.0
    #: store ops: sleep store_latency_s before the op
    store_latency_p: float = 0.0
    store_latency_s: float = 0.002
    #: put_bytes: persist a PREFIX of the payload, then raise (the
    #: crash-after-partial-write the retry must repair by rewriting)
    torn_write_p: float = 0.0
    #: get_bytes: return truncated payload — only for keys under
    #: corrupt_prefixes, because corrupting a read whose consumer has no
    #: integrity check silently changes results instead of testing
    #: recovery. Safe defaults: the snapshot loader validates and falls
    #: back (``snapshots/``), and registry readers validate the JSON
    #: schema and re-read under the consecutive cap (``registry/`` —
    #: records degrade to absent-with-counter past the budget, the alias
    #: document raises and callers keep current state; see
    #: ``registry/records.py``). The cap (default 2) below the registry
    #: read budget (3 attempts) is what keeps chaos-run gate decisions
    #: byte-identical to the fault-free twin's. ``trainstate/`` readers
    #: (``train/incremental.py``) digest-verify the document under the
    #: same 3-attempt budget; past it they degrade to a full-refit
    #: rebuild — derived state, so corruption can cost one O(history)
    #: day but never a wrong model.
    #:
    #: Contrast with the AT-REST knob below: ``corrupt_prefixes`` scopes
    #: IN-FLIGHT read corruption, so it stays restricted to prefixes
    #: whose readers validate; ``bit_rot_prefixes`` scopes at-rest
    #: corruption, whose detector is the fsck scrub — which audits
    #: EVERY prefix — so its default is the whole store. The two knobs
    #: share this one plan format (and the flag > plan > env
    #: precedence), so a run-sim soak and an fsck soak reproduce from
    #: the same JSON document.
    #: ``tuning/`` readers (``tune/config.py``) schema+digest-validate
    #: and degrade to the built-in serving defaults on any failure —
    #: corruption can cost the tuned knob values for one boot, never a
    #: crash or a wrong artefact, so the prefix is in-flight-corruption
    #: safe by the same argument as ``trainstate/``.
    corrupt_read_p: float = 0.0
    corrupt_prefixes: tuple[str, ...] = (
        "snapshots/", "registry/", "runs/", "trainstate/", "tuning/"
    )
    #: AT-REST bit rot (``chaos/bitrot.py``, ``cli chaos run-sim
    #: --bit-rot``): per-KEY seeded decision over a FINISHED store's
    #: artefacts — bytes flip on disk with timestamps preserved, so no
    #: in-flight hook ever fires and only the integrity scrub
    #: (``cli fsck``) can see it. ``bit_rot_p`` is the per-key rot
    #: probability (the harness additionally forces at least one rotted
    #: key per populated prefix so a sweep always exercises every
    #: auditor); ``bit_rot_max_flips`` bounds the seeded byte flips per
    #: rotted key; ``bit_rot_prefixes`` scopes the damage — empty means
    #: every prefix in ``schema.ALL_PREFIXES``.
    bit_rot_p: float = 0.0
    bit_rot_max_flips: int = 3
    bit_rot_prefixes: tuple[str, ...] = ()
    #: scoring service /score/v1* requests: answer 503 or 429 (split
    #: evenly, deterministically) with a Retry-After header
    http_error_p: float = 0.0
    http_retry_after_s: float = 0.0
    #: scoring service: sleep http_latency_s before handling
    http_latency_p: float = 0.0
    http_latency_s: float = 0.002
    #: adversity addressed to the CANARY stream only: scoring requests
    #: that routed to the live canary sleep canary_latency_s before
    #: dispatch (production-routed requests never consult this) — the
    #: fault the SLO watchdog's p99-latency-ratio breach exists to
    #: catch. Per-canary-model-key decision streams, so a seeded run
    #: replays identical adversity regardless of interleaving.
    canary_latency_p: float = 0.0
    canary_latency_s: float = 0.05
    #: max consecutive faults per (kind, stream) before a forced success;
    #: 0 = unlimited (lets tests hold a backend down to open the breaker)
    max_consecutive: int = 2
    #: process-kill points (``chaos.kill``): a list of
    #: ``{"kind": "stage_boundary", "n": N}`` /
    #: ``{"kind": "store_op", "op": OP, "key": KEY, "n": N}`` objects.
    #: Consumed by the crash soak (``chaos.sim.run_crash_sim`` /
    #: ``cli chaos run-sim --crash-schedule``), which runs each point in
    #: a SUBPROCESS runner (``os._exit`` kills the interpreter) and then
    #: restarts it to prove crash-resume convergence. Like every other
    #: plan field the points are addressed to pure decision streams, so
    #: background-thread interleaving cannot move a kill.
    crash_schedule: tuple = ()

    def __post_init__(self):
        for field in _PROBABILITY_FIELDS:
            p = getattr(self, field)
            if not isinstance(p, (int, float)) or not 0.0 <= p <= 1.0:
                raise ValueError(
                    f"fault plan {field} must be a probability in [0, 1], "
                    f"got {p!r}"
                )
        if self.max_consecutive < 0:
            raise ValueError("max_consecutive must be >= 0 (0 = unlimited)")
        if self.bit_rot_max_flips < 1:
            raise ValueError("bit_rot_max_flips must be >= 1")
        self.corrupt_prefixes = tuple(self.corrupt_prefixes)
        self.bit_rot_prefixes = tuple(self.bit_rot_prefixes)
        if self.crash_schedule:
            from bodywork_tpu_torch.chaos.kill import parse_schedule

            self.crash_schedule = tuple(
                parse_schedule(list(self.crash_schedule))
            )
        self._lock = threading.Lock()
        #: decision count per (kind, stream)
        self._draws: dict[tuple, int] = {}
        #: consecutive-fault count per (kind, stream)
        self._consecutive: dict[tuple, int] = {}
        #: every injected fault, in decision order: (kind, stream, n)
        self.injected_log: list[tuple[str, str, int]] = []

    def reset(self) -> None:
        """Clear all decision history (draw counters, streaks, the
        injected-fault log). A reused plan object must start each run
        from stream position 0 or the 'same seed => same adversity'
        contract silently breaks; :func:`activate` resets on entry so
        every activated run is a fresh replay."""
        with self._lock:
            self._draws.clear()
            self._consecutive.clear()
            self.injected_log.clear()

    # -- (de)serialisation (CLI --plan files / env knobs) ------------------

    def to_dict(self) -> dict:
        return {
            f.name: (
                list(v) if isinstance(v := getattr(self, f.name), tuple) else v
            )
            for f in dataclasses.fields(self)
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "FaultPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise ValueError(
                f"unknown fault-plan field(s) {sorted(unknown)}; "
                f"known: {sorted(known)}"
            )
        return cls(**doc)

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"fault plan {path} must be a JSON object")
        return cls.from_dict(doc)

    @classmethod
    def default(cls, seed: int = 0) -> "FaultPlan":
        """The stock soak plan: every fault kind armed, capped so the
        retry budget always wins."""
        return cls(
            seed=seed,
            store_transient_p=0.15,
            store_latency_p=0.10,
            torn_write_p=0.15,
            corrupt_read_p=0.5,
            http_error_p=0.4,
            http_latency_p=0.2,
        )

    # -- the decision core -------------------------------------------------

    def _decide(self, kind: str, stream: str, p: float) -> bool:
        return self._decide_n(kind, stream, p)[0]

    def _decide_n(
        self, kind: str, stream: str, p: float, capped: bool = True
    ) -> tuple[bool, int]:
        """One seeded decision on the (kind, stream) draw stream. With
        ``capped`` the per-(kind, stream) consecutive cap applies here;
        store failure kinds pass ``capped=False`` because their cap is
        enforced jointly per OP stream by :meth:`store_fault` (caps on
        independent kinds would compose past the retry budget)."""
        if p <= 0.0:
            return False, 0
        with self._lock:
            key = (kind, stream)
            n = self._draws.get(key, 0)
            self._draws[key] = n + 1
            if (
                capped
                and self.max_consecutive
                and self._consecutive.get(key, 0) >= self.max_consecutive
            ):
                self._consecutive[key] = 0
                return False, n  # forced success: the cap bounding adversity
            hit = random.Random(f"{self.seed}|{kind}|{stream}|{n}").random() < p
            self._consecutive[key] = self._consecutive.get(key, 0) + 1 if hit else 0
            if hit:
                self.injected_log.append((kind, stream, n))
                if kind != "http_error":  # counted as http_503/http_429
                    _count_fault(kind)
            return hit, n

    def store_fault(self, op: str, key: str) -> str | None:
        """The ONE failure decision per store-op execution: ``None``
        (clean), ``"transient"``, or (``put_bytes`` only)
        ``"torn_write"``. All failing kinds share a single per-op-stream
        consecutive streak, so ``max_consecutive`` bounds TOTAL
        consecutive failures of the op — the property that keeps every
        retried op inside its attempt budget."""
        stream = f"store|{op}|{key}"
        gate = ("fail", stream)
        with self._lock:
            if (
                self.max_consecutive
                and self._consecutive.get(gate, 0) >= self.max_consecutive
            ):
                self._consecutive[gate] = 0
                return None  # forced-clean execution (no draws consumed)
        hit_transient, _ = self._decide_n(
            "transient", stream, self.store_transient_p, capped=False
        )
        hit_torn = False
        if not hit_transient and op == "put_bytes":
            hit_torn, _ = self._decide_n(
                "torn_write", stream, self.torn_write_p, capped=False
            )
        with self._lock:
            if hit_transient or hit_torn:
                self._consecutive[gate] = self._consecutive.get(gate, 0) + 1
            else:
                self._consecutive[gate] = 0
        if hit_transient:
            return "transient"
        return "torn_write" if hit_torn else None

    # -- store-op hooks (FaultInjectingStore) ------------------------------

    def store_latency(self, op: str, key: str) -> None:
        if self._decide("latency", f"store|{op}|{key}", self.store_latency_p):
            time.sleep(self.store_latency_s)

    def corrupt_read(self, key: str, data: bytes) -> bytes:
        if not key.startswith(tuple(self.corrupt_prefixes)):
            return data
        if self._decide("corrupt", f"store|get_bytes|{key}", self.corrupt_read_p):
            return data[: max(1, len(data) // 2)]
        return data

    # -- at-rest hooks (chaos.bitrot) --------------------------------------

    def bit_rot_decision(self, key: str) -> bool:
        """ONE seeded at-rest rot decision per stored key — consumed by
        the bit-rot injector (``chaos.bitrot.inject_bit_rot``) over a
        finished store, never by an in-flight op. Per-key streams, so a
        sweep replays identically whatever order keys are visited in."""
        prefixes = self.bit_rot_prefixes
        if not prefixes:
            from bodywork_tpu_torch.store.schema import ALL_PREFIXES

            prefixes = ALL_PREFIXES
        if not key.startswith(tuple(prefixes)):
            return False
        return self._decide("bit_rot", f"atrest|{key}", self.bit_rot_p)

    # -- HTTP hooks (FlakyScoringMiddleware) -------------------------------

    def http_latency_delay(self, path: str) -> float | None:
        """Decide-only variant of :meth:`http_latency` for the asyncio
        front-end (``serve.aio``): returns the injected delay in seconds
        (to ``await asyncio.sleep`` — a ``time.sleep`` would stall the
        whole event loop) or None. Same draw stream as the blocking
        form, so either engine replays one seed identically."""
        if self._decide("http_latency", f"http|{path}", self.http_latency_p):
            return self.http_latency_s
        return None

    def http_latency(self, path: str) -> None:
        if self.http_latency_delay(path) is not None:
            time.sleep(self.http_latency_s)

    def canary_latency_delay(self, model_key: str) -> float | None:
        """Canary-stream latency injection: the delay in seconds to
        apply before a canary-routed dispatch, or None. Decide-only so
        the asyncio engine can ``await`` it (the threaded engine sleeps
        via :meth:`canary_latency`); same draw stream either way, so one
        seed replays identically on both engines."""
        if self._decide(
            "canary_latency", f"canary|{model_key}", self.canary_latency_p
        ):
            return self.canary_latency_s
        return None

    def canary_latency(self, model_key: str) -> None:
        if self.canary_latency_delay(model_key) is not None:
            time.sleep(self.canary_latency_s)

    def http_error(self, path: str) -> int | None:
        """503, 429, or None — one decision per scoring request."""
        stream = f"http|{path}"
        hit, n = self._decide_n("http_error", stream, self.http_error_p)
        if not hit:
            return None
        status = (
            503
            if random.Random(f"{self.seed}|http_status|{stream}|{n}").random()
            < 0.5
            else 429
        )
        _count_fault(f"http_{status}")
        return status


def _count_fault(kind: str) -> None:
    from bodywork_tpu_torch.obs import get_registry

    get_registry().counter(
        "bodywork_tpu_chaos_faults_injected_total",
        "Chaos-injected faults by kind",
    ).inc(kind=kind)


#: the process-wide active plan (``activate``); read by the flaky serve
#: stage so a chaos simulation's in-process service picks up the plan
#: without threading it through the pipeline spec
_ACTIVE: FaultPlan | None = None
_ACTIVE_LOCK = threading.Lock()


@contextlib.contextmanager
def activate(plan: FaultPlan):
    """Install ``plan`` as the process-wide active plan for the duration
    of a chaos run (``chaos.sim.run_chaos_sim`` wraps the faulted
    simulation in this). Entry RESETS the plan's decision history, so a
    reused plan object replays the same seeded adversity every run."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a fault plan is already active")
        plan.reset()
        _ACTIVE = plan
    try:
        yield plan
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None


def get_active_plan() -> FaultPlan | None:
    return _ACTIVE
