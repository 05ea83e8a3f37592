"""Chaos soak: a seeded faulted simulation proven against a clean twin
(the port's copy of ``bodywork_tpu.chaos.sim``: the same twins, fault
plan, comparison rules and summary; both twins compute on ``device``, the
card unless the caller asks for the CPU).

``run_chaos_sim`` runs the SAME N-day pipeline simulation twice under
one roof:

1. **baseline** — the canonical pipeline on a plain filesystem store;
2. **faulted** — the same pipeline with the full resilience stack over
   a fault-injecting store (``real <- FaultInjectingStore <-
   ResilientStore``) and the scoring service in flaky mode
   (``chaos.http.flaky_serve_stage``), all driven by one seeded
   :class:`~bodywork_tpu_torch.chaos.plan.FaultPlan`.

then compares the two stores' FINAL artefacts:

- ``datasets/``, ``models/``, ``model-metrics/`` must be
  **byte-identical** — training, generation, and checkpointing are
  deterministic, so any divergence means a fault leaked into results;
- ``test-metrics/`` must be identical after dropping the
  ``mean_response_time`` column (the one wall-clock-dependent field; in
  particular ``n_failures`` must match the baseline's zeros — the
  scoring client's status retries must have absorbed every injected
  503/429);
- the latest ``snapshots/`` artefact must be loadable (not torn) and
  cover the same day keys and row counts (snapshot bytes embed backend
  version tokens, which legitimately differ between stores);
- no torn artefacts: no leftover atomic-write temp files, snapshot
  validation passes.

Passing proves the resilience layer end to end: every injected
transient error, latency spike, crash-after-partial-write, corrupt
snapshot read, and flaky scoring response was absorbed without touching
the results. The fault plan's ``max_consecutive`` cap (kept below the
retry policy's attempt budget) is what makes this a guarantee instead
of a probability.
"""
from __future__ import annotations

from datetime import date
from pathlib import Path

from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.filesystem import FilesystemStore
from bodywork_tpu_torch.store.resilient import ResilientStore
from bodywork_tpu_torch.store.schema import (
    AUDIT_DIGESTS_PREFIX,
    AUDIT_PREFIX,
    FLIGHTREC_PREFIX,
    QUARANTINE_PREFIX,
    RUNS_PREFIX,
    SERVE_PREFIX,
    SNAPSHOTS_PREFIX,
    TEST_METRICS_PREFIX,
)
from bodywork_tpu_torch.chaos.plan import FaultPlan, activate
from bodywork_tpu_torch.chaos.store import FaultInjectingStore
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("chaos.sim")

__all__ = [
    "chaos_pipeline_spec",
    "compare_stores",
    "run_chaos_sim",
    "run_crash_sim",
    "sweep_points",
]

#: counters whose per-run delta the summary reports
_FAULT_COUNTER = "bodywork_tpu_chaos_faults_injected_total"
_RETRY_COUNTERS = (
    "bodywork_tpu_store_retries_total",
    "bodywork_tpu_scoring_client_retries_total",
)


def _apply_train_mode(spec, train_mode: str, model_kwargs: dict | None = None):
    """PIN the train stages' mode arg — always set explicitly, even for
    ``full``: an absent arg falls through to BODYWORK_TPU_TRAIN_MODE in
    ``train_stage``, and an exported env knob silently overriding an
    explicit ``--train-mode full`` would soak (and report PASS for) the
    wrong mode. ``model_kwargs`` (the port's addition: an MLP's widths and
    steps, as ``run-sim --mlp-hidden`` gives them) join the train args."""
    from bodywork_tpu_torch.train.trainer import TRAIN_MODES

    if train_mode not in TRAIN_MODES:
        raise ValueError(
            f"unknown train mode {train_mode!r}; expected one of "
            f"{TRAIN_MODES}"
        )
    for stage in spec.stages.values():
        if stage.executable.endswith(":train_stage"):
            stage.args = {**stage.args, **(model_kwargs or {}), "mode": train_mode}
    return spec


def chaos_pipeline_spec(model_type: str = "linear",
                        scoring_mode: str = "batch",
                        train_mode: str = "full",
                        model_kwargs: dict | None = None):
    """The canonical daily pipeline with the serve stage swapped for the
    flaky-mode wrapper (identical spec otherwise, so the faulted run's
    work plan matches the baseline's exactly)."""
    from bodywork_tpu_torch.pipeline import default_pipeline

    spec = _apply_train_mode(
        default_pipeline(model_type, scoring_mode), train_mode, model_kwargs
    )
    spec.stages["stage-2-serve-model"].executable = (
        "bodywork_tpu_torch.chaos.http:flaky_serve_stage"
    )
    return spec


def _strip_csv_column(data: bytes, column: str) -> bytes:
    """Remove one column from CSV bytes, textually (no float reparsing —
    every surviving byte still has to match exactly)."""
    lines = data.decode("utf-8").splitlines()
    if not lines:
        return data
    header = lines[0].split(",")
    if column not in header:
        return data
    idx = header.index(column)
    out = []
    for line in lines:
        fields = line.split(",")
        del fields[idx]
        out.append(",".join(fields))
    return ("\n".join(out) + "\n").encode("utf-8")


def _snapshot_coverage(store: ArtefactStore):
    """``[(day key, rows), ...]`` of the latest loadable snapshot, or
    None when no snapshot loads (absent or torn)."""
    from bodywork_tpu_torch.data.snapshot import load_latest_snapshot

    snap = load_latest_snapshot(store, record_outcome=False)
    if snap is None:
        return None
    return sorted((e["key"], e["rows"]) for e in snap.entries)


def _journals_ok(store: ArtefactStore) -> bool:
    """Every ``runs/`` journal must parse and be day-complete — the
    OPERATIONAL check replacing byte comparison for this prefix (lease
    owners and expiry wall-clocks legitimately differ between twins)."""
    import json

    from bodywork_tpu_torch.pipeline.journal import JOURNAL_SCHEMA

    for key in store.list_keys(RUNS_PREFIX):
        try:
            doc = json.loads(store.get_bytes(key).decode("utf-8"))
        except (UnicodeDecodeError, ValueError):
            return False
        if not isinstance(doc, dict) or doc.get("schema") != JOURNAL_SCHEMA:
            return False
        if doc.get("status") != "complete":
            return False
    return True


#: prefixes excluded from the byte-identity comparison: snapshots embed
#: backend version tokens (coverage-compared instead), journals embed
#: lease identities and wall-clocks (validity-checked instead),
#: quarantine/ holds per-incident evidence only one twin can have, and
#: the audit sidecars OF test-metrics and snapshots record digests over
#: bytes that embed a wall-clock column / backend tokens respectively
#: (the metrics themselves are compared with the column stripped, the
#: snapshots coverage-compared; their sidecars hash the raw bytes)
_COMPARE_EXCLUDED = (
    SNAPSHOTS_PREFIX,
    RUNS_PREFIX,
    QUARANTINE_PREFIX,
    AUDIT_DIGESTS_PREFIX + TEST_METRICS_PREFIX,
    AUDIT_DIGESTS_PREFIX + SNAPSHOTS_PREFIX,
    # flight-recorder dumps are verdict evidence only one twin can hold
    # (the faulted twin runs with tracing enabled; the baseline runs
    # tracing-off) — excluded WITH their sidecars, exactly like
    # quarantine/. Everything else must stay byte-identical with
    # tracing on: trace ids ride only a response header.
    FLIGHTREC_PREFIX,
    AUDIT_DIGESTS_PREFIX + FLIGHTREC_PREFIX,
    # the serving-plane leader lease embeds owner host:pid:nonce and
    # wall-clock expiry — operational state, never artefact data; each
    # twin elects its own dispatcher so the docs can never match
    SERVE_PREFIX,
    AUDIT_DIGESTS_PREFIX + SERVE_PREFIX,
)


def compare_stores(
    baseline: ArtefactStore,
    chaos: ArtefactStore,
    extra_excluded: tuple = (),
) -> dict:
    """Final-artefact comparison (module docstring has the rules).
    ``extra_excluded`` adds caller-specific prefix exclusions (the
    bit-rot soak excludes ``trainstate/`` when the repair policy for it
    is drop-and-rebuild-next-run)."""
    excluded = _COMPARE_EXCLUDED + tuple(extra_excluded)
    base_keys = [
        k for k in baseline.list_keys() if not k.startswith(excluded)
    ]
    chaos_keys = [
        k for k in chaos.list_keys() if not k.startswith(excluded)
    ]
    missing = sorted(set(base_keys) - set(chaos_keys))
    extra = sorted(set(chaos_keys) - set(base_keys))
    mismatched: list[str] = []
    matched = 0
    for key in sorted(set(base_keys) & set(chaos_keys)):
        a = baseline.get_bytes(key)
        b = chaos.get_bytes(key)
        if key.startswith(TEST_METRICS_PREFIX):
            a = _strip_csv_column(a, "mean_response_time")
            b = _strip_csv_column(b, "mean_response_time")
        if a == b:
            matched += 1
        else:
            mismatched.append(key)
    torn: list[str] = []
    for store in (baseline, chaos):
        root = getattr(store, "root", None)
        if root is not None:
            torn.extend(
                str(p.relative_to(root))
                for p in Path(root).rglob(".tmp-*")
                # CAS sidecar locks are deliberately persistent (the
                # flock protocol must never unlink them — filesystem.py
                # _acquire_cas_lock), not abandoned write temp files
                if not p.name.startswith(".tmp-lock.")
            )
    base_cov = _snapshot_coverage(baseline)
    chaos_cov = _snapshot_coverage(chaos)
    snapshot_ok = base_cov == chaos_cov and (
        base_cov is not None or not baseline.list_keys(SNAPSHOTS_PREFIX)
    )
    if chaos_cov is None and chaos.list_keys(SNAPSHOTS_PREFIX):
        torn.append(f"{SNAPSHOTS_PREFIX} (latest snapshot unreadable)")
    journal_ok = _journals_ok(baseline) and _journals_ok(chaos)
    return {
        "matched": matched,
        "missing": missing,
        "extra": extra,
        "mismatched": mismatched,
        "torn": torn,
        "snapshot_ok": snapshot_ok,
        "journal_ok": journal_ok,
        "ok": (
            not (missing or extra or mismatched or torn)
            and snapshot_ok
            and journal_ok
        ),
    }


def _counter_values(name: str) -> dict[tuple, float]:
    from bodywork_tpu_torch.obs import get_registry

    metric = get_registry().get(name)
    if metric is None:
        return {}
    return {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in metric.snapshot_samples()
    }


def _counter_delta(name: str, before: dict) -> dict[str, float]:
    out = {}
    for labels, value in _counter_values(name).items():
        delta = value - before.get(labels, 0.0)
        if delta:
            out[",".join(f"{k}={v}" for k, v in labels)] = delta
    return out


def run_chaos_sim(
    root: str | Path,
    start: date,
    days: int,
    plan: FaultPlan,
    model_type: str = "linear",
    scoring_mode: str = "batch",
    drift=None,
    train_mode: str = "full",
    device=None,
    model_kwargs: dict | None = None,
) -> dict:
    """Run the baseline and faulted simulations under ``root`` (in
    ``baseline/`` and ``chaos/`` subdirectories, which must not already
    hold artefacts) and return the comparison + fault/retry summary. The
    port adds to the JAX summary each twin's ``seconds`` and the
    breaker's ``breaker_opens``; both twins compute on ``device`` (the
    card unless the caller asks for the CPU), the model built with
    ``model_kwargs``.

    ``train_mode="incremental"`` runs BOTH twins through the
    incremental-training path (``train/incremental.py``), putting the
    ``trainstate/`` sufficient-statistics artefact in the byte-identity
    comparison's scope — corrupt reads of it (it is in the default
    ``corrupt_prefixes``) must degrade to a rebuild that converges to
    the same bytes as the fault-free twin's."""
    import time

    from bodywork_tpu_torch.obs.tracing import configured_tracing
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
    from bodywork_tpu_torch.utils.retry import CircuitBreaker

    root = Path(root)
    baseline_dir, chaos_dir = root / "baseline", root / "chaos"
    for d in (baseline_dir, chaos_dir):
        if d.exists() and any(d.iterdir()):
            raise ValueError(
                f"chaos sim target {d} already holds artefacts; point "
                "--store at a fresh directory (the comparison needs two "
                "clean stores)"
            )
    before = {
        name: _counter_values(name)
        for name in (_FAULT_COUNTER, *_RETRY_COUNTERS)
    }

    log.info(f"chaos sim: baseline run ({days} day(s)) -> {baseline_dir}")
    baseline_store = FilesystemStore(baseline_dir)
    t0 = time.perf_counter()
    with configured_tracing(0.0):  # the tracing-OFF twin
        LocalRunner(
            _apply_train_mode(
                default_pipeline(model_type, scoring_mode), train_mode, model_kwargs
            ),
            baseline_store,
            drift=drift,
            device=device,
        ).run_simulation(start, days)
    baseline_s = time.perf_counter() - t0

    log.info(
        f"chaos sim: faulted run (seed={plan.seed}) -> {chaos_dir}"
    )
    real_store = FilesystemStore(chaos_dir)
    opens = []
    breaker = CircuitBreaker(
        on_state_change=lambda state: opens.append(state) if state == "open" else None)
    wrapped = ResilientStore(FaultInjectingStore(real_store, plan), breaker=breaker)
    t0 = time.perf_counter()
    # the faulted twin runs with request tracing ON at full head
    # sampling (obs.tracing): the byte-identity comparison below is
    # therefore ALSO the proof that tracing never leaks into response
    # bodies or store artefacts outside obs/flightrec/
    with activate(plan), configured_tracing(1.0, seed=plan.seed):
        LocalRunner(
            chaos_pipeline_spec(model_type, scoring_mode, train_mode, model_kwargs),
            wrapped,
            drift=drift,
            device=device,
        ).run_simulation(start, days)
    faulted_s = time.perf_counter() - t0

    comparison = compare_stores(baseline_store, real_store)
    summary = {
        "days": days,
        "seed": plan.seed,
        "plan": plan.to_dict(),
        "comparison": comparison,
        "faults_injected": _counter_delta(_FAULT_COUNTER, before[_FAULT_COUNTER]),
        "retries": {
            name: _counter_delta(name, before[name])
            for name in _RETRY_COUNTERS
        },
        "breaker_state": wrapped.breaker.state,
        "breaker_opens": len(opens),
        "seconds": {"baseline": baseline_s, "faulted": faulted_s},
        # the faulted twin ran with tracing at full head sampling while
        # the baseline ran tracing-off: the comparison above is the
        # tracing byte-identity proof
        "tracing": {"faulted_sample_fraction": 1.0, "baseline": "off"},
        "ok": comparison["ok"],
    }
    return summary


# -- the crash soak: process death as a swept input ------------------------

#: restart attempts after a kill before giving up on the lease handover
#: (the harness shrinks the lease TTL, so the dead twin's lease expires
#: well inside one child's interpreter start-up; the retries absorb an
#: unusually fast restart racing the clock)
_RESTART_ATTEMPTS = 20
_RESTART_WAIT_S = 0.5


def sweep_points(
    days: int,
    n_steps: int,
    artefact_keys=(),
    seed: int = 0,
    store_op_samples: int = 2,
) -> list[dict]:
    """Enumerate the every-boundary kill schedule for a ``days``-day sim
    over an ``n_steps``-step DAG: one ``stage_boundary`` point per step
    barrier (``run_day`` hits one before each step plus one after the
    last, so ``days * (n_steps + 1)`` in all) plus ``store_op_samples``
    seeded MID-STAGE points — the first ``put_bytes`` of a result
    artefact key drawn from ``artefact_keys`` by the same pure
    ``(seed, kind, op, n)`` addressing every chaos decision uses (the
    kill lands before the op executes: death with the artefact
    unwritten). Keys under ``audit/`` are never drawn (see below)."""
    import random

    points: list[dict] = [
        {"kind": "stage_boundary", "n": n}
        for n in range(days * (n_steps + 1))
    ]
    # audit/ sidecars are written by the AuditedStore the kill switch
    # wraps, below it, so a kill addressed to one never fires; the JAX
    # package draws them too, and its sweep then fails a point that no
    # run can hit (the port's one departure from its sweep)
    eligible = sorted(
        k for k in artefact_keys
        if not k.startswith((RUNS_PREFIX, SNAPSHOTS_PREFIX, AUDIT_PREFIX))
        and not k.startswith("registry/")
    )
    if eligible and store_op_samples > 0:
        rng = random.Random(seed)
        for key in rng.sample(eligible, min(store_op_samples, len(eligible))):
            points.append(
                {"kind": "store_op", "op": "put_bytes", "key": key, "n": 0}
            )
    return points


def _runner_cmd(store_dir, start: date, days: int, model_type: str,
                scoring_mode: str, samples_per_day: int | None,
                device: str) -> list[str]:
    import sys

    cmd = [
        sys.executable, "-m", "bodywork_tpu_torch.cli", "run-sim",
        "--store", str(store_dir), "--days", str(days),
        "--date", str(start), "--model", model_type, "--mode", scoring_mode,
        "--device", device,
    ]
    if samples_per_day is not None:
        cmd += ["--samples-per-day", str(samples_per_day)]
    return cmd


def _run_child(cmd: list[str], env: dict, timeout_s: float) -> tuple[int, str]:
    """Run one child runner; returns ``(exit code, output tail)``."""
    import subprocess

    proc = subprocess.run(
        cmd, env=env, capture_output=True, text=True, timeout=timeout_s
    )
    tail = ((proc.stdout or "") + "\n" + (proc.stderr or ""))[-2000:]
    return proc.returncode, tail


def run_crash_sim(
    root: str | Path,
    start: date,
    days: int,
    seed: int = 0,
    points: list[dict] | None = None,
    store_op_samples: int = 2,
    model_type: str = "linear",
    scoring_mode: str = "batch",
    samples_per_day: int | None = None,
    lease_ttl_s: float = 0.5,
    child_timeout_s: float = 900.0,
    device=None,
) -> dict:
    """The crash-resume soak (``cli chaos run-sim --crash-schedule``):
    prove that killing the runner PROCESS at any point converges.

    One uninterrupted twin runs the N-day sim in a subprocess under
    ``root/baseline``. Then, per kill point (every stage boundary plus
    seeded mid-stage store-op points by default — :func:`sweep_points`),
    a fresh store gets a child runner armed with that single point via
    ``BODYWORK_TPU_CRASH_SCHEDULE``; the child must die there
    (``os._exit`` — exit code :data:`chaos.kill.EXIT_KILLED`, no
    cleanup, the in-process equivalent of OOM-kill), and an unarmed
    restart must take over the shrunken lease, resume from the journal,
    and finish with final artefacts BYTE-IDENTICAL to the baseline
    (``compare_stores``, now covering process death). A point the child
    sails past without dying fails the sweep — a kill that never fires
    would prove nothing, vacuously. Every child computes on ``device``
    (``run-sim --device``: the card unless the caller asks for the CPU);
    ``seconds`` in each result is the point's kill-plus-restart wall
    clock."""
    import json as _json
    import os as _os
    import time as _time

    from bodywork_tpu_torch.chaos.kill import EXIT_KILLED, parse_schedule
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.pipeline import default_pipeline
    from bodywork_tpu_torch.pipeline.journal import LEASE_LOST_EXIT

    device = resolve_device(device).type

    root = Path(root)
    baseline_dir = root / "baseline"
    if root.exists() and any(root.iterdir()):
        # a reused root is worse than a reused baseline: stale crash-NNN
        # stores hold completed journals, so the armed child would
        # resume-noop past its kill point and fail as "never fired"
        raise ValueError(
            f"crash sim target {root} already holds artefacts; point "
            "--store at a fresh directory"
        )
    base_env = {
        k: v for k, v in _os.environ.items()
        if k not in ("BODYWORK_TPU_CRASH_SCHEDULE",)
    }
    base_env["BODYWORK_TPU_RUN_LEASE_TTL_S"] = str(lease_ttl_s)
    # children must import THIS checkout's bodywork_tpu even when it is
    # not installed (dev tree, CI): prepend the package's parent dir
    import bodywork_tpu_torch as _pkg

    pkg_root = str(Path(_pkg.__file__).resolve().parents[1])
    base_env["PYTHONPATH"] = _os.pathsep.join(
        p for p in (pkg_root, base_env.get("PYTHONPATH")) if p
    )
    cmd = _runner_cmd(baseline_dir, start, days, model_type, scoring_mode,
                      samples_per_day, device)
    log.info(f"crash sim: uninterrupted twin ({days} day(s)) -> {baseline_dir}")
    code, tail = _run_child(cmd, base_env, child_timeout_s)
    if code != 0:
        raise RuntimeError(
            f"crash sim baseline run failed (exit {code}):\n{tail}"
        )
    baseline_store = FilesystemStore(baseline_dir)

    if points is None:
        n_steps = len(default_pipeline(model_type, scoring_mode).dag)
        points = sweep_points(
            days, n_steps, baseline_store.list_keys(), seed=seed,
            store_op_samples=store_op_samples,
        )
    else:
        points = parse_schedule(list(points))

    results = []
    for i, point in enumerate(points):
        crash_dir = root / f"crash-{i:03d}"
        cmd = _runner_cmd(crash_dir, start, days, model_type, scoring_mode,
                          samples_per_day, device)
        t0 = _time.perf_counter()
        kill_env = dict(
            base_env,
            BODYWORK_TPU_CRASH_SCHEDULE=_json.dumps([point]),
        )
        code, tail = _run_child(cmd, kill_env, child_timeout_s)
        entry = {"point": point, "kill_exit": code, "ok": False}
        entry["seconds"] = _time.perf_counter() - t0
        if code != EXIT_KILLED:
            # exit 0 = the point never fired (vacuous; fails the sweep),
            # anything else = the child died of something OTHER than the
            # scheduled kill
            entry["error"] = (
                "kill point never fired" if code == 0
                else f"child failed before the kill point (exit {code})"
            )
            entry["tail"] = tail
            results.append(entry)
            log.error(f"crash point {point}: {entry['error']}")
            continue
        # restart, unarmed: must take over the expired lease and resume
        for attempt in range(_RESTART_ATTEMPTS):
            code, tail = _run_child(cmd, base_env, child_timeout_s)
            if code != LEASE_LOST_EXIT:
                break
            _time.sleep(_RESTART_WAIT_S)
        entry["restart_exit"] = code
        entry["seconds"] = _time.perf_counter() - t0
        if code != 0:
            entry["error"] = f"restart did not converge (exit {code})"
            entry["tail"] = tail
            results.append(entry)
            log.error(f"crash point {point}: {entry['error']}")
            continue
        comparison = compare_stores(baseline_store, FilesystemStore(crash_dir))
        entry["comparison"] = comparison
        entry["ok"] = comparison["ok"]
        results.append(entry)
        log.info(
            f"crash point {i + 1}/{len(points)} {point}: "
            + ("converged byte-identical" if entry["ok"]
               else f"DIVERGED {comparison}")
        )
    return {
        "days": days,
        "seed": seed,
        "points": len(points),
        "results": results,
        "ok": bool(results) and all(r["ok"] for r in results),
    }
