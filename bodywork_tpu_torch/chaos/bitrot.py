"""At-rest bit-rot chaos: silent disk corruption as a seeded, swept input
(the port's copy of ``bodywork_tpu.chaos.bitrot``: the same seed rots the
same bytes of the same keys).

The chaos soak makes *in-flight* failure deterministic (faults injected
at store ops); the crash soak makes *process death* deterministic. This module
covers the last silent failure mode: bytes rotting ON DISK while nobody
reads them. The injector flips seeded bytes inside a finished store's
artefacts **in place, with file timestamps preserved**, so no store op
ever fires, no version token changes, and no read-time validator is
consulted — the corruption is invisible to every lazy check in the
system. The only thing that can find it is the integrity scrub
(:mod:`bodywork_tpu_torch.audit.fsck`), which is exactly the point.

``run_bit_rot_sim`` (``cli chaos run-sim --bit-rot``) is the acceptance
harness: run the same N-day simulation into two audited stores (the
twins are byte-identical by the determinism the chaos soak already
proves), rot seeded keys across EVERY populated prefix of one twin,
then require

1. **100% detection**: every injected corruption surfaces as a
   non-advisory fsck finding, classified by the severity taxonomy;
2. **self-healing convergence**: ``run_fsck(repair=True)`` leaves the
   victim byte-identical to the healthy twin outside ``quarantine/``
   (and the journal/snapshot operational checks still pass);
3. **zero silent passes**: a post-repair scrub reports no actionable
   findings.

Injection rules that keep the sweep honest rather than unwinnable:

- flips land on non-whitespace bytes (a whitespace-to-whitespace flip
  inside a canonically-digested JSON document changes no content — it
  would be injecting nothing);
- a rotted key PROTECTS its redundancy partner (a primary protects its
  digest sidecar and vice versa; a rotted dataset day protects the
  latest snapshot it restores from; a rotted latest snapshot protects
  the dataset days only it could restore) — rotting both halves of a
  redundancy pair is engineering data loss on purpose, which the
  taxonomy already covers and the convergence bar cannot;
- every populated prefix gets at least one rotted key (seeded forced
  pick) so a sweep exercises every auditor, not just the lucky ones.
"""
from __future__ import annotations

import os
import random
from datetime import date
from pathlib import Path

from bodywork_tpu_torch.chaos.plan import FaultPlan
from bodywork_tpu_torch.store.filesystem import FilesystemStore
from bodywork_tpu_torch.store.schema import (
    ALL_PREFIXES,
    DATASETS_PREFIX,
    SNAPSHOTS_PREFIX,
    TRAINSTATE_PREFIX,
    audit_digest_key,
    audit_primary_key,
)
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("chaos.bitrot")

__all__ = ["inject_bit_rot", "run_bit_rot_sim"]

_WHITESPACE = b" \t\r\n"


def _flip_bytes(root: Path, key: str, plan: FaultPlan) -> list[int] | None:
    """Apply seeded in-place byte flips to ``root/key``, preserving the
    file's timestamps (true bit rot does not touch mtime, so version
    tokens — and therefore every token-keyed cache and staleness check
    — keep trusting the artefact). Returns the flipped positions, or
    None when the file holds no flippable byte."""
    path = root / key
    data = path.read_bytes()
    eligible = [i for i, b in enumerate(data) if b not in _WHITESPACE]
    if not eligible:
        return None
    rng = random.Random(f"{plan.seed}|bit_rot_bytes|{key}")
    n = 1 + rng.randrange(plan.bit_rot_max_flips)
    positions = sorted(rng.sample(eligible, min(n, len(eligible))))
    st = path.stat()
    with open(path, "r+b") as f:
        for pos in positions:
            f.seek(pos)
            f.write(bytes([data[pos] ^ rng.randrange(1, 256)]))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
    return positions


def _protect_partners(
    key: str, protected: set, store: FilesystemStore
) -> None:
    """Mark the redundancy partners a rotted ``key`` must leave intact
    (module docstring): its sidecar/primary, and across the
    dataset <-> snapshot restore axis."""
    protected.add(audit_digest_key(key))
    primary = audit_primary_key(key)
    if primary is not None:
        protected.add(primary)
    if key.startswith(DATASETS_PREFIX):
        hist = store.history(SNAPSHOTS_PREFIX)
        if hist:
            protected.add(hist[-1][0])  # the restore source
    if key.startswith(SNAPSHOTS_PREFIX):
        hist = store.history(SNAPSHOTS_PREFIX)
        if hist and key == hist[-1][0]:
            # rotting the LATEST snapshot: the older kept one may not
            # cover the newest day, so dataset rot is now off the table
            protected.update(store.list_keys(DATASETS_PREFIX))


def inject_bit_rot(
    store: FilesystemStore,
    plan: FaultPlan,
    ensure_per_prefix: bool = True,
) -> list[dict]:
    """Seeded at-rest corruption sweep over ``store`` (module
    docstring). Returns one entry per rotted key:
    ``{"key", "prefix", "positions"}``."""
    root = Path(store.root)
    protected: set[str] = set()
    injected: list[dict] = []

    def _rot(key: str, prefix: str, forced: bool) -> bool:
        positions = _flip_bytes(root, key, plan)
        if positions is None:
            return False
        _protect_partners(key, protected, store)
        injected.append(
            {"key": key, "prefix": prefix, "positions": positions,
             "forced": forced}
        )
        return True

    rotted = {p: 0 for p in ALL_PREFIXES}
    scope = plan.bit_rot_prefixes or ALL_PREFIXES
    # one pass per prefix, probabilistic rots then (if none landed) a
    # forced seeded pick — IN ALL_PREFIXES ORDER, which is load-bearing:
    # datasets rot before snapshots are considered, so the latest
    # snapshot is already protected as their restore source and a forced
    # snapshot rot falls on an older kept one
    for prefix in ALL_PREFIXES:
        keys = store.list_keys(prefix)
        for key in keys:
            if key in protected or not plan.bit_rot_decision(key):
                continue
            if _rot(key, prefix, forced=False):
                rotted[prefix] += 1
        if not ensure_per_prefix or rotted[prefix] or not keys:
            continue
        if not any(s.startswith(prefix) or prefix.startswith(s)
                   for s in scope):
            continue  # the plan scoped this prefix OUT: forcing a rot
            # here would override bit_rot_prefixes
        eligible = [k for k in keys if k not in protected]
        if not eligible:
            log.info(
                f"bit rot skips {prefix}: every key protects another "
                "rotted key's redundancy"
            )
            continue
        rng = random.Random(f"{plan.seed}|bit_rot_force|{prefix}")
        if _rot(rng.choice(sorted(eligible)), prefix, forced=True):
            rotted[prefix] += 1
    log.info(
        "bit rot injected: "
        + ", ".join(f"{p}={n}" for p, n in rotted.items() if n)
    )
    return injected


def run_bit_rot_sim(
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
    """The at-rest corruption acceptance soak (module docstring). Runs
    the twins under ``root/healthy`` and ``root/victim`` (which must be
    fresh) on ``device`` (the card unless the caller asks for the CPU),
    the model built with ``model_kwargs``, rots the victim, and returns
    the detection + repair + byte-identity summary, with the port's
    ``seconds`` of each twin and of the two scrubs."""
    import time

    from bodywork_tpu_torch.audit.fsck import run_fsck
    from bodywork_tpu_torch.audit.manifest import AuditedStore
    from bodywork_tpu_torch.chaos.sim import _apply_train_mode, compare_stores
    from bodywork_tpu_torch.data.snapshot import write_snapshot
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline

    root = Path(root)
    healthy_dir, victim_dir = root / "healthy", root / "victim"
    for d in (healthy_dir, victim_dir):
        if d.exists() and any(d.iterdir()):
            raise ValueError(
                f"bit-rot sim target {d} already holds artefacts; point "
                "--store at a fresh directory (the comparison needs two "
                "clean stores)"
            )
    stores, seconds = {}, {}
    for name, d in (("healthy", healthy_dir), ("victim", victim_dir)):
        fs = FilesystemStore(d)
        audited = AuditedStore(fs)
        log.info(f"bit-rot sim: {name} run ({days} day(s)) -> {d}")
        t0 = time.perf_counter()
        LocalRunner(
            _apply_train_mode(
                default_pipeline(model_type, scoring_mode), train_mode, model_kwargs
            ),
            audited,
            drift=drift,
            device=device,
        ).run_simulation(start, days)
        # one final compaction so the LATEST snapshot covers every day —
        # the restore source the dataset repair path depends on
        write_snapshot(audited)
        stores[name] = (fs, audited)
        seconds[name] = time.perf_counter() - t0
    healthy_fs, _healthy = stores["healthy"]
    victim_fs, victim = stores["victim"]

    plan.reset()  # the injector replays stream position 0, like activate()
    injected = inject_bit_rot(victim_fs, plan)

    # ONE scrub detects AND repairs (its findings are the detection
    # record — the scan runs before any repair mutates the store); a
    # second, detect-only scrub then proves nothing is left
    t0 = time.perf_counter()
    repair_report = run_fsck(victim, repair=True)
    seconds["fsck_repair"] = time.perf_counter() - t0
    flagged = {
        f["key"] for f in repair_report["findings"]
        if f["severity"] != "advisory"
    }
    undetected = sorted({e["key"] for e in injected} - flagged)
    t0 = time.perf_counter()
    post = run_fsck(victim, repair=False)
    seconds["fsck_post"] = time.perf_counter() - t0
    # trainstate's repair policy is drop-and-rebuild-on-next-train
    # (derived state), so an incremental-mode soak excludes it from the
    # byte comparison — the healthy twin still holds its document
    extra = (TRAINSTATE_PREFIX,) if train_mode == "incremental" else ()
    comparison = compare_stores(healthy_fs, victim_fs, extra_excluded=extra)
    classified = {
        (f["key"], f["severity"]) for f in repair_report["findings"]
    }
    summary = {
        "days": days,
        "seed": plan.seed,
        "plan": plan.to_dict(),
        "injected": len(injected),
        "injected_keys": [e["key"] for e in injected],
        "injected_by_prefix": _by_prefix(injected),
        "detected": len(injected) - len(undetected),
        "undetected": undetected,
        "findings_by_severity": repair_report["by_severity"],
        "classified": sorted(f"{k} [{s}]" for k, s in classified),
        "repairs": repair_report["repairs"],
        "post_repair_residual": post["residual"],
        "comparison": comparison,
        "seconds": seconds,
        "ok": (
            bool(injected)
            and not undetected
            and repair_report["ok"]
            and post["ok"]
            and comparison["ok"]
        ),
    }
    return summary


def _by_prefix(injected: list[dict]) -> dict[str, int]:
    out: dict[str, int] = {}
    for entry in injected:
        out[entry["prefix"]] = out.get(entry["prefix"], 0) + 1
    return out
