"""The multi-tenant fleet simulation: N pipelines, one store, chaos on one
(the port of ``bodywork_tpu.tenancy.fleet``; both runs compute on
``device``, the card unless the caller asks for the CPU).

``run_fleet_sim`` drives every tenant's daily pipeline against ONE
shared store through tenant-scoped views (``tenants/<id>/`` — see
:mod:`.namespace`), interleaved by the fair round-robin scheduler
(:mod:`.scheduler`), each tenant with its own scenario-zoo generator
(:mod:`.scenarios`). Optionally one tenant is sabotaged: its final
day's training data is NaN-poisoned at the artefact layer, so its last
candidate trains to non-finite metrics and the day's registry gate must
REJECT it (production stays on the prior healthy model — the
auto-rollback contract).

The acceptance proof is byte-identity with SOLO twins: every
non-sabotaged tenant's pipeline is re-run alone, in a fresh dedicated
store, through the EXACT same per-day pipeline — and its final artefacts
must compare byte-identical (``chaos.sim.compare_stores``) to its
namespace inside the shared fleet store. Any cross-tenant leak —
through a shared cache, a mis-scoped key, a scheduler-order
dependency, or the sabotaged tenant's blast radius — breaks identity
somewhere. Both runs are pure functions of (spec tuple, start, days),
so the sim is a seeded PASS/FAIL, not a probability.
"""
from __future__ import annotations

from datetime import date, timedelta
from pathlib import Path

from bodywork_tpu_torch.store.filesystem import FilesystemStore
from bodywork_tpu_torch.tenancy.namespace import scoped_store
from bodywork_tpu_torch.tenancy.scenarios import TenantSpec
from bodywork_tpu_torch.tenancy.scheduler import FairScheduler
from bodywork_tpu_torch.utils.logging import get_logger

log = get_logger("tenancy.fleet")

__all__ = ["run_fleet_sim", "sabotage_dataset_nan"]


def sabotage_dataset_nan(store, key: str) -> None:
    """NaN-poison every label of a persisted dataset CSV, in place —
    the per-tenant chaos fault: the tenant's next retrain folds the
    poisoned day in and trains to non-finite metrics, which the daily
    registry gate must catch (finite-metrics check) before the
    candidate can ever serve."""
    text = store.get_bytes(key).decode("utf-8")
    lines = text.splitlines()
    out = [lines[0]]
    for line in lines[1:]:
        if not line:
            continue
        x, _, _rest = line.partition(",")
        out.append(f"{x},nan")
    store.put_bytes(key, ("\n".join(out) + "\n").encode("utf-8"))
    log.warning(f"sabotaged dataset {key}: all labels -> NaN")


class _TenantPipeline:
    """One tenant's day-by-day pipeline.

    The SAME class drives the fleet run (interleaved with other
    tenants) and each solo twin (alone in its own store) — byte-identity
    between them is then a property of the pipeline's determinism, not
    of two different harness code paths happening to agree."""

    def __init__(self, spec: TenantSpec, store, model_type: str,
                 scoring_mode: str, device=None, model_kwargs: dict | None = None):
        from bodywork_tpu_torch.chaos.sim import _apply_train_mode
        from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline

        self.spec = spec
        self.store = store
        self.runner = LocalRunner(
            _apply_train_mode(
                default_pipeline(model_type, scoring_mode), "full", model_kwargs
            ),
            store,
            drift=spec.drift_config(),
            device=device,
        )
        self.days_run = 0
        self.results = []

    def start(self, start_day: date) -> None:
        self.start_day = start_day
        self.runner.bootstrap(start_day)

    def run_next_day(self) -> None:
        today = self.start_day + timedelta(days=self.days_run)
        self.results.append(
            self.runner.run_day(today, lookahead_train=False)
        )
        self.days_run += 1

    def finish(self) -> None:
        """The end-of-simulation consolidation ``run_simulation`` does:
        drain the background compactor, then top up the final snapshot."""
        if not self.runner._drain_compactor():
            return
        try:
            from bodywork_tpu_torch.data.snapshot import refresh_due, write_snapshot

            if refresh_due(self.store):
                write_snapshot(self.store)
        except Exception as exc:  # cold readers keep the old snapshot
            log.warning(f"final snapshot refresh failed (non-fatal): {exc!r}")

    def latest_dataset_key(self) -> str:
        from bodywork_tpu_torch.store.schema import DATASETS_PREFIX

        key, _ = self.store.latest(DATASETS_PREFIX)
        return key


def _tenant_days(spec: TenantSpec, days: int) -> int:
    """How many pipeline days a tenant runs in a ``days``-tick fleet:
    label-delayed tenants start late (their labels haven't landed), so
    they run fewer days — the solo twin runs the same count."""
    return max(1, days - spec.effective_label_delay)


def run_fleet_sim(
    root: str | Path,
    start: date,
    days: int,
    specs: tuple[TenantSpec, ...],
    sabotage_tenant: str | None = None,
    model_type: str = "linear",
    scoring_mode: str = "batch",
    device=None,
    model_kwargs: dict | None = None,
) -> dict:
    """Run the fleet + its solo twins and return the full comparison.

    Layout under ``root``: ``fleet/`` is the one shared store every
    tenant lives in (under ``tenants/<id>/``); ``solo/<id>/`` is each
    non-sabotaged tenant's dedicated-store twin. ``sabotage_tenant``
    names the tenant whose final training day is NaN-poisoned; its
    registry must reject the poisoned candidate (``gate_rejected`` in
    the summary) and every OTHER tenant must stay byte-identical to its
    twin (``comparisons[tenant]["ok"]``) — zero cross-tenant blast
    radius. Everything is a pure function of the arguments. The port adds
    ``device`` (every pipeline computes there, the card unless the caller
    asks for the CPU) and ``model_kwargs`` (the model's widths and fit
    length), as ``chaos.sim.run_chaos_sim`` takes them.
    """
    from bodywork_tpu_torch.chaos.sim import compare_stores
    from bodywork_tpu_torch.device import resolve_device
    from bodywork_tpu_torch.obs.tracing import configured_tracing

    if sabotage_tenant is not None and sabotage_tenant not in {
        s.tenant_id for s in specs
    }:
        raise ValueError(
            f"sabotage tenant {sabotage_tenant!r} not in the fleet "
            f"({sorted(s.tenant_id for s in specs)})"
        )
    device = resolve_device(device)
    root = Path(root)
    fleet_dir = root / "fleet"
    if fleet_dir.exists() and any(fleet_dir.iterdir()):
        raise ValueError(
            f"fleet sim target {fleet_dir} already holds artefacts; "
            "point --store at a fresh directory"
        )
    fleet_store = FilesystemStore(fleet_dir)
    scheduler = FairScheduler()
    pipelines: dict[str, _TenantPipeline] = {}

    log.info(
        f"fleet run: {len(specs)} tenant(s) x {days} day(s) -> {fleet_dir}"
        + (f" (sabotaging {sabotage_tenant!r})" if sabotage_tenant else "")
    )
    with configured_tracing(0.0):
        for spec in specs:
            pipelines[spec.tenant_id] = _TenantPipeline(
                spec, scoped_store(fleet_store, spec.tenant_id),
                model_type, scoring_mode, device, model_kwargs,
            )
        for tick in range(days):
            # due = tenants whose label delay has elapsed and that still
            # have pipeline days left; the round-robin head rotates per
            # tick so no tenant systematically retrains last
            due = [
                s.tenant_id for s in specs
                if tick >= s.effective_label_delay
                and pipelines[s.tenant_id].days_run < _tenant_days(s, days)
            ]
            for tenant_id in scheduler.order(due):
                pipe = pipelines[tenant_id]
                if pipe.days_run == 0:
                    pipe.start(start)
                if (
                    sabotage_tenant == tenant_id
                    and pipe.days_run
                    == _tenant_days(pipe.spec, days) - 1
                    and pipe.days_run > 0
                ):
                    # poison the newest dataset right before the final
                    # day's retrain folds it in
                    sabotage_dataset_nan(
                        pipe.store, pipe.latest_dataset_key()
                    )
                pipe.run_next_day()
        for pipe in pipelines.values():
            pipe.finish()

    # -- the sabotaged tenant's registry verdict ---------------------------
    gate_rejected = None
    production_held = None
    if sabotage_tenant is not None:
        from bodywork_tpu_torch.registry import ModelRegistry

        reg = ModelRegistry(pipelines[sabotage_tenant].store)
        records = {r["model_key"]: r for r in reg.records()}
        rejected = [
            k for k, r in records.items() if r.get("status") == "rejected"
        ]
        production = reg.resolve("production")
        gate_rejected = bool(rejected)
        # production must still be a FINITE model from before the
        # sabotage — i.e. not one of the rejected keys
        production_held = (
            production is not None and production not in rejected
        )

    # -- solo twins: every healthy tenant, same pipeline, fresh store ------
    comparisons: dict[str, dict] = {}
    with configured_tracing(0.0):
        for spec in specs:
            if spec.tenant_id == sabotage_tenant:
                continue
            solo_dir = root / "solo" / spec.tenant_id
            log.info(f"solo twin: {spec.tenant_id} -> {solo_dir}")
            solo = _TenantPipeline(
                spec, FilesystemStore(solo_dir), model_type, scoring_mode,
                device, model_kwargs,
            )
            solo.start(start)
            for _ in range(_tenant_days(spec, days)):
                solo.run_next_day()
            solo.finish()
            comparisons[spec.tenant_id] = compare_stores(
                solo.store, pipelines[spec.tenant_id].store
            )

    ok = all(c["ok"] for c in comparisons.values()) and (
        sabotage_tenant is None or (gate_rejected and production_held)
    )
    return {
        "tenants": [s.tenant_id for s in specs],
        "days": days,
        "sabotage_tenant": sabotage_tenant,
        "gate_rejected": gate_rejected,
        "production_held": production_held,
        "comparisons": comparisons,
        "ok": ok,
    }
