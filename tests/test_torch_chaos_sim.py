"""The port's chaos soaks against the JAX package's, on the CPU at small
sizes: the faulted-twin soak (``run_chaos_sim``), the at-rest bit-rot soak
(``run_bit_rot_sim``), the crash-resume sweep (``run_crash_sim``, one day),
the flaky scoring service on both front ends, and ``cli chaos run-sim``."""
import json
import urllib.error
import urllib.request
from datetime import date

import numpy as np
import pytest
import torch

from bodywork_tpu.chaos import FaultPlan as JaxFaultPlan
from bodywork_tpu.chaos.bitrot import run_bit_rot_sim as jax_run_bit_rot_sim
from bodywork_tpu.chaos.sim import run_chaos_sim as jax_run_chaos_sim
from bodywork_tpu.chaos.sim import sweep_points as jax_sweep_points
from bodywork_tpu.data.drift_config import DriftConfig as JaxDriftConfig
from bodywork_tpu.data.generator import generate_day as jax_generate_day
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.chaos import (
    FaultPlan,
    FlakyScoringMiddleware,
    activate,
    run_bit_rot_sim,
    run_chaos_sim,
    run_crash_sim,
    sweep_points,
)
from bodywork_tpu_torch.chaos.kill import EXIT_KILLED
from bodywork_tpu_torch.data import generator
from bodywork_tpu_torch.data.drift_config import DriftConfig

torch.set_num_threads(1)

START = date(2026, 1, 1)
SAMPLES = 96


@pytest.fixture
def jax_days(monkeypatch):
    """The port's days are the JAX generator's, so both packages' soaks
    run on the same bytes."""
    def day(d, cfg=None, device=None):
        X, y = jax_generate_day(d, cfg)
        return np.asarray(X), np.asarray(y)

    monkeypatch.setattr(generator, "generate_day", day)


def _without_plan(summary: dict) -> dict:
    """The summary without its plan and the port's additions (each twin's
    seconds and the breaker's opens)."""
    return {k: v for k, v in summary.items() if k not in ("plan", "seconds", "breaker_opens")}


def test_three_day_linear_chaos_soak_equals_jaxs(tmp_path, jax_days):
    """The same seeded adversity on the same days: the same faults by
    kind, the same retries by backend and op, the breaker closed, and the
    same comparison (every final artefact byte-identical to the
    fault-free twin, none torn)."""
    port = run_chaos_sim(tmp_path / "port", START, 3, FaultPlan.default(0),
                         drift=DriftConfig(n_samples=SAMPLES), device="cpu")
    ref = jax_run_chaos_sim(tmp_path / "jax", START, 3, JaxFaultPlan.default(0),
                            drift=JaxDriftConfig(n_samples=SAMPLES))
    assert port["ok"] and ref["ok"]
    # the background compactor lists the store beside the day's stages in
    # both packages, so the one op whose retries depend on that race is
    # list_keys: its count may differ by one between any two runs
    retries, ref_retries = port.pop("retries"), ref.pop("retries")
    assert _without_plan(port) == _without_plan(ref)
    assert port["plan"] == ref["plan"]
    for name, by_op in retries.items():
        assert by_op.keys() == ref_retries[name].keys(), name
        for op, n in by_op.items():
            assert abs(n - ref_retries[name][op]) <= ("op=list_keys" in op), (name, op)
    assert port["comparison"]["matched"] == 17 and not port["comparison"]["torn"]
    assert port["breaker_opens"] == 0 and set(port["seconds"]) == {"baseline", "faulted"}
    assert port["faults_injected"]["kind=transient"] > 0
    assert retries["bodywork_tpu_scoring_client_retries_total"]


def test_a_chaos_soak_refuses_a_used_store(tmp_path):
    (tmp_path / "baseline").mkdir()
    (tmp_path / "baseline" / "x").write_text("debris")
    with pytest.raises(ValueError, match="already holds artefacts"):
        run_chaos_sim(tmp_path, START, 1, FaultPlan.default(0), device="cpu")


def test_bit_rot_soak_same_seed_same_damage_as_jaxs(tmp_path, jax_days):
    plan, jax_plan = FaultPlan.default(3), JaxFaultPlan.default(3)
    plan.bit_rot_p = jax_plan.bit_rot_p = 0.25
    port = run_bit_rot_sim(tmp_path / "port", START, 3, plan,
                           drift=DriftConfig(n_samples=SAMPLES), device="cpu")
    ref = jax_run_bit_rot_sim(tmp_path / "jax", START, 3, jax_plan,
                              drift=JaxDriftConfig(n_samples=SAMPLES))
    assert port["ok"] and ref["ok"]
    for field in ("injected", "injected_keys", "injected_by_prefix", "detected",
                  "undetected", "findings_by_severity", "classified"):
        assert port[field] == ref[field], field
    assert ([(r["key"], r["action"], r["outcome"]) for r in port["repairs"]]
            == [(r["key"], r["action"], r["outcome"]) for r in ref["repairs"]])
    assert port["detected"] == port["injected"] >= 8
    assert port["comparison"]["ok"] and not port["post_repair_residual"]


def test_crash_sweep_points_equal_jaxs():
    keys = ["datasets/a.csv", "models/m.npz", "model-metrics/m.csv", "runs/x/journal.json",
            "snapshots/s.npz", "registry/aliases.json", "test-metrics/t.csv"]
    assert sweep_points(2, 4, keys, seed=5) == jax_sweep_points(2, 4, keys, seed=5)


def test_crash_sweep_never_draws_an_audit_sidecar():
    """A sidecar is written below the kill switch (``AuditedStore`` is
    inside it), so a kill addressed to one never fires: the JAX sweep
    draws it (seed 0 over a 1-day store picks one, and that point then
    fails as never fired); the port's draws only keys a run can hit."""
    keys = ["audit/digests/snapshots/history-snapshot-2026-01-02.npz.json",
            "audit/digests/models/m.npz.json", "models/m.npz", "test-metrics/t.csv"]
    drawn = {p["key"] for p in sweep_points(1, 4, keys, seed=0) if p["kind"] == "store_op"}
    assert drawn == {"models/m.npz", "test-metrics/t.csv"}
    jax_drawn = {p["key"] for p in jax_sweep_points(1, 4, keys, seed=0)
                 if p["kind"] == "store_op"}
    assert any(k.startswith("audit/") for k in jax_drawn)


def test_one_day_crash_sweep_converges_at_every_point(tmp_path):
    """Every stage boundary of one day plus two seeded store-op points: a
    child ``run-sim`` dies at its point (exit 86) and a restart reaches
    the uninterrupted twin's artefacts."""
    summary = run_crash_sim(tmp_path / "crash", START, 1, seed=0,
                            samples_per_day=SAMPLES, device="cpu")
    assert summary["points"] == 7
    bad = [r for r in summary["results"] if not r["ok"]]
    assert summary["ok"], bad
    assert all(r["kill_exit"] == EXIT_KILLED and r["restart_exit"] == 0
               and r["seconds"] > 0 for r in summary["results"])
    assert sum(r["point"]["kind"] == "store_op" for r in summary["results"]) == 2


# -- the flaky scoring service ------------------------------------------------

def _models():
    from bodywork_tpu.models import LinearRegressor as JaxLinearRegressor
    from bodywork_tpu_torch.models import LinearRegressor

    rng = np.random.default_rng(1)
    X = rng.uniform(0, 100, 600).astype(np.float32)
    jax_model = JaxLinearRegressor().fit(X, (1.0 + 0.5 * X).astype(np.float32))
    model = LinearRegressor(params={k: torch.tensor(np.asarray(v))
                                    for k, v in jax_model.params.items()})
    return model, jax_model


def _shed(registry, reason: str) -> float:
    counter = registry.get("bodywork_tpu_serve_shed_total")
    return 0.0 if counter is None else counter.value(reason=reason)


def test_the_flaky_middleware_answers_as_jaxs():
    """Both middlewares over their packages' apps, the same plan: the same
    statuses, bodies and ``Retry-After`` for 40 requests, the refusals
    counted as ``reason="chaos"``, health never refused."""
    from bodywork_tpu.chaos import FlakyScoringMiddleware as JaxFlaky
    from bodywork_tpu.obs import get_registry as jax_registry
    from bodywork_tpu.serve import create_app as jax_create_app
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.serve import PaddedPredictor, create_app

    model, jax_model = _models()
    plan_kwargs = {"seed": 7, "http_error_p": 0.4, "http_retry_after_s": 0.5,
                   "max_consecutive": 3}
    port = FlakyScoringMiddleware(
        create_app(model, START, predictor=PaddedPredictor(model, (1,))),
        FaultPlan(**plan_kwargs))
    ref = JaxFlaky(jax_create_app(jax_model, START, buckets=(1,)),
                   JaxFaultPlan(**plan_kwargs)).test_client()
    before = (_shed(get_registry(), "chaos"), _shed(jax_registry(), "chaos"))
    refused = 0
    for x in np.linspace(1, 99, 40):
        body = json.dumps({"X": float(x)}).encode()
        status, headers, payload = port.handle("POST", "/score/v1", body, "application/json")
        want = ref.post("/score/v1", data=body, content_type="application/json")
        assert status == want.status_code
        if status != 200:
            refused += 1
            assert payload == want.data and headers["Retry-After"] == want.headers["Retry-After"]
    assert refused and refused < 40
    assert _shed(get_registry(), "chaos") - before[0] == refused
    assert _shed(jax_registry(), "chaos") - before[1] == refused
    assert port.handle("GET", "/healthz")[0] == 200
    assert port.healthz_payload()["model_date"] == str(START)


def _post(url: str, x: float):
    request = urllib.request.Request(url, data=json.dumps({"X": x}).encode(),
                                     headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=30) as resp:
            return resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, dict(exc.headers), exc.read()


def test_aio_composes_the_plans_http_faults_as_jaxs():
    """Under an active plan the ``aio`` front end refuses as the JAX one
    does, with the plan's ``Retry-After``, counted as ``reason="chaos"``
    and never as an admission shed nor a request; with the plan gone it
    answers again."""
    from bodywork_tpu.chaos import activate as jax_activate
    from bodywork_tpu.obs import get_registry as jax_registry
    from bodywork_tpu.serve import AioServiceHandle as JaxAioServiceHandle
    from bodywork_tpu.serve import create_app as jax_create_app
    from bodywork_tpu.serve.admission import AdmissionController as JaxAdmission
    from bodywork_tpu_torch.obs import get_registry
    from bodywork_tpu_torch.serve import (
        AdmissionController,
        AioServiceHandle,
        PaddedPredictor,
        create_app,
    )

    model, jax_model = _models()
    port_app = create_app(model, START, predictor=PaddedPredictor(model, (1,)),
                          admission=AdmissionController(64))
    jax_app = jax_create_app(jax_model, START, buckets=(1,), admission=JaxAdmission(64))
    handles = (AioServiceHandle(port_app, "127.0.0.1", 0).start(),
               JaxAioServiceHandle(jax_app, "127.0.0.1", 0).start())
    plan_kwargs = {"seed": 5, "http_error_p": 1.0, "http_retry_after_s": 2.0,
                   "max_consecutive": 0}
    try:
        before = {name: (_shed(reg(), "chaos"), _shed(reg(), "admission"))
                  for name, reg in (("port", get_registry), ("jax", jax_registry))}
        with activate(FaultPlan(**plan_kwargs)), jax_activate(JaxFaultPlan(**plan_kwargs)):
            answers = [[_post(h.url, x) for x in (10.0, 50.0)] for h in handles]
        for (p_status, p_headers, p_body), (j_status, j_headers, j_body) in zip(*answers):
            assert p_status == j_status and p_status in (503, 429)
            assert p_headers["Retry-After"] == j_headers["Retry-After"] == "2.0"
            assert p_body == j_body and b"injected fault" in p_body
        for name, reg in (("port", get_registry), ("jax", jax_registry)):
            assert _shed(reg(), "chaos") == before[name][0] + 2
            assert _shed(reg(), "admission") == before[name][1]
        assert _post(handles[0].url, 50.0)[0] == 200
    finally:
        for h in handles:
            h.stop()
        port_app.close()
        jax_app.close()


# -- the command ----------------------------------------------------------------

def test_cli_chaos_run_sim_passes_and_keeps_the_seed_precedence(tmp_path, monkeypatch, capsys):
    assert cli.main(["chaos", "run-sim", "--store", str(tmp_path / "soak"), "--days", "2",
                     "--date", str(START), "--samples-per-day", str(SAMPLES),
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS:" in out and "breaker state: closed" in out

    seen = []
    monkeypatch.setattr("bodywork_tpu_torch.chaos.run_chaos_sim",
                        lambda root, start, days, plan, **kw: seen.append(plan.seed) or {
                            "faults_injected": {}, "retries": {}, "breaker_state": "closed",
                            "comparison": {"matched": 0}, "ok": True})
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps({"seed": 21}))
    monkeypatch.setenv("BODYWORK_TPU_CHAOS_SEED", "9")
    base = ["chaos", "run-sim", "--store", str(tmp_path / "x"), "--days", "1",
            "--device", "cpu"]
    assert cli.main(base) == 0                                   # env > default
    assert cli.main([*base, "--plan", str(plan_file)]) == 0      # plan > env
    assert cli.main([*base, "--plan", str(plan_file), "--seed", "4"]) == 0  # flag > plan
    assert seen == [9, 21, 4]
    assert cli.main(["chaos", "run-sim", "--store", "gs://b/p", "--days", "1"]) == 1


def test_cli_crash_schedule_rejects_a_bad_spec(tmp_path):
    assert cli.main(["chaos", "run-sim", "--store", str(tmp_path / "c"), "--days", "1",
                     "--crash-schedule", "[{\"kind\": \"nope\"}]", "--device", "cpu"]) == 1
