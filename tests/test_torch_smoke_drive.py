"""``chip_smoke.py``'s correctness drive and process check on the CPU: one
seeded log sent to the port's ``aio`` service (a 16-wide MLP) through
``_drive`` in one process and through two spawned shards gets the same
answer for every request, once, and the sharded report's counts are its
shards' summed; ``_descendants`` finds a spawned child, an orphaned
grandchild carrying the run's mark, and neither once they are gone."""
import os
import signal
import subprocess
import sys
import time
from datetime import date

import numpy as np
import pytest
import torch

import chip_smoke
from bodywork_tpu_torch.models.mlp import MLPRegressor
from bodywork_tpu_torch.serve import AdmissionController, AioServiceHandle, PaddedPredictor
from bodywork_tpu_torch.serve import create_app
from bodywork_tpu_torch.traffic import TrafficConfig, generate_request_log
from bodywork_tpu_torch.traffic.runner import LoadReport

torch.set_num_threads(1)

DAY = date(2026, 7, 1)
MODEL_KEY = "models/regressor-2026-07-01.npz"


@pytest.fixture(scope="module")
def service():
    rng = np.random.default_rng(7)
    X = torch.tensor(rng.uniform(0, 100, 500), dtype=torch.float32)
    y = 2.0 + 0.5 * X
    model = MLPRegressor(params=chip_smoke.make_params(torch, "cpu", X, y,
                                                       widths=(1, 16, 16, 1)))
    app = create_app(model, DAY, predictor=PaddedPredictor(model, (1, 8)),
                     model_key=MODEL_KEY, model_source="production",
                     admission=AdmissionController(max_pending=512))
    handle = AioServiceHandle(app, "127.0.0.1", 0).start()
    yield handle.url.replace("/score/v1", "")
    handle.stop()
    handle.app.close()


def _live_pids() -> set:
    return {p["pid"] for p in chip_smoke._descendants()}


def test_a_sharded_drive_answers_every_request_as_one_process_does(service):
    log = generate_request_log(TrafficConfig(rate_rps=150.0, duration_s=2.0, seed=19))
    assert len(log) > 200
    before = _live_pids()
    one, one_answers = chip_smoke._drive(service, log, shards=1)
    with chip_smoke._AdmissionWatch(service) as admission:
        two, two_answers = chip_smoke._drive(service, log, shards=2)
    keys = {(r.t_s, r.route, r.x) for r in log}
    assert len(keys) == len(log)
    assert set(one_answers) == set(two_answers) == keys
    for key in keys:
        assert two_answers[key] == one_answers[key], key
    assert {status for status, _key, _body in one_answers.values()} == {200}
    assert {key for _status, key, _body in one_answers.values()} == {MODEL_KEY}
    # one report's shape, counts summed over the shards
    assert set(one) == set(LoadReport(**{k: 0 for k in one}).to_dict())
    assert set(two) == set(one) | {"by_shard"}
    assert (one["shards"], two["shards"]) == (1, 2)
    assert [s["requests"] for s in two["by_shard"]] == [len(log[0::2]), len(log[1::2])]
    for field in ("requests", "ok", "shed"):
        assert two[field] == sum(s[field] for s in two["by_shard"]) == one[field], field
    assert two["per_model_key"][MODEL_KEY]["ok"] == two["ok"] == len(log)
    assert two["send_lag_p99_s"] < 0.5
    line = chip_smoke._checked_line(two, admission)
    assert line["shards"] == 2 and line["requests"] == line["ok"] == len(log)
    assert line["admission"]["shed_total"] == [0, 0]
    assert line["admission"]["max_pending"] == 512
    # the shards were joined: no process of the drive is left
    assert _live_pids() <= before


def test_a_sharded_drive_fails_loudly_when_a_shard_fails():
    log = generate_request_log(TrafficConfig(rate_rps=50.0, duration_s=0.2, seed=3))
    before = _live_pids()
    with pytest.raises(RuntimeError, match="drive shard 0: ValueError"):
        chip_smoke._drive("http://127.0.0.1:notaport", log, shards=2)
    assert _live_pids() <= before


def test_descendants_find_a_child_and_none_once_it_is_reaped():
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        found = {p["pid"]: p for p in chip_smoke._descendants()}
        assert child.pid in found
        assert found[child.pid]["ppid"] == os.getpid()
        assert "time.sleep(60)" in found[child.pid]["cmdline"]
    finally:
        child.kill()
        child.wait()
    assert child.pid not in _live_pids()


def test_descendants_find_an_orphan_by_the_runs_mark():
    """A grandchild whose parent ended is handed to another parent and
    leaves this process's tree; the run's mark in its environment still
    names it."""
    spawner = subprocess.run(
        [sys.executable, "-c",
         "import subprocess, sys\n"
         "p = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(60)'],\n"
         "                     stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)\n"
         "print(p.pid)"],
        env={**os.environ, chip_smoke.RUN_ENV: str(os.getpid())},
        capture_output=True, text=True, timeout=60, check=True)
    orphan = int(spawner.stdout)
    try:
        assert orphan in _live_pids()
    finally:
        os.kill(orphan, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while orphan in _live_pids() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert orphan not in _live_pids()


def test_check_processes_names_what_a_phase_left(capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "PROCESS_GRACE_S", 0.3)
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        with pytest.raises(RuntimeError, match=rf"pid {child.pid} .*time\.sleep\(60\)"):
            chip_smoke._check_processes("probe")
    finally:
        child.kill()
        child.wait()
    assert '"after": "probe"' in capsys.readouterr().out
    chip_smoke._check_processes("probe")
