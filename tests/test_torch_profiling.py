"""``torch.profiler`` runs in the port (``bodywork_tpu_torch.utils.
profiling``, the port of ``bodywork_tpu.utils.profiling``): ``maybe_trace
(None)`` is a no-op; a CPU profile writes a Chrome trace holding the
``annotate`` names and the runner's stage names (``run_simulation
(profile_dir=...)``, ``cli run-sim --profile-dir``); a run on the card
whose profiler cannot record the CUDA activity is refused before it
starts rather than written CPU-only (mocked here: there is no card)."""
import json
from datetime import date

import pytest
import torch
from torch.profiler import ProfilerActivity

from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.utils import profiling

torch.set_num_threads(1)

START = date(2026, 8, 1)


def _event_names(path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


@pytest.mark.parametrize("trace_dir", [None, ""])
def test_no_trace_dir_is_a_no_op(tmp_path, monkeypatch, trace_dir):
    monkeypatch.chdir(tmp_path)
    with profiling.maybe_trace(trace_dir, "x", device="cpu") as prof:
        with profiling.annotate("inside"):
            torch.ones(3).sum()
    assert prof is None and list(tmp_path.iterdir()) == []


def test_a_cpu_profile_holds_the_annotated_names(tmp_path):
    with profiling.maybe_trace(tmp_path / "p", "2-day simulation", device="cpu"):
        with profiling.annotate("stage-1-train-model"):
            torch.randn(64, 64) @ torch.randn(64, 64)
        with profiling.annotate("stage-4-test-model-scoring-service"):
            torch.ones(8).cumsum(0)
    path = profiling.trace_path(tmp_path / "p", "2-day simulation")
    assert path.name == "2-day-simulation.pt.trace.json" and path.exists()
    names = _event_names(path)
    assert {"stage-1-train-model", "stage-4-test-model-scoring-service"} <= names
    assert any(n and n.startswith("aten::") for n in names)


def test_a_card_run_without_the_cuda_activity_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.profiler, "supported_activities", lambda: {ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot record CUDA activity"):
        with profiling.maybe_trace(tmp_path / "p", "x", device="cuda"):
            pytest.fail("the region must not run")
    with pytest.raises(RuntimeError, match="cannot record CUDA activity"):
        with profiling.maybe_trace(tmp_path / "p", "x"):  # the card by default
            pytest.fail("the region must not run")
    assert not (tmp_path / "p").exists()


def test_a_card_run_records_the_cuda_activity(tmp_path, monkeypatch):
    """With the CUDA activity available, it is asked for (the profiler
    itself is stubbed: there is no card here)."""
    seen = {}

    class _Profile:
        def __init__(self, activities):
            seen["activities"] = activities

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def export_chrome_trace(self, path):
            seen["path"] = path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: seen.setdefault(
        "synced", device))
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {ProfilerActivity.CPU, ProfilerActivity.CUDA})
    monkeypatch.setattr(torch.profiler, "profile", _Profile)
    with profiling.maybe_trace(tmp_path, "day", device="cuda"):
        pass
    assert seen["activities"] == [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    assert seen["synced"] == torch.device("cuda", 0)
    assert seen["path"] == str(tmp_path / "day.pt.trace.json")


def test_run_simulation_profiles_the_loop(tmp_path):
    runner = LocalRunner(default_pipeline(), FilesystemStore(tmp_path / "s"),
                         drift=DriftConfig(n_samples=60), device="cpu")
    results = runner.run_simulation(START, 2, profile_dir=str(tmp_path / "prof"))
    assert len(results) == 2
    names = _event_names(profiling.trace_path(tmp_path / "prof", "2-day simulation"))
    assert set(default_pipeline().stages) <= names


def test_cli_run_sim_profile_dir(tmp_path, capsys):
    prof = tmp_path / "prof"
    assert cli.main(["run-sim", "--store", str(tmp_path / "s"), "--days", "1", "--device",
                     "cpu", "--samples-per-day", "60", "--date", str(START),
                     "--profile-dir", str(prof), "--trace-out",
                     str(tmp_path / "sim.trace.json")]) == 0
    out = capsys.readouterr().out
    path = profiling.trace_path(prof, "1-day simulation")
    assert f"profile: {path}" in out and path.exists()
    spans = json.loads((tmp_path / "sim.trace.json").read_text())["traceEvents"]
    assert f"bootstrap-{START}" in {e["name"] for e in spans}
