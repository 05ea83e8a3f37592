"""Stage spans and the day report in the port (``bodywork_tpu_torch.obs.
spans`` and the runner's recorder) against the JAX package's
(``bodywork_tpu.obs.spans``, ``tests/test_obs.py``): the recorder under
threads; ``day_report`` and ``chrome_trace`` documents equal to JAX's for
the same spans; the same ``run_day`` on copies of one store through both
packages giving the same span names, categories, meta keys and order;
journal-skipped stages' zero-length spans; trace durations equal to
``stage_seconds``; ``cli run-day --trace-out/--report-out``.

Tolerance: none. Documents built from the same spans are equal byte for
byte; runs are compared with their timeline fields (``start_s``,
``duration_s``, ``wall_clock_s``, ``stage_seconds``) and the background
spans' positions masked, since those follow each process's timing."""
import dataclasses
import json
import shutil
import sys
import threading
import time
from datetime import date

import pytest
import torch

from bodywork_tpu.data.drift_config import DriftConfig as JaxDrift
from bodywork_tpu.obs import spans as jax_spans
from bodywork_tpu.pipeline import LocalRunner as JaxRunner
from bodywork_tpu.pipeline import default_pipeline as jax_default_pipeline
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.chaos import kill
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.obs import spans
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.pipeline.spec import TRAIN_STAGE
from bodywork_tpu_torch.store import FilesystemStore

torch.set_num_threads(1)

START = date(2026, 8, 1)
#: background work whose place in a day's span list follows its timing
BACKGROUND = ("prefetch", "overlap", "compact")


def test_the_recorder_keeps_every_span_under_threads():
    recorder = spans.SpanRecorder("t")
    n_threads, per_thread = 12, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for j in range(per_thread):
                recorder.add(f"s-{i}-{j}", "stage", recorder.now(), 0.0, i=i)
                if j % 50 == 0:
                    with recorder.span(f"ctx-{i}-{j}", "overlap"):
                        pass

        threads = [threading.Thread(target=work, args=(i,), name=f"w{i}")
                   for i in range(n_threads)]
        mark = recorder.mark()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = recorder.since(mark)
    assert len(got) == len(recorder.spans()) == n_threads * (per_thread + per_thread // 50)
    assert len({s.name for s in got}) == len(got)
    assert all(s.thread == f"w{s.meta['i']}" for s in got if "i" in s.meta)


def _both(spans_list):
    """The same span list as the port's and the JAX package's Span objects."""
    return ([spans.Span(**dataclasses.asdict(s)) for s in spans_list],
            [jax_spans.Span(**dataclasses.asdict(s)) for s in spans_list])


@dataclasses.dataclass
class _Result:
    day: date
    wall_clock_s: float
    stage_seconds: dict
    spans: list


def test_day_report_and_chrome_trace_are_the_jax_documents(tmp_path):
    recorder = spans.SpanRecorder("t")
    recorder.add("stage-1-train-model", "stage", 0.000125, 0.1234567891, day=str(START),
                 train_mode="full", rows_touched=60)
    recorder.add("registry-gate", "gate", 0.2, 0.0312, day=str(START), verdict="promoted")
    recorder.add("prefetch-dataset-2026-08-02", "prefetch", 0.05, 0.01)
    recorder.add(f"run-day-{START}", "day", 0.0, 0.5)
    port, ref = _both(recorder.spans())
    stage_seconds = {"stage-1-train-model": 0.1234567891, "stage-2-serve-model": 1e-7}
    port_report = spans.day_report(_Result(START, 0.5000004, stage_seconds, port))
    assert port_report == jax_spans.day_report(_Result(START, 0.5000004, stage_seconds, ref))
    assert spans.chrome_trace(port, "run-day x") == jax_spans.chrome_trace(ref, "run-day x")
    assert spans.chrome_trace(port) == jax_spans.chrome_trace(ref)
    a = spans.write_day_report(tmp_path / "a" / "r.json", port_report)
    b = jax_spans.write_day_report(tmp_path / "b" / "r.json", port_report)
    assert a.read_bytes() == b.read_bytes()
    a = spans.write_chrome_trace(tmp_path / "a" / "t.json", port, "p")
    b = jax_spans.write_chrome_trace(tmp_path / "b" / "t.json", ref, "p")
    assert a.read_bytes() == b.read_bytes()


def _skeleton(result) -> tuple[list, list]:
    """A day's spans without their times: the ordered foreground (stages,
    gate, day) and the sorted background spans."""
    def shape(s):
        meta = {k: v for k, v in s.meta.items()
                if k not in ("served_key", "model_source", "rows_touched")}
        return s.name, s.category, sorted(meta.items()), "served_key" in s.meta
    fore = [shape(s) for s in result.spans if s.category not in BACKGROUND]
    back = sorted(shape(s) for s in result.spans if s.category in BACKGROUND)
    return fore, back


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """A bootstrapped store (day 0 on the JAX generator) to copy per run."""
    root = tmp_path_factory.mktemp("seed")
    JaxRunner(jax_default_pipeline(), JaxStore(root), drift=JaxDrift(n_samples=60)
              ).bootstrap(START)
    return root


def _copy(seeded, dst):
    return shutil.copytree(seeded, dst)


def test_the_same_day_records_jaxs_spans(seeded, tmp_path):
    jax_runner = JaxRunner(jax_default_pipeline(), JaxStore(_copy(seeded, tmp_path / "j")),
                           drift=JaxDrift(n_samples=60))
    runner = LocalRunner(default_pipeline(), FilesystemStore(_copy(seeded, tmp_path / "p")),
                         drift=DriftConfig(n_samples=60), device="cpu")
    for day in (START, date(2026, 8, 2)):
        want = jax_runner.run_day(day)
        got = runner.run_day(day)
        jax_runner._drain_compactor()
        runner._drain_compactor()
        assert _skeleton(got)[0] == _skeleton(want)[0]
        fore = [s.name for s in got.spans if s.category not in BACKGROUND]
        assert fore == [TRAIN_STAGE, "registry-gate", *list(default_pipeline().stages)[1:],
                        f"run-day-{day}"]
        assert {s.name for s in got.spans} >= {f"prefetch-dataset-{day.replace(day=day.day + 1)}"}
        report = spans.day_report(got)
        assert report["schema"] == "bodywork_tpu.day_report/1"
        assert list(report) == list(jax_spans.day_report(want))
    # the background work of both runs, in both timelines
    assert sorted((s.name, s.category) for s in runner.recorder.spans()) == sorted(
        (s.name, s.category) for s in jax_runner.recorder.spans())


def test_trace_durations_equal_stage_seconds(seeded, tmp_path):
    runner = LocalRunner(default_pipeline(), FilesystemStore(_copy(seeded, tmp_path / "p")),
                         drift=DriftConfig(n_samples=60), device="cpu")
    result = runner.run_day(START)
    trace = spans.chrome_trace(result.spans)
    durations = {e["name"]: e["dur"] for e in trace["traceEvents"] if e["ph"] == "X"}
    for name, seconds in result.stage_seconds.items():
        assert durations[name] == round(seconds * 1e6, 3)
    assert durations[f"run-day-{START}"] == round(result.wall_clock_s * 1e6, 3)
    assert result.gate_seconds * 1e6 == pytest.approx(durations["registry-gate"], abs=1e-3)


def test_journal_skipped_stages_record_zero_length_spans(seeded, tmp_path, monkeypatch):
    monkeypatch.setenv("BODYWORK_TPU_RUN_LEASE_TTL_S", "0.05")
    root = _copy(seeded, tmp_path / "p")
    runner = LocalRunner(default_pipeline(), FilesystemStore(root),
                         drift=DriftConfig(n_samples=60), device="cpu")
    kill.install(kill.KillSwitch([{"kind": "stage_boundary", "n": 1}], action="raise"))
    try:
        with pytest.raises(kill.SimulatedCrash):
            runner.run_day(START)
    finally:
        kill.uninstall()
    time.sleep(0.1)  # the dead runner's lease expires
    resumed = LocalRunner(default_pipeline(), FilesystemStore(root),
                          drift=DriftConfig(n_samples=60), device="cpu").run_day(START)
    (train,) = [s for s in resumed.spans if s.name == TRAIN_STAGE]
    assert train.duration_s == 0.0 and train.meta == {"day": str(START), "skipped": True}
    assert resumed.stage_seconds[TRAIN_STAGE] == 0.0
    others = [s for s in resumed.spans if s.category == "stage" and s.name != TRAIN_STAGE]
    assert others and all(s.duration_s > 0 and "skipped" not in s.meta for s in others)


def test_a_noop_day_records_jaxs_zero_length_spans(seeded, tmp_path):
    got = want = None
    for cls, store_cls, drift, kwargs, key in (
            (LocalRunner, FilesystemStore, DriftConfig, {"device": "cpu"}, "p"),
            (JaxRunner, JaxStore, JaxDrift, {}, "j")):
        pipeline = default_pipeline() if key == "p" else jax_default_pipeline()
        root = _copy(seeded, tmp_path / key)
        cls(pipeline, store_cls(root), drift=drift(n_samples=60), **kwargs).run_day(START)
        result = cls(pipeline, store_cls(root), drift=drift(n_samples=60),
                     **kwargs).run_day(START)
        assert result.noop
        if key == "p":
            got = result
        else:
            want = result
    assert [dataclasses.asdict(s) | {"start_s": 0, "thread": ""} for s in got.spans] == [
        dataclasses.asdict(s) | {"start_s": 0, "thread": ""} for s in want.spans]
    assert all(s.duration_s == 0.0 for s in got.spans)
    assert spans.day_report(got) == jax_spans.day_report(want) | {
        "spans": [s.to_dict() | {"start_s": round(g.start_s, 6), "thread": g.thread}
                  for s, g in zip(want.spans, got.spans)]}


def test_cli_run_day_writes_the_trace_and_the_report(seeded, tmp_path, capsys):
    root = _copy(seeded, tmp_path / "p")
    out = tmp_path / "out" / "{date}.trace.json"
    args = ["run-day", "--store", str(root), "--device", "cpu", "--date", str(START),
            "--trace-out", str(out)]
    assert cli.main(args) == 0
    printed = capsys.readouterr().out
    trace_path = tmp_path / "out" / f"{START}.trace.json"
    report_path = tmp_path / "out" / f"{START}.report.json"
    assert f"trace: {trace_path}" in printed and f"report: {report_path}" in printed
    report = json.loads(report_path.read_text())
    trace = json.loads(trace_path.read_text())
    assert report["schema"] == "bodywork_tpu.day_report/1" and report["day"] == str(START)
    events = {e["name"]: e for e in trace["traceEvents"] if e["ph"] == "X"}
    assert f"bootstrap-{START}" not in events  # the store was bootstrapped already
    for name, seconds in report["stage_seconds"].items():
        assert events[name]["dur"] == pytest.approx(seconds * 1e6, abs=1.0)
    assert {"registry-gate", f"run-day-{START}"} <= set(events)
    # an explicit report path wins over the derived one
    explicit = tmp_path / "explicit.json"
    assert cli.main(["run-day", "--store", str(root), "--device", "cpu", "--date",
                     "2026-08-02", "--report-out", str(explicit)]) == 0
    assert json.loads(explicit.read_text())["day"] == "2026-08-02"
