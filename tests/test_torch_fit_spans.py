"""The MLP fit's phase spans (``models.mlp.FitPhases``) on the recorder a
caller installs with ``obs.spans.recording``: the span tree of ``fit``,
``fit_and_evaluate`` and ``fine_tune``; nothing recorded, and no profiler
range entered, without a recorder; the same numbers with and without
one; no inheritance by other threads; the documents of a span with no
parent equal to the JAX package's; and the arithmetic of
``tools/fit_spans_trace.py`` on a synthetic device trace.

Tolerance: none. A recorder changes no operation of the fit, so its
leaves and final loss are equal bit for bit."""
import dataclasses
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu.obs import spans as jax_spans
from bodywork_tpu_torch.models import mlp
from bodywork_tpu_torch.models.mlp import HEAD_STEPS, MLPConfig, MLPRegressor
from bodywork_tpu_torch.obs import spans
from bodywork_tpu_torch.obs.spans import SpanRecorder, current_recorder, recording
from bodywork_tpu_torch.utils.profiling import maybe_trace, trace_path

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ROWS, TEST_ROWS = 300, 60
ENTRIES = ["fit", "fit_and_evaluate", "fine_tune"]
PHASES = ["fit.prepare", "fit.init", "fit.indices", "fit.dispatch", "fit.drain"]


def _data(rows=ROWS, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 100, (rows, 2)).astype(np.float32)
    y = (0.4 * X[:, 0] - 0.2 * X[:, 1] + rng.normal(size=rows)).astype(np.float32)
    return X, y


def _cfg(n_steps):
    return MLPConfig(hidden=(8, 8), batch_size=32, n_steps=n_steps, seed=3)


def _donor():
    return MLPRegressor(_cfg(4)).fit(*_data(seed=1), device="cpu")


def _run(entry, n_steps, donor=None):
    """One fit through ``entry``; returns the fitted model."""
    X, y = _data()
    if entry == "fit":
        return MLPRegressor(_cfg(n_steps)).fit(X, y, device="cpu")
    if entry == "fit_and_evaluate":
        Xe, ye = _data(TEST_ROWS, seed=2)
        return MLPRegressor(_cfg(n_steps)).fit_and_evaluate(X, y, Xe, ye, device="cpu")[0]
    return (donor or _donor()).fine_tune(X, y, n_steps=n_steps, seed=5)


def _leaves(model):
    return [t for layer in model.params["net"]["layers"] for t in (layer["w"], layer["b"])]


@pytest.mark.parametrize("n_steps", [5, 12])
@pytest.mark.parametrize("entry", ENTRIES)
def test_a_recorded_fit_records_its_phase_tree(entry, n_steps):
    donor = _donor() if entry == "fine_tune" else None
    rec = SpanRecorder()
    with recording(rec):
        _run(entry, n_steps, donor)
    got = sorted(rec.spans(), key=lambda s: s.start_s)
    phases = [p for p in PHASES if not (entry == "fine_tune" and p == "fit.init")]
    n_head = min(HEAD_STEPS, n_steps)
    assert [s.name for s in got] == (["fit"] + phases[:-1] + ["fit.step"] * n_head
                                     + [phases[-1]])
    by_name = {s.name: s for s in got}
    assert {s.meta["fit"] for s in got} == {1}
    assert all(s.category == spans.CATEGORY_FIT for s in got)
    assert by_name["fit"].parent is None
    for s in got[1:]:
        assert s.parent == ("fit.dispatch" if s.name == "fit.step" else "fit")
        outer = by_name[s.parent]
        assert outer.start_s <= s.start_s and s.end_s <= outer.end_s
    steps = [s for s in got if s.name == "fit.step"]
    assert [s.meta["step"] for s in steps] == list(range(1, n_head + 1))
    assert by_name["fit"].meta == {"fit": 1, "rows": ROWS, "padded_rows": 1024, "batch": 32,
                                   "steps": n_steps}
    assert by_name["fit.indices"].meta["steps"] == n_steps
    assert by_name["fit.dispatch"].meta["steps"] == n_steps
    # the phases follow one another in the order they run
    seq = [by_name[p] for p in phases]
    assert all(a.end_s <= b.start_s for a, b in zip(seq, seq[1:]))


@pytest.mark.parametrize("entry", ENTRIES)
def test_without_a_recorder_a_fit_records_nothing_and_enters_no_range(entry, monkeypatch):
    donor = _donor() if entry == "fine_tune" else None
    entered = []
    monkeypatch.setattr(mlp, "annotate", lambda name: entered.append(name))
    rec = SpanRecorder()
    assert current_recorder() is None
    _run(entry, 12, donor)
    assert rec.spans() == [] and entered == []


@pytest.mark.parametrize("entry", ENTRIES)
def test_a_recorder_leaves_the_fit_bit_for_bit(entry):
    donor = _donor() if entry == "fine_tune" else None
    plain = _run(entry, 12, donor)
    with recording(SpanRecorder()):
        recorded = _run(entry, 12, donor)
    assert plain.final_loss == recorded.final_loss
    for a, b in zip(_leaves(plain), _leaves(recorded), strict=True):
        assert torch.equal(a, b)
    for key in plain.scaler:
        assert torch.equal(plain.scaler[key], recorded.scaler[key])


def test_a_fit_in_another_thread_records_nothing_into_this_threads_recorder():
    rec = SpanRecorder()
    seen = []

    def work():
        seen.append(current_recorder())
        _run("fit", 4)

    with recording(rec):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    assert seen == [None] and rec.spans() == []


def test_recording_nests_and_restores_and_fit_ids_count_per_recorder():
    outer, inner = SpanRecorder(), SpanRecorder()
    with recording(outer):
        _run("fit", 2)
        with recording(inner):
            assert current_recorder() is inner
            _run("fit", 2)
        assert current_recorder() is outer
        _run("fit", 2)
    assert current_recorder() is None
    assert sorted({s.meta["fit"] for s in outer.spans()}) == [1, 2]
    assert {s.meta["fit"] for s in inner.spans()} == {1}


def test_a_profile_shows_the_phases_beside_the_ops(tmp_path):
    with maybe_trace(tmp_path, "fit", device="cpu"):
        _run("fit", 10)
    names = {e.get("name") for e in json.loads(trace_path(tmp_path, "fit").read_text())
             ["traceEvents"]}
    assert {"fit", *PHASES, "fit.step"} <= names


def _pair(**kw):
    base = dict(name="fit.step", category="fit", start_s=0.25, duration_s=0.5,
                thread="MainThread", meta={"fit": 1, "step": 2})
    base.update(kw)
    return spans.Span(**base), jax_spans.Span(**base)


@pytest.mark.parametrize("meta", [{}, {"fit": 1, "step": 2}])
def test_a_span_without_a_parent_gives_the_documents_as_before(meta):
    port, jax = _pair(meta=meta)
    assert port.parent is None
    assert port.to_dict() == jax.to_dict()
    assert (json.dumps(spans.chrome_trace([port]))
            == json.dumps(jax_spans.chrome_trace([jax])))


def test_a_span_with_a_parent_names_it_in_its_documents():
    rec = SpanRecorder()
    port = rec.add("fit.step", "fit", 0.25, 0.5, parent="fit", step=1)
    bare = rec.add("fit", "fit", 0.0, 1.0, parent="day")
    assert port.to_dict()["parent"] == "fit" and port.meta == {"step": 1}
    events = [e for e in spans.chrome_trace([port, bare])["traceEvents"] if e["ph"] == "X"]
    assert [e["args"] for e in events] == [{"step": 1, "parent": "fit"}, {"parent": "day"}]
    # the dataclass's fields stay the JAX package's
    assert ([f.name for f in dataclasses.fields(spans.Span)]
            == [f.name for f in dataclasses.fields(jax_spans.Span)])


# -- tools/fit_spans_trace.py's arithmetic, on a synthetic trace ----------


def _tool():
    path = ROOT / "tools" / "fit_spans_trace.py"
    spec = importlib.util.spec_from_file_location("fit_spans_trace", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(name, start, end, parent="fit"):
    return {"name": name, "parent": None if name == "fit" else parent, "start": start,
            "end": end, "meta": {}}


#: a fit from 100.0 to 100.1 s on the wall clock
SPANS = [
    _span("fit", 100.000, 100.100),
    _span("fit.prepare", 100.001, 100.010),
    _span("fit.init", 100.010, 100.012),
    _span("fit.indices", 100.012, 100.020),
    _span("fit.dispatch", 100.021, 100.060),
    _span("fit.step", 100.021, 100.023, "fit.dispatch"),
    _span("fit.step", 100.023, 100.026, "fit.dispatch"),
    _span("fit.step", 100.026, 100.0285, "fit.dispatch"),
    _span("fit.drain", 100.060, 100.099),
]
#: device operations: a copy in prepare, a kernel in init, the steps' kernels
EVENTS = [
    ["Memcpy HtoD (Pageable -> Device)", 100.008, 100.009],
    ["init_kernel", 100.0105, 100.0110],
    ["step_kernel", 100.0212, 100.0220],
    ["step_kernel", 100.0222, 100.050],
    ["step_kernel", 100.0505, 100.0985],
]
TRACE = {"t0": 99.999, "t1": 100.1, "events": EVENTS}


def test_the_trace_tool_reads_the_three_readings_and_the_skew():
    tool = _tool()
    got = tool.readings(SPANS)
    assert got["fit_setup_ms"] == pytest.approx(21.0)
    assert got["host_step_ms"] == pytest.approx(2.5)
    assert got["queue_ahead_ms"] == pytest.approx(39.0)
    skew = tool.skew(SPANS, EVENTS)
    assert skew == pytest.approx({"dispatch": 0.2, "drain": 0.5, "first": 8.0})
    assert tool.aligned(skew)
    assert not tool.aligned({**skew, "drain": -1.5})
    assert tool.skew(SPANS, []) == {"dispatch": None, "drain": None, "first": None}


def test_the_trace_tool_labels_each_gap_by_the_innermost_span_at_its_start():
    from portbench.harness import tracesum

    tool = _tool()
    plain = tracesum.breakdown(TRACE)["idle_gaps"]
    got = tool.labelled_gaps(TRACE, SPANS)
    assert [g[1] for g in got] == [g[1] for g in plain]
    prefixes = [label[:label.index("]") + 1] for label, _s in got]
    assert [label[len(p) + 1:] for p, (label, _s) in zip(prefixes, got)] == [
        label for label, _s in plain]
    # each gap by its start: the window's start (before the fit), in the
    # copy's phase, after the init kernel, inside a step, between the
    # steps' kernels, in the drain
    want = [("[fit.init]", 10.2), ("[-]", 9.0), ("[fit.prepare]", 1.5), ("[fit.drain]", 1.5),
            ("[fit.dispatch]", 0.5), ("[fit.step]", 0.2)]
    assert sorted((p, round(1e3 * sec, 6)) for p, (_l, sec) in zip(prefixes, got)) == sorted(
        want)
    assert got[1][0] == "[-] window start -> Memcpy HtoD (Pageable -> Device)"
    assert all(label.startswith("[unaligned] ")
               for label, _s in tool.labelled_gaps(TRACE, SPANS, is_aligned=False))


def test_the_trace_tool_splits_all_idle_time_by_span():
    from portbench.harness import tracesum

    tool = _tool()
    busy, window = tracesum.busy_window(TRACE)
    got = tool.idle_by_span(TRACE, SPANS)
    assert sum(got.values()) == pytest.approx(1e3 * (window - busy))
    assert got == pytest.approx({"-": 1.0, "fit": 3.0, "fit.prepare": 8.0, "fit.init": 1.5,
                                 "fit.indices": 8.0, "fit.step": 0.4, "fit.dispatch": 0.5,
                                 "fit.drain": 0.5})
    assert tool.innermost(SPANS, 100.022) == "fit.step"
    assert tool.innermost(SPANS, 100.0995) == "fit"
    assert tool.innermost(SPANS, 100.2) is None
