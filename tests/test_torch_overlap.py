"""The overlap machinery of the port's day loop (``tests/test_overlap.py``):
the horizon's dataset prefetch, the lookahead train and its handoff, and
``default_pipeline(overlap_generate=True)``, each held to leave the
artefacts byte-identical to the serial loop's, in full and incremental
mode, for the linear model and a narrow MLP."""
import threading
from datetime import date, timedelta

import pytest
import torch

from bodywork_tpu.pipeline import default_pipeline as jax_default_pipeline
from bodywork_tpu.pipeline.stages import stage_artefact_keys as jax_stage_artefact_keys
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch.data import generate_day
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.pipeline.spec import GENERATE_STAGE, TEST_STAGE, TRAIN_STAGE
from bodywork_tpu_torch.pipeline.stages import (
    StageContext,
    generate_stage,
    stage_artefact_keys,
    train_stage,
)
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.schema import DATASETS_PREFIX, MODELS_PREFIX
from test_torch_journal import ROOT, artefacts

torch.set_num_threads(1)

START = date(2026, 3, 1)
CPU = torch.device("cpu")


@pytest.fixture
def store(tmp_path):
    return FilesystemStore(tmp_path / "store")


@pytest.fixture
def runner(store):
    return LocalRunner(default_pipeline(overlap_generate=True), store, device="cpu")


def _done_thread():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return t


@pytest.mark.parametrize("model_type", ["linear", "mlp"])
@pytest.mark.parametrize("overlap", [False, True])
def test_overlapped_pipeline_is_the_jax_one(model_type, overlap):
    got = default_pipeline(model_type, overlap_generate=overlap)
    want = jax_default_pipeline(model_type, overlap_generate=overlap)
    assert got.dag == want.dag and list(got.stages) == list(want.stages)


def test_horizon_prefetch_is_the_inline_generation(runner):
    targets = [START + timedelta(days=i) for i in range(3)]
    runner._enqueue_generate(targets)
    for t in targets:
        box = runner._dataset_boxes[t]
        assert box["ready"].wait(timeout=60)
        X, y = generate_day(t, runner.drift, device="cpu")
        assert box["X"].tobytes() == X.tobytes() and box["y"].tobytes() == y.tobytes()


def test_enqueue_generate_dedupes(runner):
    runner._enqueue_generate([START])
    box = runner._dataset_boxes[START]
    runner._enqueue_generate([START, START])
    assert runner._dataset_boxes[START] is box


def test_concurrent_enqueues_make_one_box_a_date_and_fill_each(runner):
    """More enqueuing threads than cores, switching every few
    microseconds, over overlapping dates: one box a date, every box
    filled with that date's inline draws, and the worker gone after."""
    import sys

    targets = [START + timedelta(days=i) for i in range(6)]
    seen: list = []
    lock = threading.Lock()

    def enqueue(k):
        mine = targets[k % 3:] + targets[:k % 3]
        runner._enqueue_generate(mine)
        with lock:
            seen.extend((t, id(runner._dataset_boxes[t])) for t in mine)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=enqueue, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert {t: {i for d, i in seen if d == t} for t in targets} == \
        {t: {id(runner._dataset_boxes[t])} for t in targets}
    for t in targets:
        box = runner._dataset_boxes[t]
        assert box["ready"].wait(timeout=60)
        X, y = generate_day(t, runner.drift, device="cpu")
        assert box["X"].tobytes() == X.tobytes() and box["y"].tobytes() == y.tobytes()
    worker = runner._gen_worker
    if worker is not None:
        worker.join(timeout=60)
        assert not worker.is_alive()


def test_generate_stage_persists_its_prefetched_box(store, monkeypatch):
    import bodywork_tpu_torch.data.generator as gen

    target = START + timedelta(days=1)
    X, y = generate_day(target, device="cpu")
    box = {"ready": threading.Event(), "X": X, "y": y}
    box["ready"].set()
    monkeypatch.setattr(gen, "generate_day", lambda *a, **k: pytest.fail("generated inline"))
    ctx = StageContext(store=store, today=START, device=CPU, prefetched_datasets={target: box})
    key = generate_stage(ctx)
    assert str(target) in key and target not in ctx.prefetched_datasets
    assert store.history(DATASETS_PREFIX)


def test_generate_stage_falls_back_when_the_prefetch_failed(store):
    target = START + timedelta(days=1)
    box = {"ready": threading.Event()}  # the worker died before X/y
    box["ready"].set()
    ctx = StageContext(store=store, today=START, device=CPU, prefetched_datasets={target: box})
    key = generate_stage(ctx)
    X, _y = generate_day(target, device="cpu")
    assert str(target) in key and len(store.get_text(key).splitlines()) == 1 + len(X)


def test_train_stage_collects_a_lookahead_result(store, runner):
    runner.bootstrap(START)
    sentinel = type("Done", (), {"model_artefact_key": "models/x.npz"})()
    ctx = StageContext(store=store, today=START, device=CPU,
                       prefetched_train={"thread": _done_thread(), "result": sentinel})
    assert train_stage(ctx) is sentinel


def test_train_stage_retrains_inline_when_the_lookahead_failed(store, runner):
    runner.bootstrap(START)
    ctx = StageContext(store=store, today=START, device=CPU,
                       prefetched_train={"thread": _done_thread(), "exc": RuntimeError("boom")})
    result = train_stage(ctx)
    assert result.model_artefact_key == f"models/regressor-{START}.npz"


def test_a_lookahead_never_persists_before_it_is_collected(store, runner):
    runner.bootstrap(START)
    runner.run_day(START, lookahead_train=True)
    tomorrow, box = runner._pending_train
    assert tomorrow == START + timedelta(days=1)
    box["thread"].join(timeout=60)
    assert "result" in box and box["result"].model_artefact_key is None
    assert [k for k, _ in store.history(MODELS_PREFIX)] == [f"models/regressor-{START}.npz"]
    r = runner.run_day(tomorrow)  # collects and persists it
    assert r.lookahead_train_s == box["seconds"] > 0
    assert f"models/regressor-{tomorrow}.npz" in [k for k, _ in store.history(MODELS_PREFIX)]
    assert r.stage_results[TRAIN_STAGE].model_artefact_key == f"models/regressor-{tomorrow}.npz"


def test_stage_artefact_keys_are_the_jax_keys(store, runner):
    runner.bootstrap(START)
    r = runner.run_day(START, resume=False)
    ctx = StageContext(store=store, today=START, device=CPU)
    jax_ctx = type("Ctx", (), {"store": JaxStore(store.root)})()
    for name in (TRAIN_STAGE, GENERATE_STAGE, TEST_STAGE):
        spec = runner.spec.stages[name]
        got = stage_artefact_keys(spec, r.stage_results[name], ctx)
        assert got and got == jax_stage_artefact_keys(spec, r.stage_results[name], jax_ctx)


LINEAR = {}
MLP = {"hidden": [8, 8], "n_steps": 200}


@pytest.mark.parametrize("mode", ["full", "incremental"])
@pytest.mark.parametrize("model_type,kwargs", [("linear", LINEAR), ("mlp", MLP)],
                         ids=["linear", "mlp"])
def test_pipelined_simulation_writes_the_serial_artefacts(tmp_path, model_type, kwargs, mode):
    """``run_simulation`` (horizon prefetch, lookahead train, compactor,
    the journal) against plain ``run_day`` calls with nothing prefetched
    or trained ahead: byte-identical datasets, checkpoints, metrics,
    trainstate and registry records on every day."""
    days = 3

    def runner_at(name, overlap):
        spec = default_pipeline(model_type, overlap_generate=overlap)
        spec.stages[TRAIN_STAGE].args.update(kwargs, mode=mode)
        return LocalRunner(spec, FilesystemStore(tmp_path / name), device="cpu")

    serial = runner_at("serial", False)
    serial._enqueue_generate = lambda targets: None  # generate inline
    serial.bootstrap(START)
    for i in range(days):
        r = serial.run_day(START + timedelta(days=i))
        assert r.prefetched == 0 and r.lookahead_train_s is None
    for overlap in (False, True):
        pipelined = runner_at(f"pipelined-{overlap}", overlap)
        results = pipelined.run_simulation(START, days)
        assert [r.prefetched for r in results] == [1] * days
        assert [r.lookahead_train_s is not None for r in results] == [False] + [True] * (days - 1)
        assert artefacts(tmp_path / f"pipelined-{overlap}") == artefacts(tmp_path / "serial")


def test_a_failed_lookahead_trains_inline_and_the_day_reports_it(tmp_path, monkeypatch):
    import bodywork_tpu_torch.pipeline.runner as runner_mod

    runner = LocalRunner(default_pipeline(), FilesystemStore(tmp_path), device="cpu")
    real = runner_mod.resolve_executable

    def failing_lookahead(path):
        fn = real(path)
        if not path.endswith(":train_stage"):
            return fn

        def train(ctx, **kw):
            if ctx.defer_artefacts:
                raise RuntimeError("lookahead broke")
            return fn(ctx, **kw)
        return train

    monkeypatch.setattr(runner_mod, "resolve_executable", failing_lookahead)
    results = runner.run_simulation(START, 2)
    assert [r.lookahead_train_s for r in results] == [None, None]
    assert results[1].stage_results[TRAIN_STAGE].model_artefact_key.endswith(
        f"{START + timedelta(days=1)}.npz")


def test_background_threads_end_before_the_interpreter(tmp_path):
    """A failed day leaves the next day's prefetch running; the process
    still exits with the failure's code, not an abort from a thread
    inside torch at teardown."""
    import subprocess
    import sys

    code = (
        "import sys; from datetime import date\n"
        "from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline\n"
        "from bodywork_tpu_torch.store import FilesystemStore\n"
        "r = LocalRunner(default_pipeline(), FilesystemStore(sys.argv[1]), device='cpu')\n"
        "r.spec.stages['stage-2-serve-model'].executable = 'nowhere:serve'\n"
        "r.bootstrap(date(2026, 3, 1))\n"
        "r.run_day(date(2026, 3, 1))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 1 and "StageFailure" in proc.stderr, proc.stderr[-2000:]


def test_cli_run_sim_overlap_generate_writes_the_serial_artefacts(tmp_path, capsys):
    """``run-sim --overlap-generate`` runs the overlapped DAG and leaves the
    artefacts of the reference's serial DAG; each day prints the launches
    of every kernel in the process."""
    import json

    from bodywork_tpu_torch import cli
    from bodywork_tpu_torch.ops.mlp_kernel import LAUNCHES

    args = ["--days", "2", "--device", "cpu", "--date", str(START)]
    for name, extra in (("serial", []), ("overlap", ["--overlap-generate"])):
        assert cli.main(["run-sim", "--store", str(tmp_path / name), *args, *extra]) == 0
    out = capsys.readouterr().out
    printed = [line.split(": ", 1)[1] for line in out.splitlines()
               if line.startswith("  launches by kernel in this process: ")]
    assert len(printed) == 4 and json.loads(printed[-1]).keys() == LAUNCHES.keys()
    assert artefacts(tmp_path / "overlap") == artefacts(tmp_path / "serial")
