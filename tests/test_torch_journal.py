"""Crash-resumable days in the port (``pipeline/journal.py``,
``chaos/kill.py``, ``utils/shutdown.py``, the journalled ``run_day``)
against the JAX package's: journal documents byte-equal to JAX's under
the same calls, each package reading, verifying and fencing the other's
journal and lease, a port day crashed at every step boundary resuming to
the uncrashed day's artefacts, cross-package resume in both directions,
and ``cli run-day``'s exit codes 0 / 5 / 6 / 86 / 143 (``tests/test_journal.py``)."""
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from datetime import date
from pathlib import Path

import pytest
import torch

from bodywork_tpu.chaos import kill as jax_kill
from bodywork_tpu.data.drift_config import DriftConfig as JaxDrift
from bodywork_tpu.pipeline import LocalRunner as JaxRunner
from bodywork_tpu.pipeline import default_pipeline as jax_default_pipeline
from bodywork_tpu.pipeline import journal as jax_journal
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu.utils import shutdown as jax_shutdown
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.chaos import kill
from bodywork_tpu_torch.data.drift_config import DriftConfig
from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline
from bodywork_tpu_torch.pipeline import journal as journal_mod
from bodywork_tpu_torch.pipeline.journal import (
    JOURNAL_SCHEMA,
    LEASE_LOST_EXIT,
    RESUMED_NOOP_EXIT,
    LeaseLost,
    RunJournal,
    artefact_digest,
)
from bodywork_tpu_torch.pipeline.spec import GENERATE_STAGE, TEST_STAGE, TRAIN_STAGE
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.schema import MODELS_PREFIX, RUNS_PREFIX, run_journal_key
from bodywork_tpu_torch.utils.shutdown import (
    SIGTERM_EXIT,
    ShutdownRequested,
    grace_deadline_from_env,
    graceful_sigterm,
)
from test_torch_snapshot import CountingStore

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
START = date(2026, 8, 1)
DRIFT = DriftConfig(n_samples=60)
JKEY = run_journal_key(START)
#: the default pipeline's step boundaries in one day (one before each of
#: its 4 steps, one after the last)
BOUNDARIES = len(default_pipeline().dag) + 1


def _runner(store):
    return LocalRunner(default_pipeline(), store, drift=DRIFT, device="cpu")


def _doc(store):
    return json.loads(store.get_bytes(JKEY).decode())


@pytest.fixture(autouse=True)
def _no_leftover_kill_switch():
    yield
    kill.uninstall()
    jax_kill.uninstall()


def _strip_column(data: bytes, column: str) -> bytes:
    lines = data.decode().splitlines()
    if column not in lines[0].split(","):
        return data
    i = lines[0].split(",").index(column)
    return "\n".join(",".join(f for j, f in enumerate(line.split(",")) if j != i)
                     for line in lines).encode()


def artefacts(root) -> dict[str, bytes]:
    """The store's results: everything but what the chaos soak's
    comparison excludes (``chaos.sim._COMPARE_EXCLUDED``: the journals and
    snapshots, which are operational state, and the audit sidecars of
    the test metrics and snapshots, which hash a wall clock and version
    tokens), and the test metrics' response time (a wall clock)."""
    from bodywork_tpu_torch.chaos.sim import _COMPARE_EXCLUDED

    assert RUNS_PREFIX in _COMPARE_EXCLUDED and "snapshots/" in _COMPARE_EXCLUDED
    store = FilesystemStore(root)
    out = {}
    for key in store.list_keys():
        if key.startswith(_COMPARE_EXCLUDED):
            continue
        data = store.get_bytes(key)
        out[key] = _strip_column(data, "mean_response_time") if key.startswith(
            "test-metrics/") else data
    return out


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """One uncrashed port day on a bootstrapped store: the byte-identity
    truth of the resume tests."""
    root = tmp_path_factory.mktemp("baseline")
    runner = _runner(FilesystemStore(root))
    runner.bootstrap(START)
    runner.run_day(START)
    runner._compact_thread.join(timeout=30)
    assert not runner._compact_thread.is_alive()
    return root


def _copy(root, tmp_path, name="copy"):
    return shutil.copytree(root, tmp_path / name)


# -- the journal's bytes and its lease, across packages ------------------------

@pytest.mark.parametrize("kind", ["complete", "interrupted", "release"])
def test_journal_documents_are_the_jax_bytes(tmp_path, kind):
    """Acquire, intents, completes and the closing write under a fixed
    owner and a fake clock: the same bytes as JAX's ``RunJournal`` after
    every call."""
    ours_store, theirs_store = FilesystemStore(tmp_path / "p"), JaxStore(tmp_path / "j")
    ours = RunJournal(ours_store, START, owner="host:1:abc", lease_ttl_s=60, clock=lambda: 1000.5)
    theirs = jax_journal.RunJournal(theirs_store, START, owner="host:1:abc", lease_ttl_s=60,
                                    clock=lambda: 1000.5)
    for step in ("acquire", "intents", "completes", kind):
        if step == "acquire":
            ours.acquire(), theirs.acquire()
        elif step == "intents":
            ours.record_intents(["train", "serve"]), theirs.record_intents(["train", "serve"])
        elif step == "completes":
            done = {"train": {"models/m.npz": artefact_digest(b"x")}}
            ours.record_completes(done), theirs.record_completes(done)
        else:
            for j in (ours, theirs):
                {"complete": j.record_day_complete, "interrupted": j.record_interrupted,
                 "release": j.release}[kind]()
        assert ours_store.get_bytes(JKEY) == theirs_store.get_bytes(JKEY), step
    assert (JOURNAL_SCHEMA, LEASE_LOST_EXIT, RESUMED_NOOP_EXIT) == (
        jax_journal.JOURNAL_SCHEMA, jax_journal.LEASE_LOST_EXIT, jax_journal.RESUMED_NOOP_EXIT)
    assert journal_mod.DEFAULT_LEASE_TTL_S == jax_journal.DEFAULT_LEASE_TTL_S
    assert artefact_digest(b"abc") == jax_journal.artefact_digest(b"abc")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_and_verifies_the_others_journal(tmp_path, writer):
    FilesystemStore(tmp_path).put_bytes("models/good.npz", b"good")
    FilesystemStore(tmp_path).put_bytes("models/changed.npz", b"NEW")
    first, second = ((jax_journal.RunJournal, JaxStore), (RunJournal, FilesystemStore))
    if writer == "port":
        first, second = second, first
    j = first[0](first[1](tmp_path), START, owner="a", lease_ttl_s=60)
    j.acquire()
    j.record_intents(["ok", "changed", "gone", "pending"])
    j.record_completes({"ok": {"models/good.npz": artefact_digest(b"good")},
                        "changed": {"models/changed.npz": artefact_digest(b"old")},
                        "gone": {"models/gone.npz": artefact_digest(b"x")}})
    j.record_interrupted()
    reader = second[0](second[1](tmp_path), START, owner="b", lease_ttl_s=60)
    prior = reader.acquire()
    assert prior["status"] == "interrupted" and reader.prior_status == "interrupted"
    assert set(reader.completed_stages()) == {"ok", "changed", "gone"}  # not 'pending'
    verified, mismatch = reader.verify_completed()
    assert set(verified) == {"ok"} and mismatch
    assert _doc(FilesystemStore(tmp_path))["lease"]["owner"] == "b"


@pytest.mark.parametrize("holder", ["jax", "port"])
def test_a_live_lease_of_either_package_blocks_the_other(tmp_path, holder):
    journals = {"jax": lambda owner: jax_journal.RunJournal(JaxStore(tmp_path), START,
                                                           owner=owner, lease_ttl_s=900),
                "port": lambda owner: RunJournal(FilesystemStore(tmp_path), START,
                                                 owner=owner, lease_ttl_s=900)}
    journals[holder]("original").acquire()
    other = "port" if holder == "jax" else "jax"
    with pytest.raises(LeaseLost if other == "port" else jax_journal.LeaseLost):
        journals[other]("twin").acquire()


@pytest.mark.parametrize("old,new", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_expired_lease_takeover_bumps_the_fence_and_fences_out_the_old_holder(
        tmp_path, old, new):
    make = {"jax": (jax_journal.RunJournal, JaxStore, jax_journal.LeaseLost),
            "port": (RunJournal, FilesystemStore, LeaseLost)}
    t0 = 1000.0
    cls, store_cls, _lost = make[old]
    dead = cls(store_cls(tmp_path), START, owner="dead", lease_ttl_s=10, clock=lambda: t0)
    dead.acquire()
    fence = _doc(FilesystemStore(tmp_path))["lease"]["fence"]
    cls, store_cls, _ = make[new]
    cls(store_cls(tmp_path), START, owner="successor", lease_ttl_s=10,
        clock=lambda: t0 + 11).acquire()
    doc = _doc(FilesystemStore(tmp_path))
    assert doc["lease"]["owner"] == "successor" and doc["lease"]["fence"] == fence + 1
    with pytest.raises(make[old][2]):
        dead.record_intents(["train"])


def test_release_frees_the_day_at_once(tmp_path):
    j = RunJournal(FilesystemStore(tmp_path), START, owner="a", lease_ttl_s=900)
    j.acquire()
    j.release()
    RunJournal(FilesystemStore(tmp_path), START, owner="b", lease_ttl_s=900).acquire()


def test_every_journal_mutation_rides_the_cas(tmp_path):
    counting = CountingStore(FilesystemStore(tmp_path))
    j = RunJournal(counting, START, owner="a", lease_ttl_s=60)
    assert j.acquire() is None and j.completed_stages() == {}
    j.record_intents(["train"])
    j.record_completes({"train": {"models/m.npz": artefact_digest(b"x")}})
    j.record_day_complete()
    doc = _doc(counting)
    assert doc["status"] == "complete" and doc["lease"]["owner"] is None
    assert counting.by_key.get(("put_bytes", JKEY), 0) == 0
    assert counting.by_key[("put_bytes_if_match", JKEY)] == 4


def test_no_raw_writes_of_a_journal_in_the_port():
    raw_write = re.compile(r"put_(?:bytes|text)\(\s*(?:run_journal_key\(|[\"']runs/)")
    offenders = [str(p) for p in (ROOT / "bodywork_tpu_torch").rglob("*.py")
                 if raw_write.search(p.read_text())]
    assert offenders == []
    source = (ROOT / "bodywork_tpu_torch" / "pipeline" / "journal.py").read_text()
    assert "put_bytes_if_match(" in source
    assert re.search(r"\bself\.store\.put_bytes\(", source) is None


@pytest.mark.parametrize("garbage", [b"\x00not json at all", b"{torn mid-write",
                                     b'{"schema": "bodywork_tpu.run_journal/1", '
                                     b'"doc_digest": "sha256:00"}'])
def test_a_corrupt_journal_is_repaired_into_a_full_rerun(tmp_path, garbage):
    store = CountingStore(FilesystemStore(tmp_path))
    store.put_bytes(JKEY, garbage)
    j = RunJournal(store, START, owner="a", lease_ttl_s=60)
    assert j.acquire() is None and j.was_corrupt and j.completed_stages() == {}
    # read past the retry budget, then CAS-repaired in place
    assert store.by_key[("get_bytes", JKEY)] == 1 + journal_mod.CORRUPT_READ_RETRIES
    assert _doc(store)["schema"] == JOURNAL_SCHEMA
    # and the JAX package reads the repaired document
    jax_journal.RunJournal(JaxStore(tmp_path), START, owner="a", lease_ttl_s=60).acquire()


def test_verify_completed_refuses_a_changed_or_missing_artefact(tmp_path):
    store = FilesystemStore(tmp_path)
    store.put_bytes("models/good.npz", b"good")
    store.put_bytes("models/changed.npz", b"NEW BYTES")
    j = RunJournal(store, START, owner="a", lease_ttl_s=60)
    j.acquire()
    j.record_completes({"ok-stage": {"models/good.npz": artefact_digest(b"good")},
                        "changed-stage": {"models/changed.npz": artefact_digest(b"old")},
                        "gone-stage": {"models/gone.npz": artefact_digest(b"x")},
                        "nothing-recorded": {}})
    j2 = RunJournal(store, START, owner="b", lease_ttl_s=60, clock=lambda: time.time() + 120)
    j2.acquire()
    verified, mismatch = j2.verify_completed()
    assert set(verified) == {"ok-stage"} and mismatch


# -- the kill switch and the SIGTERM handler -----------------------------------

@pytest.mark.parametrize("schedule", [
    [{"kind": "bogus", "n": 0}], [{"kind": "stage_boundary"}],
    [{"kind": "stage_boundary", "n": 0, "extra": 1}],
    [{"kind": "store_op", "op": "nope", "key": "k", "n": 0}],
    [{"kind": "store_op", "op": "put_bytes", "n": 0}],
])
def test_parse_schedule_refuses_what_the_jax_one_refuses(schedule):
    with pytest.raises(ValueError):
        jax_kill.parse_schedule(schedule)
    with pytest.raises(ValueError):
        kill.parse_schedule(schedule)


def test_a_schedule_means_the_same_to_both_packages():
    raw = '[{"kind": "stage_boundary", "n": 2}, ' \
          '{"kind": "store_op", "op": "put_bytes", "key": "models/a.npz", "n": 1}]'
    assert kill.parse_schedule(raw) == jax_kill.parse_schedule(raw)
    assert (kill.ENV_SCHEDULE, kill.EXIT_KILLED, kill.COUNTED_STORE_OPS) == (
        jax_kill.ENV_SCHEDULE, jax_kill.EXIT_KILLED, jax_kill.COUNTED_STORE_OPS)
    with pytest.raises(ValueError):
        kill.KillSwitch([], action="explode")


def test_kill_switch_fires_at_the_nth_hit_of_its_stream_only():
    sw = kill.KillSwitch([{"kind": "store_op", "op": "put_bytes", "key": "a", "n": 1}],
                         action="raise")
    sw.hit("store_op", op="put_bytes", key="a")
    sw.hit("store_op", op="put_bytes", key="b")
    sw.hit("store_op", op="get_bytes", key="a")
    with pytest.raises(kill.SimulatedCrash):
        sw.hit("store_op", op="put_bytes", key="a")
    assert sw.fired == [("store|put_bytes|a", 1)]


def test_kill_switch_store_dies_before_the_write_lands(tmp_path):
    store = FilesystemStore(tmp_path)
    assert kill.wrap_store(store) is store  # unarmed: untouched
    kill.install(kill.KillSwitch(
        [{"kind": "store_op", "op": "put_bytes", "key": "models/a.npz", "n": 0}],
        action="raise"))
    wrapped = kill.wrap_store(store)
    assert wrapped is not store
    with pytest.raises(kill.SimulatedCrash):
        wrapped.put_bytes("models/a.npz", b"x")
    assert not store.exists("models/a.npz")


def test_graceful_sigterm_unwinds_once_and_ignores_repeats(monkeypatch):
    force_exits = []
    monkeypatch.setattr(os, "_exit", lambda code: force_exits.append(code))
    got = []
    with graceful_sigterm(deadline_s=0.2) as fired:
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(2)
            raise AssertionError("SIGTERM never unwound")
        except ShutdownRequested:
            got.append("unwound")
            os.kill(os.getpid(), signal.SIGTERM)  # the second one is ignored
            time.sleep(0.05)
    assert got == ["unwound"] and fired.is_set()
    time.sleep(0.4)
    assert force_exits == []  # the watchdog was cancelled on exit


def test_sigterm_watchdog_force_exits_a_wedged_unwind(monkeypatch):
    force_exits = []
    monkeypatch.setattr(os, "_exit", lambda code: force_exits.append(code))
    with graceful_sigterm(deadline_s=0.1):
        try:
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(2)
        except ShutdownRequested:
            time.sleep(0.4)
    assert force_exits == [SIGTERM_EXIT] == [jax_shutdown.SIGTERM_EXIT]


@pytest.mark.parametrize("raw,want", [("7.5", 7.5), ("bogus", 3.0), ("-1", 3.0),
                                      ("nan", 3.0), ("", 3.0)])
def test_grace_deadline_env_parse_is_the_jax_one(monkeypatch, raw, want):
    monkeypatch.setenv("BODYWORK_TPU_GRACE_S", raw)
    assert grace_deadline_from_env(3.0) == want == jax_shutdown.grace_deadline_from_env(3.0)


# -- the journalled day: resume in the port ------------------------------------

@pytest.mark.parametrize("n", range(BOUNDARIES))
def test_a_day_crashed_at_each_boundary_resumes_to_the_uncrashed_artefacts(
        baseline, tmp_path, monkeypatch, n):
    monkeypatch.setenv("BODYWORK_TPU_RUN_LEASE_TTL_S", "0.05")
    store = FilesystemStore(tmp_path)
    runner = _runner(store)
    runner.bootstrap(START)
    kill.install(kill.KillSwitch([{"kind": "stage_boundary", "n": n}], action="raise"))
    with pytest.raises(kill.SimulatedCrash):
        runner.run_day(START)
    kill.uninstall()
    doc = _doc(store)
    assert doc["status"] == "running" and doc["lease"]["owner"] is not None  # no cleanup
    time.sleep(0.1)  # the dead runner's lease expires
    result = _runner(FilesystemStore(tmp_path)).run_day(START)
    assert not result.noop and _doc(store)["status"] == "complete"
    done = {1: (TRAIN_STAGE,), 2: (TRAIN_STAGE,), 3: (TRAIN_STAGE, GENERATE_STAGE),
            4: (TRAIN_STAGE, GENERATE_STAGE, TEST_STAGE)}
    assert result.skipped_stages == done.get(n, ())
    assert artefacts(tmp_path) == artefacts(baseline)


def test_a_fully_resumed_day_is_a_noop_with_no_stage_write(baseline, tmp_path):
    counting = CountingStore(FilesystemStore(_copy(baseline, tmp_path)))
    result = _runner(counting).run_day(START)
    assert result.noop and set(result.skipped_stages) == set(default_pipeline().stages)
    assert all(s == 0.0 for s in result.stage_seconds.values())
    assert [k for (op, k), n in counting.by_key.items() if op == "put_bytes" and n] == []
    assert [k for (op, k), n in counting.by_key.items()
            if op == "put_bytes_if_match" and n] == [JKEY]


def test_a_half_resumed_day_reruns_only_the_tail(tmp_path, monkeypatch):
    monkeypatch.setenv("BODYWORK_TPU_RUN_LEASE_TTL_S", "0.05")
    store = FilesystemStore(tmp_path)
    runner = _runner(store)
    runner.bootstrap(START)
    kill.install(kill.KillSwitch([{"kind": "stage_boundary", "n": 1}], action="raise"))
    with pytest.raises(kill.SimulatedCrash):
        runner.run_day(START)
    kill.uninstall()
    assert _doc(store)["stages"][TRAIN_STAGE]["state"] == "complete"
    time.sleep(0.1)
    counting = CountingStore(store)
    result = _runner(counting).run_day(START)
    assert result.skipped_stages == (TRAIN_STAGE,)
    assert result.stage_seconds[TRAIN_STAGE] == 0.0
    assert [k for (op, k) in counting.by_key
            if op in ("put_bytes", "put_bytes_if_match") and k.startswith(MODELS_PREFIX)] == []


def test_a_digest_mismatch_forces_a_rerun(baseline, tmp_path):
    store = FilesystemStore(_copy(baseline, tmp_path))
    store.put_bytes(store.list_keys(MODELS_PREFIX)[0], b"TAMPERED")
    result = _runner(store).run_day(START)
    assert not result.noop and TRAIN_STAGE not in result.skipped_stages
    assert result.stage_seconds[TRAIN_STAGE] > 0.0


def test_a_corrupt_journal_degrades_the_day_to_a_full_rerun(baseline, tmp_path):
    store = FilesystemStore(_copy(baseline, tmp_path))
    store.put_bytes(JKEY, b"{torn mid-write")
    result = _runner(store).run_day(START)
    assert not result.noop and result.skipped_stages == ()
    assert _doc(store)["status"] == "complete"


def test_no_resume_leaves_no_journal(tmp_path):
    store = CountingStore(FilesystemStore(tmp_path))
    runner = _runner(store)
    runner.bootstrap(START)
    runner.run_day(START, resume=False)
    assert not [k for (_op, k) in store.by_key if k.startswith(RUNS_PREFIX)]


def test_sigterm_mid_day_journals_interrupted_and_the_next_run_resumes(tmp_path, monkeypatch):
    store = FilesystemStore(tmp_path)
    runner = _runner(store)
    runner.bootstrap(START)
    real = RunJournal.record_intents
    calls = []

    def intercept(self, names):
        calls.append(names)
        if len(calls) == 2:  # the serve step, after train completed
            raise ShutdownRequested("SIGTERM")
        return real(self, names)

    monkeypatch.setattr(RunJournal, "record_intents", intercept)
    with pytest.raises(ShutdownRequested):
        runner.run_day(START)
    doc = _doc(store)
    assert doc["status"] == "interrupted" and doc["lease"]["owner"] is None
    assert doc["stages"][TRAIN_STAGE]["state"] == "complete"
    result = _runner(store).run_day(START)  # no lease to wait out
    assert _doc(store)["status"] == "complete" and TRAIN_STAGE in result.skipped_stages


# -- cross-package resume ------------------------------------------------------

def test_the_port_resumes_a_jax_day_crashed_after_train(tmp_path, monkeypatch):
    monkeypatch.setenv("BODYWORK_TPU_RUN_LEASE_TTL_S", "0.05")
    jax_runner = JaxRunner(jax_default_pipeline(), JaxStore(tmp_path), drift=JaxDrift(n_samples=60))
    jax_runner.bootstrap(START)
    jax_kill.install(jax_kill.KillSwitch([{"kind": "stage_boundary", "n": 1}], action="raise"))
    with pytest.raises(jax_kill.SimulatedCrash):
        jax_runner.run_day(START)
    jax_kill.uninstall()
    model_key = FilesystemStore(tmp_path).list_keys(MODELS_PREFIX)[0]
    jax_model = FilesystemStore(tmp_path).get_bytes(model_key)
    time.sleep(0.1)
    counting = CountingStore(FilesystemStore(tmp_path))
    result = _runner(counting).run_day(START)
    assert result.skipped_stages == (TRAIN_STAGE,)  # on the JAX package's digests
    assert not [k for (op, k) in counting.by_key if op == "put_bytes" and k == model_key]
    assert FilesystemStore(tmp_path).get_bytes(model_key) == jax_model
    served = result.stage_results["stage-2-serve-model"].app.healthz_payload()
    assert served["model_key"] == model_key and served["model_source"] == "production"
    assert _doc(FilesystemStore(tmp_path))["status"] == "complete"


def test_the_jax_package_resumes_a_port_day_crashed_after_train(tmp_path, monkeypatch):
    monkeypatch.setenv("BODYWORK_TPU_RUN_LEASE_TTL_S", "0.05")
    runner = _runner(FilesystemStore(tmp_path))
    runner.bootstrap(START)
    kill.install(kill.KillSwitch([{"kind": "stage_boundary", "n": 1}], action="raise"))
    with pytest.raises(kill.SimulatedCrash):
        runner.run_day(START)
    kill.uninstall()
    model_key = FilesystemStore(tmp_path).list_keys(MODELS_PREFIX)[0]
    port_model = FilesystemStore(tmp_path).get_bytes(model_key)
    time.sleep(0.1)
    result = JaxRunner(jax_default_pipeline(), JaxStore(tmp_path),
                       drift=JaxDrift(n_samples=60)).run_day(START)
    assert result.skipped_stages == (TRAIN_STAGE,)
    assert FilesystemStore(tmp_path).get_bytes(model_key) == port_model
    assert _doc(FilesystemStore(tmp_path))["status"] == "complete"


# -- the command line ----------------------------------------------------------

ARGS = ["--device", "cpu", "--date", str(START)]


def test_cli_run_day_exits_0_then_6_then_5_under_a_live_foreign_lease(tmp_path, capsys):
    root = str(tmp_path / "s")
    assert cli.main(["run-day", "--store", root, *ARGS]) == 0
    assert cli.main(["run-day", "--store", root, *ARGS]) == RESUMED_NOOP_EXIT
    assert "already complete" in capsys.readouterr().out
    # a live lease of another runner (here the JAX package's) on the next day
    nxt = date(2026, 8, 2)
    jax_journal.RunJournal(JaxStore(root), nxt, owner="other:1:x", lease_ttl_s=900).acquire()
    assert cli.main(["run-day", "--store", root, "--device", "cpu",
                     "--date", str(nxt)]) == LEASE_LOST_EXIT
    # --no-resume ignores the journal: a full re-run of the complete day
    assert cli.main(["run-day", "--store", root, *ARGS, "--no-resume"]) == 0


def test_cli_run_sim_exits_5_when_a_day_of_it_is_leased(tmp_path, capsys):
    root = str(tmp_path / "s")
    RunJournal(FilesystemStore(root), date(2026, 8, 2), owner="other:1:x",
               lease_ttl_s=900).acquire()
    assert cli.main(["run-sim", "--store", root, "--days", "2", *ARGS]) == LEASE_LOST_EXIT
    # the first day ran and completed; the leased one was left alone
    assert _doc(FilesystemStore(root))["status"] == "complete"
    leased = json.loads(FilesystemStore(root).get_bytes(run_journal_key(date(2026, 8, 2))))
    assert leased["lease"]["owner"] == "other:1:x" and leased["stages"] == {}


def test_exit_codes_are_the_jax_ones_and_distinct():
    from bodywork_tpu.cli import ROLLBACK_REFUSED_EXIT as JAX_ROLLBACK

    codes = (0, 1, 2, LEASE_LOST_EXIT, RESUMED_NOOP_EXIT, cli.ROLLBACK_REFUSED_EXIT,
             kill.EXIT_KILLED, SIGTERM_EXIT)
    assert len(set(codes)) == len(codes)
    assert (LEASE_LOST_EXIT, RESUMED_NOOP_EXIT, cli.ROLLBACK_REFUSED_EXIT, kill.EXIT_KILLED,
            SIGTERM_EXIT) == (5, 6, JAX_ROLLBACK, 86, 143)


def _cli(root, *extra, env=None, **kw):
    return subprocess.Popen(
        [sys.executable, "-m", "bodywork_tpu_torch.cli", "run-day", "--store", str(root),
         *ARGS, *extra],
        # one CPU thread: the tests' workers share the machine's cores
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
                       **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kw)


def test_cli_killed_at_a_boundary_exits_86_and_the_restart_resumes(tmp_path):
    env = {"BODYWORK_TPU_RUN_LEASE_TTL_S": "0.5"}
    proc = _cli(tmp_path, env={**env, kill.ENV_SCHEDULE: '[{"kind": "stage_boundary", "n": 1}]'})
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == kill.EXIT_KILLED, out
    store = FilesystemStore(tmp_path)
    assert _doc(store)["stages"][TRAIN_STAGE]["state"] == "complete"
    time.sleep(0.6)  # the killed runner's lease expires
    proc = _cli(tmp_path, env=env)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert f"resumed — skipped {TRAIN_STAGE} (journal-verified)" in out
    assert _doc(store)["status"] == "complete"


def test_cli_sigterm_mid_train_exits_143_and_the_next_run_resumes(tmp_path):
    mlp = ["--model", "mlp", "--mlp-hidden", "8,8", "--mlp-steps", "2000"]
    proc = _cli(tmp_path, *mlp)
    store = FilesystemStore(tmp_path)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:  # wait for the train stage's intent
        try:
            if _doc(store)["stages"].get(TRAIN_STAGE, {}).get("state") == "intent":
                break
        except Exception:  # noqa: BLE001 - not written yet
            pass
        time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("the train stage never started")
    time.sleep(0.3)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == SIGTERM_EXIT, out
    doc = _doc(store)
    assert doc["status"] == "interrupted" and doc["lease"]["owner"] is None
    assert doc["stages"][TRAIN_STAGE]["state"] == "intent"
    proc = _cli(tmp_path, *mlp)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out
    assert _doc(store)["status"] == "complete"
