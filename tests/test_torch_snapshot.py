"""The cold-path data plane of the port (``data/snapshot.py``, the parse
and concatenation caches of ``data/io.py``) against the JAX package's on
the same store: ``load_all_datasets`` byte-identical to JAX's whether the
snapshot is present, stale, corrupt, absent or out of date for an
overwritten day; each package reading the other's snapshot as a hit; the
store-read budgets of ``tests/test_snapshot.py``; keep-2 pruning,
``refresh_due``, ``plan_compaction`` and ``cli compact``."""
from datetime import date, timedelta

import numpy as np
import pytest
import torch

from bodywork_tpu.data import snapshot as jax_snapshot
from bodywork_tpu.data.io import load_all_datasets as jax_load_all
from bodywork_tpu.store import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.data import snapshot as snapshot_mod
from bodywork_tpu_torch.data.io import Dataset, load_all_datasets, persist_dataset
from bodywork_tpu_torch.store import FilesystemStore
from bodywork_tpu_torch.store.base import ArtefactStore
from bodywork_tpu_torch.store.schema import SNAPSHOTS_PREFIX, dataset_key
from helpers import make_counting_store as make_jax_counting_store

torch.set_num_threads(1)

START = date(2026, 3, 1)


class CountingStore(ArtefactStore):
    """Tallies store operations per op and per (op, key) over any port
    store. Its caches are its own (``mutable_cache`` is not delegated), so
    a fresh one stands for a cold process; ``get_many`` is the base's,
    one ``get_bytes`` a key."""

    def __init__(self, inner: ArtefactStore):
        self.inner = inner
        self.ops: dict = {}
        self.by_key: dict = {}

    def _count(self, op, key=None):
        self.ops[op] = self.ops.get(op, 0) + 1
        if key is not None:
            self.by_key[(op, key)] = self.by_key.get((op, key), 0) + 1

    def reset_counts(self):
        self.ops.clear()
        self.by_key.clear()

    def put_bytes(self, key, data):
        self._count("put_bytes", key)
        self.inner.put_bytes(key, data)

    def put_bytes_if_match(self, key, data, expected_token=None):
        self._count("put_bytes_if_match", key)
        return self.inner.put_bytes_if_match(key, data, expected_token)

    def get_bytes(self, key):
        self._count("get_bytes", key)
        return self.inner.get_bytes(key)

    def list_keys(self, prefix=""):
        self._count("list_keys", prefix)
        return self.inner.list_keys(prefix)

    def exists(self, key):
        self._count("exists", key)
        return self.inner.exists(key)

    def delete(self, key):
        self._count("delete", key)
        self.inner.delete(key)

    def version_token(self, key):
        self._count("version_token", key)
        return self.inner.version_token(key)

    def version_tokens(self, keys):
        self._count("version_tokens")
        return self.inner.version_tokens(keys)

    def gets(self, prefix=""):
        return sum(n for (op, key), n in self.by_key.items()
                   if op == "get_bytes" and key.startswith(prefix))


def seed_days(store, days, rows=20, seed=0, start=START):
    rng = np.random.default_rng(seed)
    for i in range(days):
        X = rng.uniform(0, 100, rows).astype(np.float32)
        y = (1.0 + 0.5 * X + rng.normal(0, 1, rows)).astype(np.float32)
        persist_dataset(store, Dataset(X, y, start + timedelta(days=i)))


def assert_same(a, b):
    """Byte-identical arrays (shape, dtype and bytes) and the same date."""
    assert a.X.dtype == b.X.dtype == np.float32 and a.y.dtype == b.y.dtype == np.float32
    assert a.X.shape == b.X.shape and a.y.shape == b.y.shape
    assert a.X.tobytes() == b.X.tobytes() and a.y.tobytes() == b.y.tobytes()
    assert a.date == b.date


def drop_snapshots(root):
    store = FilesystemStore(root)
    for key in store.list_keys(SNAPSHOTS_PREFIX):
        store.delete(key)


WRITERS = {
    "port": lambda root: snapshot_mod.write_snapshot(FilesystemStore(root)),
    "jax": lambda root: jax_snapshot.write_snapshot(JaxStore(root)),
}


def _state_present(root, write):
    write(root)


def _state_stale(root, write):
    write(root)
    seed_days(FilesystemStore(root), days=2, seed=7, start=START + timedelta(days=5))


def _state_corrupt_newest(root, write):
    write(root)
    seed_days(FilesystemStore(root), days=1, seed=8, start=START + timedelta(days=5))
    write(root)
    newest = FilesystemStore(root).history(SNAPSHOTS_PREFIX)[-1][0]
    FilesystemStore(root).put_bytes(newest, b"\x00torn")


def _state_all_corrupt(root, write):
    key = write(root)
    FilesystemStore(root).put_bytes(key, b"\x00not-an-npz")


def _state_absent(root, write):
    pass


def _state_overwritten(root, write):
    write(root)
    X = np.full(9, 3.0, np.float32)
    persist_dataset(FilesystemStore(root), Dataset(X, 4 * X, START))


STATES = {
    "present": _state_present, "stale": _state_stale,
    "corrupt-newest": _state_corrupt_newest, "all-corrupt": _state_all_corrupt,
    "absent": _state_absent, "covered-day-overwritten": _state_overwritten,
}


@pytest.mark.parametrize("writer", sorted(WRITERS))
@pytest.mark.parametrize("state", sorted(STATES))
def test_load_all_datasets_is_the_jax_load_in_every_snapshot_state(tmp_path, state, writer):
    seed_days(FilesystemStore(tmp_path), days=5)
    STATES[state](tmp_path, WRITERS[writer])
    got = load_all_datasets(FilesystemStore(tmp_path))
    assert_same(got, jax_load_all(JaxStore(tmp_path)))
    # and the pure per-day path agrees with the cached ones
    drop_snapshots(tmp_path)
    assert_same(got, load_all_datasets(FilesystemStore(tmp_path)))


def test_property_every_history_shape_and_snapshot_state_loads_as_jax_does(tmp_path):
    """For any history (1-5 days of 1-8 rows), a snapshot covering any
    prefix of it written by either package, intact or corrupt: the port's
    load is the JAX package's and the plain per-day load."""
    from itertools import count

    from hypothesis import given, settings
    from hypothesis import strategies as st

    roots = count()

    @settings(max_examples=20, deadline=None)
    @given(days=st.integers(1, 5), covered=st.integers(0, 5), rows=st.integers(1, 8),
           corrupt=st.booleans(), writer=st.sampled_from(sorted(WRITERS)))
    def check(days, covered, rows, corrupt, writer):
        root = tmp_path / str(next(roots))
        store = FilesystemStore(root)
        covered = min(covered, days)
        seed_days(store, days=covered, rows=rows, seed=days * 10 + rows)
        if covered:
            WRITERS[writer](root)
        seed_days(store, days=days - covered, rows=rows, seed=99,
                  start=START + timedelta(days=covered))
        if corrupt:
            for key in store.list_keys(SNAPSHOTS_PREFIX):
                store.put_bytes(key, b"junk")
        got = load_all_datasets(CountingStore(FilesystemStore(root)))
        assert_same(got, jax_load_all(JaxStore(root)))
        drop_snapshots(root)
        assert_same(got, load_all_datasets(FilesystemStore(root)))

    check()


def test_port_reads_the_jax_snapshot_as_a_hit(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=8)
    jax_snapshot.write_snapshot(JaxStore(tmp_path))
    cold = CountingStore(FilesystemStore(tmp_path))
    ds = load_all_datasets(cold)
    assert cold.ops["get_bytes"] == 1 and cold.gets(SNAPSHOTS_PREFIX) == 1
    assert_same(ds, jax_load_all(JaxStore(tmp_path)))


def test_jax_reads_the_port_snapshot_as_a_hit(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=8)
    snapshot_mod.write_snapshot(FilesystemStore(tmp_path))
    cold = make_jax_counting_store(JaxStore(tmp_path))
    ds = jax_load_all(cold)
    assert cold.ops["get_bytes"] == 1
    assert cold.by_key[("get_bytes", snapshot_mod.snapshot_key(START + timedelta(days=7)))] == 1
    assert_same(load_all_datasets(FilesystemStore(tmp_path)), ds)


def test_snapshot_manifest_is_the_jax_manifest(tmp_path):
    """The same store consolidated by each package: equal arrays and an
    equal manifest (the npz container's own timestamps differ)."""
    seed_days(FilesystemStore(tmp_path / "a"), days=4)
    seed_days(FilesystemStore(tmp_path / "b"), days=4)
    ours = snapshot_mod.load_latest_snapshot(
        FilesystemStore(tmp_path / "a"),
        hist=[(snapshot_mod.write_snapshot(FilesystemStore(tmp_path / "a")), None)])
    key = jax_snapshot.write_snapshot(JaxStore(tmp_path / "b"))
    theirs = jax_snapshot.load_latest_snapshot(JaxStore(tmp_path / "b"), record_outcome=False)
    assert ours.key == key
    assert ours.X.tobytes() == theirs.X.tobytes() and ours.y.tobytes() == theirs.y.tobytes()
    assert [(e["key"], e["rows"]) for e in ours.entries] == \
        [(e["key"], e["rows"]) for e in theirs.entries]
    assert snapshot_mod.SNAPSHOT_SCHEMA == jax_snapshot.SNAPSHOT_SCHEMA
    assert snapshot_mod.SNAPSHOT_KEEP == jax_snapshot.SNAPSHOT_KEEP


@pytest.mark.parametrize("token", [(1, 2, 3), 7, "etag", None, object()])
def test_canon_token_is_the_jax_canon_token(token):
    assert snapshot_mod.canon_token(token) == jax_snapshot.canon_token(token)


# -- store-read budgets ----------------------------------------------------------

def test_cold_load_without_snapshot_pays_a_read_a_day(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=5)
    cold = CountingStore(FilesystemStore(tmp_path))
    load_all_datasets(cold)
    assert cold.ops["get_bytes"] == 5 and cold.gets("datasets/") == 5


def test_cold_load_with_snapshot_reads_it_once(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=8)
    snapshot_mod.write_snapshot(FilesystemStore(tmp_path))
    cold = CountingStore(FilesystemStore(tmp_path))
    ds = load_all_datasets(cold)
    assert cold.ops["get_bytes"] == 1 and cold.gets(SNAPSHOTS_PREFIX) == 1
    assert cold.gets("datasets/") == 0
    # the metadata plane stays O(1): two listings, one batched token call
    assert cold.by_key[("list_keys", "datasets/")] == 1
    assert cold.by_key[("list_keys", SNAPSHOTS_PREFIX)] == 1
    assert cold.ops["version_tokens"] == 1 and "version_token" not in cold.ops
    assert len(ds) == 8 * 20


def test_stale_snapshot_reads_it_and_the_tail_only(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=6)
    snapshot_mod.write_snapshot(FilesystemStore(tmp_path))
    seed_days(FilesystemStore(tmp_path), days=2, seed=9, start=START + timedelta(days=6))
    cold = CountingStore(FilesystemStore(tmp_path))
    ds = load_all_datasets(cold)
    assert cold.ops["get_bytes"] == 3 and cold.gets(SNAPSHOTS_PREFIX) == 1
    fetched = {key for (op, key) in cold.by_key
               if op == "get_bytes" and key.startswith("datasets/")}
    assert fetched == {dataset_key(START + timedelta(days=6 + i)) for i in range(2)}
    assert len(ds) == 8 * 20


def test_warm_reload_reads_nothing(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=4)
    warm = CountingStore(FilesystemStore(tmp_path))
    first = load_all_datasets(warm)
    warm.reset_counts()
    second = load_all_datasets(warm)
    assert warm.ops.get("get_bytes", 0) == 0
    assert warm.by_key[("list_keys", "datasets/")] == 1 and warm.ops["version_tokens"] == 1
    assert_same(first, second)


def test_warm_loop_never_rereads_the_snapshot_for_a_pure_tail(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=3)
    snapshot_mod.write_snapshot(FilesystemStore(tmp_path))
    warm = CountingStore(FilesystemStore(tmp_path))
    load_all_datasets(warm)
    seed_days(FilesystemStore(tmp_path), days=1, seed=4, start=START + timedelta(days=3))
    warm.reset_counts()
    load_all_datasets(warm)
    assert warm.gets(SNAPSHOTS_PREFIX) == 0 and warm.gets("datasets/") == 1


def test_fully_warm_reload_skips_the_concatenation(tmp_path, monkeypatch):
    import bodywork_tpu_torch.data.io as dio

    seed_days(FilesystemStore(tmp_path), days=3)
    store = FilesystemStore(tmp_path)
    first = load_all_datasets(store)
    monkeypatch.setattr(dio, "load_history_parts",
                        lambda *a, **k: pytest.fail("parts re-loaded"))
    second = dio.load_all_datasets(store)
    assert second.X is first.X and second.y is first.y


def test_concat_cache_invalidates_on_a_token_change(tmp_path):
    store = FilesystemStore(tmp_path)
    seed_days(store, days=2)
    assert len(load_all_datasets(store)) == 40
    X = np.full(7, 5.0, np.float32)
    persist_dataset(store, Dataset(X, 2 * X, START))
    after = load_all_datasets(store)
    assert len(after) == 7 + 20
    assert_same(after, jax_load_all(JaxStore(tmp_path)))


def test_epoch_wrapper_shares_the_caches_and_batched_reads(tmp_path):
    """A per-attempt write fence must not hide the long-lived store's
    caches: a load through it warms the caches the next attempt reads."""
    from bodywork_tpu_torch.store.epoch import EpochGuardedStore

    seed_days(FilesystemStore(tmp_path), days=3)
    counting = CountingStore(FilesystemStore(tmp_path))
    load_all_datasets(EpochGuardedStore(counting))
    counting.reset_counts()
    load_all_datasets(EpochGuardedStore(counting))
    assert counting.ops.get("get_bytes", 0) == 0 and counting.ops["version_tokens"] == 1


def test_corrupt_newest_falls_back_to_the_older_kept_snapshot(tmp_path):
    store = FilesystemStore(tmp_path)
    seed_days(store, days=3)
    snapshot_mod.write_snapshot(store)
    seed_days(store, days=1, seed=8, start=START + timedelta(days=3))
    snapshot_mod.write_snapshot(store)
    snaps = store.history(SNAPSHOTS_PREFIX)
    assert len(snaps) == 2
    store.put_bytes(snaps[-1][0], b"torn")
    cold = CountingStore(FilesystemStore(tmp_path))
    ds = load_all_datasets(cold)
    assert cold.gets(SNAPSHOTS_PREFIX) == 2 and cold.gets("datasets/") == 1
    assert len(ds) == 4 * 20
    assert snapshot_mod.refresh_due(cold)  # flagged for repair
    snapshot_mod.write_snapshot(cold)
    assert not snapshot_mod.refresh_due(cold)


# -- the snapshot's lifecycle ----------------------------------------------------

def test_write_snapshot_prunes_past_keep(tmp_path):
    store = FilesystemStore(tmp_path)
    for i in range(4):
        seed_days(store, days=1, seed=i, start=START + timedelta(days=i))
        snapshot_mod.write_snapshot(store)
    snaps = store.history(SNAPSHOTS_PREFIX)
    assert len(snaps) == snapshot_mod.SNAPSHOT_KEEP
    assert snaps[-1][1] == START + timedelta(days=3)


def test_write_snapshot_on_an_empty_store_writes_nothing(tmp_path):
    assert snapshot_mod.write_snapshot(FilesystemStore(tmp_path)) is None


def test_refresh_due(tmp_path):
    store = FilesystemStore(tmp_path)
    assert not snapshot_mod.refresh_due(store)
    seed_days(store, days=2)
    assert snapshot_mod.refresh_due(store)
    snapshot_mod.write_snapshot(store)
    assert not snapshot_mod.refresh_due(store)
    seed_days(store, days=1, seed=5, start=START + timedelta(days=2))
    assert snapshot_mod.refresh_due(store)


def test_refresh_due_sees_an_overwritten_covered_day(tmp_path):
    store = FilesystemStore(tmp_path)
    seed_days(store, days=3)
    snapshot_mod.write_snapshot(store)
    X = np.full(6, 2.0, np.float32)
    persist_dataset(store, Dataset(X, 5 * X, START))
    assert not snapshot_mod.refresh_due(store)  # the date check cannot see it
    load_all_datasets(store)  # the loader meets the mismatch and flags it
    assert snapshot_mod.refresh_due(store)
    snapshot_mod.write_snapshot(store)
    assert not snapshot_mod.refresh_due(store)


def test_plan_compaction_is_the_jax_plan(tmp_path):
    seed_days(FilesystemStore(tmp_path), days=3, rows=10)
    snapshot_mod.write_snapshot(FilesystemStore(tmp_path))
    seed_days(FilesystemStore(tmp_path), days=1, seed=3, start=START + timedelta(days=3))
    plan = snapshot_mod.plan_compaction(FilesystemStore(tmp_path))
    assert plan == jax_snapshot.plan_compaction(JaxStore(tmp_path))
    assert plan["rows"] == 3 * 10 + 20 and plan["days"] == 4


def test_plan_compaction_applies_the_token_filter(tmp_path):
    class NoTokens(FilesystemStore):
        def version_token(self, key):
            return None

    store = NoTokens(tmp_path)
    X = np.arange(5, dtype=np.float32)
    persist_dataset(store, Dataset(X, 2 * X, START))
    plan = snapshot_mod.plan_compaction(store)
    assert plan["days"] == 1 and plan["days_without_tokens"] == 1
    assert plan["would_write"] is None and plan["rows"] == 0
    counting = CountingStore(store)
    assert snapshot_mod.write_snapshot(counting) is None
    assert counting.ops.get("get_bytes", 0) == 0


def test_incremental_tail_reads_ride_the_snapshot(tmp_path):
    """The incremental fold reads its tail days through the history
    loader, so a cold fold over a snapshotted store fetches no CSV."""
    from bodywork_tpu_torch.train.incremental import _load_parts

    seed_days(FilesystemStore(tmp_path), days=9)
    snapshot_mod.write_snapshot(FilesystemStore(tmp_path))
    cold = CountingStore(FilesystemStore(tmp_path))
    keys = [dataset_key(START + timedelta(days=i)) for i in range(2, 9)]
    parts = _load_parts(cold, keys)
    assert list(parts) == keys and cold.gets("datasets/") == 0
    assert cold.gets(SNAPSHOTS_PREFIX) == 1


# -- the runner and the command line ---------------------------------------------

def test_one_day_simulation_leaves_a_snapshot_of_the_latest_day(tmp_path):
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline

    store = FilesystemStore(tmp_path)
    LocalRunner(default_pipeline(), store, device="cpu").run_simulation(date(2026, 1, 1), 1)
    snaps = store.history(SNAPSHOTS_PREFIX)
    assert snaps and snaps[-1][1] == store.latest("datasets/")[1]


def test_runner_refreshes_the_snapshot_in_the_background(tmp_path):
    from bodywork_tpu_torch.pipeline import LocalRunner, default_pipeline

    store = FilesystemStore(tmp_path)
    runner = LocalRunner(default_pipeline(), store, device="cpu")
    d = date(2026, 1, 1)
    runner.bootstrap(d)
    runner.run_day(d)
    runner._compact_thread.join(timeout=30)
    assert not runner._compact_thread.is_alive()
    snaps = store.history(SNAPSHOTS_PREFIX)
    assert snaps and snaps[-1][1] == store.latest("datasets/")[1]


def test_cli_compact_dry_run_then_write(tmp_path, capsys):
    root = str(tmp_path / "artefacts")
    seed_days(FilesystemStore(root), days=3, rows=10)
    assert cli.main(["compact", "--store", root, "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "3 day(s)" in out and "30 rows" in out and "dry-run: would write" in out
    assert FilesystemStore(root).list_keys(SNAPSHOTS_PREFIX) == []  # wrote nothing
    assert cli.main(["compact", "--store", root, "--keep", "1"]) == 0
    key = capsys.readouterr().out.strip().splitlines()[-1]
    assert key.startswith(SNAPSHOTS_PREFIX) and FilesystemStore(root).exists(key)
    # the JAX package reads it as a hit
    cold = make_jax_counting_store(JaxStore(root))
    jax_load_all(cold)
    assert cold.ops["get_bytes"] == 1
    empty = str(tmp_path / "empty")
    assert cli.main(["compact", "--store", empty, "--dry-run"]) == 0
    assert "no datasets" in capsys.readouterr().out
