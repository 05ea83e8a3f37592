"""The port's ``GCSStore`` against the in-memory ``google.cloud.storage``
fake of ``tests/test_gcs.py`` (no live bucket): the same cases, on the
port's class, plus ``open_store("gs://...")`` and the lazy import."""
import subprocess
import sys
from pathlib import Path

import pytest

from bodywork_tpu_torch.store import ArtefactNotFound, CasConflict
from tests.helpers import FakeClient, ServiceUnavailable, install_fake_gcs

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def gcs_store(monkeypatch):
    install_fake_gcs(monkeypatch)
    from bodywork_tpu_torch.store.gcs import GCSStore

    return GCSStore.from_url("gs://test-bucket/exp1")


def test_from_url_parses_bucket_and_prefix(gcs_store):
    assert gcs_store._bucket.name == "test-bucket"
    assert gcs_store._prefix == "exp1"


def test_roundtrip_and_exists(gcs_store):
    assert not gcs_store.exists("models/regressor-2026-01-01.npz")
    gcs_store.put_bytes("models/regressor-2026-01-01.npz", b"abc")
    assert gcs_store.exists("models/regressor-2026-01-01.npz")
    assert gcs_store.get_bytes("models/regressor-2026-01-01.npz") == b"abc"
    assert "exp1/models/regressor-2026-01-01.npz" in gcs_store._bucket._objects


def test_get_missing_raises(gcs_store):
    with pytest.raises(ArtefactNotFound):
        gcs_store.get_bytes("models/nope.npz")
    with pytest.raises(ArtefactNotFound):
        gcs_store.delete("models/nope.npz")


def test_history_and_latest(gcs_store):
    for d in ("2026-01-02", "2026-01-01", "2026-01-03"):
        gcs_store.put_text(f"datasets/regression-dataset-{d}.csv", d)
    hist = gcs_store.history("datasets/")
    assert [str(d) for _, d in hist] == ["2026-01-01", "2026-01-02", "2026-01-03"]
    key, latest = gcs_store.latest("datasets/")
    assert str(latest) == "2026-01-03" and key.endswith("2026-01-03.csv")


def test_version_tokens_change_on_overwrite(gcs_store):
    key = "datasets/regression-dataset-2026-01-01.csv"
    gcs_store.put_text(key, "v1")
    t1 = gcs_store.version_token(key)
    assert gcs_store.version_tokens([key])[key] == t1
    gcs_store.put_text(key, "v2")
    assert gcs_store.version_token(key) != t1


def test_version_tokens_batched_multiple_dirs(gcs_store):
    keys = ["datasets/regression-dataset-2026-01-01.csv", "models/regressor-2026-01-01.npz"]
    for k in keys:
        gcs_store.put_text(k, "x")
    tokens = gcs_store.version_tokens(keys)
    assert set(tokens) == set(keys) and all(t is not None for t in tokens.values())


def test_invalid_keys_have_no_token(gcs_store):
    assert gcs_store.version_token("../escape") is None
    assert gcs_store.version_tokens(["../escape"]) == {}


def test_delete(gcs_store):
    gcs_store.put_text("models/regressor-2026-01-01.npz", "x")
    gcs_store.delete("models/regressor-2026-01-01.npz")
    assert not gcs_store.exists("models/regressor-2026-01-01.npz")


def test_list_keys_spans_multiple_pages(gcs_store, monkeypatch):
    monkeypatch.setattr(FakeClient, "page_size", 40)
    keys = [f"datasets/regression-dataset-2026-01-01.csv.part{i:04d}" for i in range(101)]
    for k in keys:
        gcs_store.put_text(k, "x")
    bucket = gcs_store._bucket
    bucket.page_fetches = 0
    assert gcs_store.list_keys("datasets/") == sorted(keys)
    assert bucket.page_fetches >= 3


def test_version_tokens_span_multiple_pages(gcs_store, monkeypatch):
    monkeypatch.setattr(FakeClient, "page_size", 16)
    keys = [f"models/regressor-2026-01-{d:02d}.npz" for d in range(1, 29)]
    for k in keys:
        gcs_store.put_text(k, "x")
    bucket = gcs_store._bucket
    bucket.page_fetches = 0
    assert set(gcs_store.version_tokens(keys)) == set(keys)
    assert bucket.page_fetches >= 2


def test_transient_listing_failure_is_retried(gcs_store):
    gcs_store.put_text("datasets/regression-dataset-2026-01-01.csv", "x")
    bucket = gcs_store._bucket
    bucket.inject_failures("list", 2)
    assert gcs_store.list_keys("datasets/") == ["datasets/regression-dataset-2026-01-01.csv"]
    assert bucket.failures["list"] == 0


def test_transient_download_and_exists_retry(gcs_store):
    key = "models/regressor-2026-01-01.npz"
    gcs_store.put_bytes(key, b"abc")
    gcs_store._bucket.inject_failures("download", 1)
    assert gcs_store.get_bytes(key) == b"abc"
    gcs_store._bucket.inject_failures("exists", 2)
    assert gcs_store.exists(key)


def test_delete_missing_key_under_transient_error_still_raises(gcs_store):
    gcs_store._bucket.inject_failures("exists", 1)
    with pytest.raises(ArtefactNotFound):
        gcs_store.delete("models/never-existed.npz")


def test_delete_lost_response_after_delete_rpc_is_success(gcs_store):
    key = "models/regressor-2026-01-01.npz"
    gcs_store.put_text(key, "x")
    gcs_store._bucket.inject_failures("delete_after_apply", 1)
    gcs_store.delete(key)
    assert not gcs_store.exists(key)


def test_persistent_transient_failure_raises_after_budget(gcs_store):
    gcs_store.put_text("datasets/regression-dataset-2026-01-01.csv", "x")
    gcs_store._bucket.inject_failures("list", gcs_store.RETRY_ATTEMPTS)
    with pytest.raises(ServiceUnavailable):
        gcs_store.list_keys("datasets/")


def test_non_transient_errors_are_not_retried(gcs_store):
    before = dict(gcs_store._bucket.failures)
    with pytest.raises(ArtefactNotFound):
        gcs_store.get_bytes("models/nope.npz")
    assert gcs_store._bucket.failures == before


def test_get_many_parallel_with_per_op_retry(gcs_store):
    keys = [f"datasets/regression-dataset-2026-01-0{i}.csv" for i in (1, 2, 3)]
    for i, key in enumerate(keys):
        gcs_store.put_bytes(key, bytes([i]) * 32)
    gcs_store._bucket.inject_failures("download", 2)
    out = gcs_store.get_many(keys)
    assert list(out) == keys
    assert all(out[k] == bytes([i]) * 32 for i, k in enumerate(keys))
    with pytest.raises(ArtefactNotFound):
        gcs_store.get_many([keys[0], "datasets/never.csv"])


def test_cas_own_committed_write_is_not_a_conflict(gcs_store):
    token = gcs_store.put_bytes_if_match("registry/aliases.json", b"v1", None)
    gcs_store._bucket.inject_failures("upload_after_apply", 1)
    new_token = gcs_store.put_bytes_if_match("registry/aliases.json", b"v2", token)
    assert new_token is not None and new_token != token
    assert gcs_store.get_bytes("registry/aliases.json") == b"v2"
    with pytest.raises(CasConflict):
        gcs_store.put_bytes_if_match("registry/aliases.json", b"v3", token)


def test_cas_own_write_post_check_survives_transient_verify_read(gcs_store):
    token = gcs_store.put_bytes_if_match("registry/aliases.json", b"v1", None)
    gcs_store._bucket.inject_failures("upload_after_apply", 1)
    gcs_store._bucket.inject_failures("download", 1)
    new_token = gcs_store.put_bytes_if_match("registry/aliases.json", b"v2", token)
    assert new_token is not None and new_token != token
    assert gcs_store.get_bytes("registry/aliases.json") == b"v2"


def test_resilient_store_over_gcs_adds_only_the_breaker(gcs_store):
    from bodywork_tpu_torch.store.resilient import ResilientStore
    from bodywork_tpu_torch.utils.retry import RetryPolicy

    store = ResilientStore(gcs_store)
    assert store._policy == RetryPolicy(attempts=1) and store._label == "gcs"


def test_open_store_opens_gcs_audited(monkeypatch):
    install_fake_gcs(monkeypatch)
    from bodywork_tpu_torch.audit import AuditedStore
    from bodywork_tpu_torch.store import open_store
    from bodywork_tpu_torch.store.gcs import GCSStore

    store = open_store("gs://test-bucket/exp2")
    assert isinstance(store, AuditedStore) and isinstance(store.inner, GCSStore)
    store.put_bytes("models/regressor-2026-01-01.npz", b"abc")
    assert store.list_keys() == ["audit/digests/models/regressor-2026-01-01.npz.json",
                                 "models/regressor-2026-01-01.npz"]


def test_the_gcs_module_imports_no_google_cloud_storage():
    """``google.cloud.storage`` is imported when a GCSStore is built, never
    with the module: the card's machine, which lacks it, imports the
    store package on every day loop. (The interpreter's site packages may
    pre-load the bare ``google`` namespace, which is not the client.)"""
    probe = ("import sys; import bodywork_tpu_torch.store.gcs, bodywork_tpu_torch.store; "
             "print(sorted(m for m in sys.modules if m.startswith('google.cloud.')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr
