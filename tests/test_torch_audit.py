"""The port's audit subsystem against the JAX package's: the write-time
digest sidecars, ``AuditedStore``'s write order, ``run_fsck`` and its
repairs on the same stores and the same seeded damage, the CLI's exit
codes, and the store a ``run-sim`` of each package leaves."""
import json
import shutil
import subprocess
import sys
from datetime import date
from pathlib import Path

import numpy as np
import pytest
import torch

from bodywork_tpu.audit import manifest as jax_manifest
from bodywork_tpu.audit.fsck import run_fsck as jax_run_fsck
from bodywork_tpu.chaos.bitrot import inject_bit_rot as jax_inject_bit_rot
from bodywork_tpu.chaos.plan import FaultPlan as JaxFaultPlan
from bodywork_tpu.data.generator import generate_day as jax_generate_day
from bodywork_tpu.store.base import DelegatingStore as JaxDelegatingStore
from bodywork_tpu.store.filesystem import FilesystemStore as JaxStore
from bodywork_tpu_torch import cli
from bodywork_tpu_torch.audit import CHECKERS, AuditedStore, manifest, run_fsck
from bodywork_tpu_torch.audit.fsck import _trainstate_payload_digest
from bodywork_tpu_torch.chaos.bitrot import inject_bit_rot
from bodywork_tpu_torch.chaos.plan import FaultPlan
from bodywork_tpu_torch.data import generator
from bodywork_tpu_torch.store import FilesystemStore, open_store
from bodywork_tpu_torch.store.base import DelegatingStore
from bodywork_tpu_torch.store.schema import ALL_PREFIXES, audit_digest_key

ROOT = Path(__file__).resolve().parents[1]
START = date(2026, 1, 1)

torch.set_num_threads(1)


@pytest.fixture
def jax_days(monkeypatch):
    """The port's days are the JAX generator's (the port's generator
    draws other float32 roundings), so the two packages' datasets, and
    their sidecars, are the same bytes."""
    def day(d, cfg=None, device=None):
        X, y = jax_generate_day(d) if cfg is None else jax_generate_day(d, cfg)
        return np.asarray(X), np.asarray(y)

    monkeypatch.setattr(generator, "generate_day", day)


# -- the sidecar documents ----------------------------------------------------

_CLASSES = {
    "dataset": ("datasets/regression-dataset-2026-01-01.csv", b"date,y,X\n2026-01-01,1.5,2.5\n"),
    "checkpoint": ("models/regressor-2026-01-01.npz", bytes(range(256)) * 40),
    "model-metrics": ("model-metrics/regressor-2026-01-01.csv", b"date,MAPE\n2026-01-01,0.5\n"),
    "test-metrics": ("test-metrics/regressor-test-results-2026-01-02.csv", b"a,b\n1,2\n"),
    "snapshot": ("snapshots/history-snapshot-2026-01-02.npz", b"PK\x03\x04" + b"\x00" * 99),
    "registry-record": ("registry/records/regressor-2026-01-01.json", b'{"schema": "x"}'),
    "alias-document": ("registry/aliases.json", b'{"production": null}'),
    "flight-record": ("obs/flightrec/flight-000000-abort-0123456789abcdef.json", b"{}"),
    "tuned-config": ("tuning/tuned-config-2026-01-01.json", b'{"knobs": {}}'),
    "config-log": ("tuning/config-log.json", b'{"history": []}'),
}


@pytest.mark.parametrize("cls", sorted(_CLASSES))
def test_sidecar_bytes_equal_jaxs_for_each_class(cls, tmp_path):
    key, data = _CLASSES[cls]
    port, ref = FilesystemStore(tmp_path / "port"), JaxStore(tmp_path / "jax")
    assert manifest.write_sidecar(port, key, data) == jax_manifest.write_sidecar(ref, key, data)
    sidecar = audit_digest_key(key)
    assert port.get_bytes(sidecar) == ref.get_bytes(sidecar)
    doc, status = manifest.read_sidecar(port, key)
    assert status == "ok" and doc == jax_manifest.read_sidecar(ref, key)[0]
    assert manifest.replica_bytes(doc) == jax_manifest.replica_bytes(doc)
    assert (manifest.replica_bytes(doc) == data) == key.startswith(manifest.REPLICA_PREFIXES)


def test_the_manifest_tables_are_jaxs():
    for name in ("DIGEST_SCHEMA", "PUT_SIDECAR_PREFIXES", "CAS_SIDECAR_PREFIXES",
                 "REPLICA_PREFIXES", "_ZLIB_LEVEL"):
        assert getattr(manifest, name) == getattr(jax_manifest, name), name


def test_a_lying_replica_is_never_returned():
    key, data = _CLASSES["checkpoint"]
    doc = manifest.sidecar_doc(key, data)
    doc["sha256"] = manifest.artefact_sha256(b"other bytes")
    assert manifest.replica_bytes(doc) is None


# -- AuditedStore's write order -----------------------------------------------

def _recording(base):
    class Recording(base):
        def __init__(self, inner):
            super().__init__(inner)
            self.ops = []

        def put_bytes(self, key, data):
            self.ops.append(("put_bytes", key))
            super().put_bytes(key, data)

        def put_bytes_if_match(self, key, data, expected_token=None):
            self.ops.append(("put_bytes_if_match", key))
            return super().put_bytes_if_match(key, data, expected_token)

        def delete(self, key):
            self.ops.append(("delete", key))
            super().delete(key)

    return Recording


def _write_order(audited_cls, recording_base, backend):
    inner = _recording(recording_base)(backend)
    store = audited_cls(inner)
    store.put_bytes("models/regressor-2026-01-01.npz", b"ckpt")
    store.put_bytes("runs/2026-01-01/notes.txt", b"no sidecar")
    token = store.put_bytes_if_match("registry/aliases.json", b"v1", None)
    store.put_bytes_if_match("registry/aliases.json", b"v2", token)
    store.put_bytes_if_match("runs/2026-01-01/journal.json", b"{}", None)
    store.delete("models/regressor-2026-01-01.npz")
    store.delete("runs/2026-01-01/notes.txt")
    return inner.ops, backend.list_keys()


def test_audited_store_write_cas_and_delete_order_equal_jaxs(tmp_path):
    """The primary lands before its sidecar (a crash between them leaves
    a missing or stale sidecar, never one describing unwritten bytes);
    a registry CAS writes its sidecar after the CAS, a journal CAS none;
    a delete removes the sidecar after the primary."""
    from bodywork_tpu.audit.manifest import AuditedStore as JaxAuditedStore

    ops, keys = _write_order(AuditedStore, DelegatingStore, FilesystemStore(tmp_path / "p"))
    assert (ops, keys) == _write_order(JaxAuditedStore, JaxDelegatingStore,
                                       JaxStore(tmp_path / "j"))
    assert ops[:2] == [("put_bytes", "models/regressor-2026-01-01.npz"),
                       ("put_bytes", audit_digest_key("models/regressor-2026-01-01.npz"))]
    assert ops[-3:] == [("delete", "models/regressor-2026-01-01.npz"),
                        ("delete", audit_digest_key("models/regressor-2026-01-01.npz")),
                        ("delete", "runs/2026-01-01/notes.txt")]
    assert keys == ["audit/digests/registry/aliases.json.json", "registry/aliases.json",
                    "runs/2026-01-01/journal.json"]


def test_open_store_wraps_the_backend_outermost(tmp_path):
    store = open_store(str(tmp_path / "s"))
    assert isinstance(store, AuditedStore) and isinstance(store.inner, FilesystemStore)
    assert isinstance(open_store(f"file://{tmp_path / 'f'}").inner, FilesystemStore)
    assert open_store(store) is store


# -- fsck: the checkers, the report, the damage and the repairs ---------------

def test_the_checkers_cover_exactly_the_schemas_prefixes():
    from bodywork_tpu.audit.fsck import CHECKERS as JAX_CHECKERS

    assert tuple(CHECKERS) == ALL_PREFIXES == tuple(JAX_CHECKERS)


def test_the_trainstate_digest_mirror_equals_the_trainers():
    from bodywork_tpu_torch.train.incremental import _payload_digest

    doc = {"model_type": "linear", "feature_dim": 1, "split": [0.8, 0.2],
           "cum_g": [[1.0, 2.0], [2.0, 5.0]], "cum_c": [3.0, 4.0],
           "days": {"2026-01-01": 12}}
    assert _trainstate_payload_digest(doc) == _payload_digest(doc)


@pytest.fixture(scope="module")
def sim_store(tmp_path_factory):
    """A 3-day linear simulation written by the port through its CLI (an
    audited store), with a final compaction as the bit-rot soak has."""
    root = tmp_path_factory.mktemp("audit") / "sim"
    assert cli.main(["run-sim", "--store", str(root), "--days", "3", "--date", str(START),
                     "--model", "linear", "--samples-per-day", "96", "--device", "cpu"]) == 0
    from bodywork_tpu_torch.data.snapshot import write_snapshot

    write_snapshot(open_store(str(root)))
    return root


def test_fsck_reports_equal_jaxs_on_a_clean_store(sim_store):
    port = run_fsck(AuditedStore(FilesystemStore(sim_store)))
    from bodywork_tpu.audit.manifest import AuditedStore as JaxAuditedStore

    assert port == jax_run_fsck(JaxAuditedStore(JaxStore(sim_store)))
    assert port["clean"] and port["ok"] and port["schema"] == "bodywork_tpu.fsck_report/1"
    assert port["prefixes"]["audit/"]["keys"] > 0


def test_fsck_recurses_into_tenant_namespaces_as_jaxs(tmp_path):
    """A tenant's subtree is scanned with the same checkers (its findings
    resurfacing under tenant-qualified keys, never repaired from the
    root), and a subtree no tenant id names is flagged."""
    from bodywork_tpu.audit.manifest import AuditedStore as JaxAuditedStore
    from bodywork_tpu_torch.tenancy import TenantStore, list_tenants

    backend = FilesystemStore(tmp_path)
    tenant = AuditedStore(TenantStore(backend, "acme"))
    tenant.put_bytes("models/regressor-2026-01-01.npz", b"ckpt")
    backend.put_bytes("tenants/acme/models/regressor-2026-01-01.npz", b"rot!")
    backend.put_bytes("tenants/BAD/x", b"1")
    assert list_tenants(backend) == ["acme"]
    report = run_fsck(AuditedStore(backend), repair=True)
    assert report == jax_run_fsck(JaxAuditedStore(JaxStore(tmp_path)), repair=True)
    assert [(f["key"], f["problem"], f["repair"]) for f in report["findings"]] == [
        ("tenants/acme/models/regressor-2026-01-01.npz", "digest_mismatch", None),
        ("tenants/BAD/x", "invalid_tenant_id", None)]
    assert not report["ok"] and report["repairs"] == []


def _tree(root: Path) -> dict[str, bytes]:
    """Every file of a store but the snapshots and their sidecars, whose
    bytes embed the backend's version tokens (file times)."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and not p.name.startswith(".tmp-")
            and not str(p.relative_to(root)).startswith(("snapshots/",
                                                          "audit/digests/snapshots/"))}


@pytest.mark.parametrize("seed", [3, 11])
def test_the_same_seeded_damage_fsck_and_repair_equal_jaxs(sim_store, tmp_path, seed):
    from bodywork_tpu.audit.manifest import AuditedStore as JaxAuditedStore

    port_root = Path(shutil.copytree(sim_store, tmp_path / "port"))
    jax_root = Path(shutil.copytree(sim_store, tmp_path / "jax"))
    injected = inject_bit_rot(FilesystemStore(port_root), FaultPlan(seed=seed, bit_rot_p=0.25))
    assert injected == jax_inject_bit_rot(JaxStore(jax_root),
                                          JaxFaultPlan(seed=seed, bit_rot_p=0.25))
    assert len({e["prefix"] for e in injected}) >= 6
    assert _tree(port_root) == _tree(jax_root)  # the same bytes flipped

    port_store = AuditedStore(FilesystemStore(port_root))
    jax_store = JaxAuditedStore(JaxStore(jax_root))
    detected = run_fsck(port_store)
    assert detected == jax_run_fsck(jax_store)
    flagged = {f["key"] for f in detected["findings"] if f["severity"] != "advisory"}
    assert {e["key"] for e in injected} <= flagged

    repaired = run_fsck(port_store, repair=True)
    assert repaired == jax_run_fsck(jax_store, repair=True)
    assert repaired["ok"] and repaired["repairs"]
    assert _tree(port_root) == _tree(jax_root)
    assert run_fsck(port_store)["ok"] and jax_run_fsck(jax_store)["ok"]


def test_a_rotted_checkpoint_restores_from_its_replica(sim_store, tmp_path):
    root = Path(shutil.copytree(sim_store, tmp_path / "s"))
    key = "models/regressor-2026-01-02.npz"
    good = (root / key).read_bytes()
    (root / key).write_bytes(good[:100] + bytes([good[100] ^ 0xFF]) + good[101:])
    report = run_fsck(AuditedStore(FilesystemStore(root)), repair=True)
    assert [(f["key"], f["severity"], f["repair"]) for f in report["findings"]] == [
        (key, "restorable", "restore_replica")]
    assert (root / key).read_bytes() == good
    assert (root / f"quarantine/{key}").read_bytes() != good


# -- the CLI --------------------------------------------------------------------

def test_cli_fsck_exit_codes(sim_store, tmp_path, capsys):
    root = Path(shutil.copytree(sim_store, tmp_path / "s"))
    assert cli.main(["fsck", "--store", str(root)]) == 0
    assert "clean" in capsys.readouterr().out
    metrics = root / "model-metrics/regressor-2026-01-01.csv"
    data = bytearray(metrics.read_bytes())
    data[-3] ^= 0x01
    metrics.write_bytes(bytes(data))
    assert cli.main(["fsck", "--store", str(root), "--json"]) == cli.FSCK_FINDINGS_EXIT == 7
    report = json.loads(capsys.readouterr().out)
    assert [f["problem"] for f in report["residual"]] == ["digest_mismatch"]
    assert cli.main(["fsck", "--store", str(root), "--repair"]) == 0
    out = capsys.readouterr().out
    assert "repair restore_replica model-metrics/regressor-2026-01-01.csv: repaired" in out
    assert cli.main(["fsck", "--store", str(root)]) == 0


def test_run_day_scrub_puts_the_fsck_block_in_the_day_report(tmp_path, capsys):
    root = tmp_path / "s"
    report = tmp_path / "day.report.json"
    assert cli.main(["run-day", "--store", str(root), "--date", str(START), "--device", "cpu",
                     "--scrub", "--report-out", str(report)]) == 0
    assert "fsck: clean" in capsys.readouterr().out
    doc = json.loads(report.read_text())
    assert doc["fsck"] == {"clean": True, "ok": True, "keys_scanned": doc["fsck"]["keys_scanned"],
                           "by_severity": {}, "findings": []}
    assert doc["fsck"]["keys_scanned"] > 0


def test_run_day_scrub_waits_for_the_days_snapshot_compactor(tmp_path, monkeypatch):
    """The scrub lists the store only once the day's background compactor
    has written its snapshot and sidecar: listing midway finds the
    sidecar's primary missing (an ``orphan_sidecar``)."""
    import threading
    import time

    from bodywork_tpu_torch import audit
    from bodywork_tpu_torch.data import snapshot

    real_write, real_fsck = snapshot.write_snapshot, audit.run_fsck
    written, scrubbed = [], []

    def slow_write(store, *args, **kwargs):
        time.sleep(0.5)
        key = real_write(store, *args, **kwargs)
        written.append((time.perf_counter(), threading.current_thread().name))
        return key

    def fsck(store, repair=False):
        scrubbed.append(time.perf_counter())
        return real_fsck(store, repair=repair)

    monkeypatch.setattr(snapshot, "write_snapshot", slow_write)
    monkeypatch.setattr(audit, "run_fsck", fsck)
    root = tmp_path / "s"
    for day in (START, date(2026, 1, 2)):
        assert cli.main(["run-day", "--store", str(root), "--date", str(day),
                         "--device", "cpu", "--scrub"]) == 0
    assert written and any(name == "snapshot-compactor" for _t, name in written)
    assert all(t_scrub > max(t for t, _n in written) for t_scrub in scrubbed[-1:])
    assert run_fsck(AuditedStore(FilesystemStore(root)))["clean"]


def test_importing_the_audit_package_loads_neither_torch_nor_jax():
    """fsck runs on plain CPU pods: the audit package, the store and the
    fsck command's module load no accelerator runtime."""
    probe = ("import sys; import bodywork_tpu_torch.audit, bodywork_tpu_torch.store; "
             "from bodywork_tpu_torch.audit import fsck, repair, manifest; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'jaxlib', 'bodywork_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


# -- the store a run-sim of each package leaves -----------------------------------

def test_run_sim_of_each_package_leaves_the_same_keys_and_sidecars(tmp_path, jax_days):
    """The same 2 linear days through each package's ``cli run-sim``: the
    same set of keys (14 of them ``audit/digests/`` documents); every
    sidecar is the JAX package's sidecar of its own store's primary, and
    byte-equal across the stores wherever the primaries are (the datasets
    and the alias document; a checkpoint, its metrics and its record
    differ in the fit's last float32 bits: tests/test_torch_pipeline.py);
    each package's fsck reports the other's store clean."""
    from bodywork_tpu import cli as jax_cli
    from bodywork_tpu.audit.manifest import AuditedStore as JaxAuditedStore
    from bodywork_tpu.chaos.sim import _COMPARE_EXCLUDED

    args = ["--days", "2", "--date", str(START), "--model", "linear"]
    assert jax_cli.main(["run-sim", "--store", str(tmp_path / "jax"), *args]) == 0
    assert cli.main(["run-sim", "--store", str(tmp_path / "port"), *args,
                     "--device", "cpu"]) == 0
    port, ref = FilesystemStore(tmp_path / "port"), FilesystemStore(tmp_path / "jax")
    keys = port.list_keys()
    assert keys == ref.list_keys()
    sidecars = [k for k in keys if k.startswith("audit/digests/")]
    assert len(sidecars) == 14
    same = []
    for sidecar in sidecars:
        primary = sidecar[len("audit/digests/"):-len(".json")]
        for store in (port, ref):
            want = json.dumps(jax_manifest.sidecar_doc(primary, store.get_bytes(primary)),
                              sort_keys=True, indent=1).encode()
            assert store.get_bytes(sidecar) == want, sidecar
        if port.get_bytes(primary) == ref.get_bytes(primary):
            assert port.get_bytes(sidecar) == ref.get_bytes(sidecar)
            same.append(primary)
    assert {k for k in same if not k.startswith(_COMPARE_EXCLUDED)} >= {
        "registry/aliases.json", "datasets/regression-dataset-2026-01-01.csv",
        "datasets/regression-dataset-2026-01-02.csv", "datasets/regression-dataset-2026-01-03.csv"}
    for root in (tmp_path / "port", tmp_path / "jax"):
        jax_report = jax_run_fsck(JaxAuditedStore(JaxStore(root)))
        port_report = run_fsck(AuditedStore(FilesystemStore(root)))
        assert jax_report["clean"] and not jax_report["findings"], jax_report["findings"]
        assert port_report["clean"] and not port_report["findings"], port_report["findings"]
