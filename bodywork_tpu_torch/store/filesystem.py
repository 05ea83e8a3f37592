"""Filesystem artefact-store backend (the port's copy of
``bodywork_tpu.store.filesystem``).

Keys map to paths under a root directory; writes are atomic (tmp file +
fsync + rename + directory fsync) so a concurrently-reading service never
sees a torn artefact. Temporary and lock files start with ``.tmp-`` and
never show in a listing — the same convention as the JAX backend, so the
two packages share one store directory.

Compare-and-swap writes take an ``flock`` on the same persistent
``.tmp-lock.<name>`` sidecar file as the JAX backend and compare the same
``(st_ino, st_size, st_mtime_ns)`` version token, so a JAX writer and a
port writer of one store serialise on one lock.
"""
from __future__ import annotations

import fcntl
import os
import tempfile
from pathlib import Path

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore, CasConflict
from bodywork_tpu_torch.utils.retry import RetryPolicy, call_with_retry


def _fsync_dir(path: Path) -> None:
    """fsync a directory so a rename inside it survives power loss;
    filesystems that refuse ``os.open`` on directories degrade silently
    (the rename is still atomic)."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _check_token(key: str, current, expected) -> None:
    """Raise :class:`CasConflict` unless the key's ``current`` token is
    the ``expected`` one (None: the key must not exist)."""
    if expected is None:
        if current is not None:
            raise CasConflict(f"create-only write of {key!r} lost: key exists")
    elif current != expected:
        raise CasConflict(
            f"conditional write of {key!r} lost: token changed "
            f"({expected!r} -> {current!r})"
        )


class FilesystemStore(ArtefactStore):
    #: its operations count under ``bodywork_tpu_store_ops_total{backend=...}``
    backend_label = "filesystem"

    #: how long a CAS writer waits on a contended sidecar lock before it
    #: gives up with a conflict
    CAS_LOCK_TIMEOUT_S = 5.0

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / self.validate_key(key)

    def _write_atomic(self, path: Path, data: bytes) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            _fsync_dir(path.parent)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def put_bytes(self, key: str, data: bytes) -> None:
        self._write_atomic(self._path(key), data)

    def _acquire_cas_lock(self, key: str, lock_path: Path) -> int:
        """A bounded wait for the CAS sidecar lock: an exclusive ``flock``
        on the persistent ``.tmp-lock.<name>`` file, which is created once
        and never unlinked (unlinking would let two writers hold locks on
        different inodes). The kernel releases the lock when its holder's
        fd closes, a crash included, so no stale lock is ever broken; a
        holder slower than :data:`CAS_LOCK_TIMEOUT_S` makes contenders
        fail with a clean :class:`CasConflict`. An I/O error is no lost
        race and propagates as itself."""
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)

        def _try_lock():
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)  # BlockingIOError
            return fd

        try:
            return call_with_retry(
                _try_lock,
                RetryPolicy(attempts=4096, base_delay_s=0.002, max_delay_s=0.01,
                            deadline_s=self.CAS_LOCK_TIMEOUT_S),
                is_retryable=lambda exc: isinstance(exc, BlockingIOError),
            )
        except BlockingIOError:
            os.close(fd)
            raise CasConflict(
                f"CAS lock on {key!r} contended past {self.CAS_LOCK_TIMEOUT_S}s"
            ) from None
        except BaseException:
            os.close(fd)
            raise

    def put_bytes_if_match(self, key: str, data: bytes, expected_token=None):
        """CAS under the sidecar lock: the token check and the atomic write
        run while this writer holds the ``flock``, across threads and
        processes (and the JAX package's writers). Plain ``put_bytes``
        takes no lock, so a document written by CAS must only ever be
        written by CAS."""
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        lock_fd = self._acquire_cas_lock(key, path.parent / f".tmp-lock.{path.name}")
        try:
            _check_token(key, self.version_token(key), expected_token)
            self._write_atomic(path, data)
            return self.version_token(key)
        finally:
            os.close(lock_fd)  # releases the flock; the lock file stays

    def get_bytes(self, key: str) -> bytes:
        try:
            return self._path(key).read_bytes()
        except FileNotFoundError:
            raise ArtefactNotFound(key) from None

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

    def delete(self, key: str) -> None:
        try:
            self._path(key).unlink()
        except FileNotFoundError:
            raise ArtefactNotFound(key) from None

    def version_token(self, key: str):
        # every write is a tmp file renamed into place, a fresh inode, so
        # (ino, size, mtime_ns) changes on every overwrite even where the
        # mtime is coarse and the size equal
        try:
            st = self._path(key).stat()
        except (FileNotFoundError, ValueError):
            return None
        return (st.st_ino, st.st_size, st.st_mtime_ns)

    def list_keys(self, prefix: str = "") -> list[str]:
        # walk only the prefix's directory subtree (prefixes map to
        # directories), never the whole store root
        dir_part, _, _name_part = prefix.rpartition("/")
        base = self.root / dir_part if dir_part else self.root
        if not base.is_dir():
            return []
        keys = []
        for dirpath, _dirnames, filenames in os.walk(base):
            for name in filenames:
                if name.startswith(".tmp-"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                key = rel.replace(os.sep, "/")
                if key.startswith(prefix):
                    keys.append(key)
        return sorted(keys)

    def __repr__(self) -> str:
        return f"FilesystemStore(root={str(self.root)!r})"
