"""Filesystem artefact-store backend (the port's copy of
``bodywork_tpu.store.filesystem``, without the compare-and-swap path).

Keys map to paths under a root directory; writes are atomic (tmp file +
fsync + rename + directory fsync) so a concurrently-reading service never
sees a torn artefact. Temporary and lock files start with ``.tmp-`` and
never show in a listing — the same convention as the JAX backend, so the
two packages share one store directory.
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

from bodywork_tpu_torch.store.base import ArtefactNotFound, ArtefactStore


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


class FilesystemStore(ArtefactStore):
    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        return self.root / self.validate_key(key)

    def put_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
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

    def get_bytes(self, key: str) -> bytes:
        try:
            return self._path(key).read_bytes()
        except FileNotFoundError:
            raise ArtefactNotFound(key) from None

    def exists(self, key: str) -> bool:
        return self._path(key).is_file()

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
