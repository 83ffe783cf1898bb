"""Object store layer — where checkpoint SSTs live (port of
risingwave_tpu/state/object_store.py).

`ObjectStore` is the upload / read / delete / list interface. The
durable backend is the local filesystem (atomic tmp + fsync + rename
uploads); an in-memory backend backs unit tests of the LSM layer.

Left out of this slice (ROADMAP A10): the bounded-retry wrapper
`ResilientObjectStore`, its fault hooks and metrics. A store error here
takes the fail-stop path directly.
"""

from __future__ import annotations

import os
import time


class ObjectStore:
    def upload(self, path: str, data: bytes) -> None:
        raise NotImplementedError

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str) -> list[str]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError


class InMemObjectStore(ObjectStore):
    """For tests of the layers above."""

    def __init__(self):
        self._objects: dict[str, bytes] = {}

    def upload(self, path: str, data: bytes) -> None:
        self._objects[path] = bytes(data)

    def read(self, path: str) -> bytes:
        return self._objects[path]

    def delete(self, path: str) -> None:
        self._objects.pop(path, None)

    def list(self, prefix: str) -> list[str]:
        return sorted(p for p in self._objects if p.startswith(prefix))

    def exists(self, path: str) -> bool:
        return path in self._objects


# a stranded `.tmp` (crash between write and rename) older than this is
# swept at open; the age guard keeps a concurrent opener from deleting a
# sibling's in-flight upload
TMP_SWEEP_AGE_S = 300.0


class LocalFsObjectStore(ObjectStore):
    """Durable local-directory backend. Uploads are atomic (write tmp,
    fsync, rename), so a crash mid-upload never leaves a torn object
    visible; open sweeps stale `.tmp` files a crash stranded."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        now = time.time()
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if not name.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, name)
                try:
                    if now - os.path.getmtime(p) >= TMP_SWEEP_AGE_S:
                        os.remove(p)
                except OSError:
                    pass          # raced another opener / live upload

    def _abs(self, path: str) -> str:
        root = os.path.normpath(self.root)
        p = os.path.normpath(os.path.join(root, path))
        # exact-prefix-with-separator check; raise, never assert
        if p != root and not p.startswith(root + os.sep):
            raise ValueError(f"object path escapes store root: {path!r}")
        return p

    def upload(self, path: str, data: bytes) -> None:
        dst = self._abs(path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)

    def read(self, path: str) -> bytes:
        with open(self._abs(path), "rb") as f:
            return f.read()

    def delete(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass

    def list(self, prefix: str) -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, name), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))
