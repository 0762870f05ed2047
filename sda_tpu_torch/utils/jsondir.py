"""Atomic JSON-per-object directory store (the part of
``sda_tpu/utils/jsondir.py`` the client keystore uses; its create-if-identical
half serves the file server store, which is not ported).

One ``<id>.json`` file per object with:
- atomic writes (tmp + ``os.replace``),
- private permissions (0700 dirs / 0600 files — these directories hold
  secret keys),
- a per-directory lock serialising writers.
"""

from __future__ import annotations

import json
import os
import threading

# Locks are keyed by absolute directory path, not by JsonDir instance:
# callers freely mint transient JsonDir objects for the same directory.
_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


def _lock_for(path: str) -> threading.RLock:
    with _LOCKS_GUARD:
        lock = _LOCKS.get(path)
        if lock is None:
            lock = _LOCKS[path] = threading.RLock()
        return lock


class JsonDir:
    def __init__(self, path):
        self.path = os.path.abspath(str(path))
        os.makedirs(self.path, mode=0o700, exist_ok=True)
        self._lock = _lock_for(self.path)

    def _file(self, id) -> str:
        name = str(id)
        if "/" in name or name.startswith("."):
            raise ValueError(f"bad id {name!r}")
        return os.path.join(self.path, name + ".json")

    def put(self, id, payload) -> None:
        target = self._file(id)
        tmp = target + ".tmp"
        with self._lock:
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, target)

    def get(self, id):
        # lock-free read: writes land via tmp + os.replace, so a reader
        # always opens either the complete old file or the complete new one
        try:
            with open(self._file(id)) as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        return json.loads(raw)

    def list_ids(self) -> list:
        with self._lock:
            return sorted(
                f[: -len(".json")] for f in os.listdir(self.path) if f.endswith(".json")
            )
