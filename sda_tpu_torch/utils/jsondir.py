"""Shared atomic JSON-per-object directory store (copy of
``sda_tpu/utils/jsondir.py``).

One ``<id>.json`` file per object with:
- atomic writes (tmp + ``os.replace``),
- private permissions (0700 dirs / 0600 files — these directories hold
  secret keys and auth tokens),
- a per-directory lock making ``create`` (get-then-put, idempotent when
  content is identical — the SDA server's jfs semantics,
  jfs_stores/mod.rs:79-89) safe under the threaded REST server.

Used by both the client keystore (``crypto/keystore.py``) and the server
file store (``server/filestore.py``); the layout is ``sda_tpu``'s, so a
directory written by either package opens in the other.
"""

from __future__ import annotations

import json
import os
import threading


class ConflictError(Exception):
    """create() saw an existing object with different content."""


# Locks are keyed by absolute directory path, not by JsonDir instance:
# callers freely mint transient JsonDir objects for the same directory
# (e.g. the server filestore's per-aggregation subdirs), and create()'s
# get-then-put must serialize across all of them.
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
        with self._lock:
            self._put_locked(id, payload)

    def _put_locked(self, id, payload) -> None:
        target = self._file(id)
        tmp = target + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, target)

    def get(self, id):
        # lock-free read: writes land via tmp + os.replace, so a reader
        # always opens either the complete old file or the complete new
        # one — never a partial write. Only the get-then-put paths
        # (create/create_once) need the directory lock; decoding JSON
        # outside any lock keeps concurrent readers from convoying.
        try:
            with open(self._file(id)) as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        return json.loads(raw)

    def create(self, id, payload) -> None:
        """create-if-identical: reposting identical content is a no-op,
        differing content raises ConflictError."""
        with self._lock:
            try:
                with open(self._file(id)) as f:
                    existing = json.load(f)
            except FileNotFoundError:
                existing = None
            if existing is not None and existing != payload:
                raise ConflictError(f"object already exists: {id}")
            self._put_locked(id, payload)

    def create_once(self, id, payload) -> bool:
        """Write only if absent; returns whether this call wrote it."""
        with self._lock:
            if os.path.exists(self._file(id)):
                return False
            self._put_locked(id, payload)
            return True

    def delete(self, id) -> None:
        with self._lock:
            try:
                os.remove(self._file(id))
            except FileNotFoundError:
                pass

    def list_ids(self) -> list:
        with self._lock:
            return sorted(
                f[: -len(".json")] for f in os.listdir(self.path) if f.endswith(".json")
            )
