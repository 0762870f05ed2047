"""Structured JSON log sink keyed by trace-id (copy of
``sda_tpu/telemetry/logsink.py``).

Every telemetry event (spans today; callers may emit their own via
:func:`emit`) becomes one JSON object on the ``sda.telemetry`` logger at
DEBUG — invisible by default, and one ``install()`` away from a greppable
JSON-lines file whose every line carries the trace id, so
``grep <trace-id> telemetry.jsonl`` reconstructs a request's journey
through client, REST, service, and store.

Kept separate from :mod:`.spans` so the stdlib ``logging`` import and
json encoding stay off the span hot path until a record is actually
emitted.
"""

from __future__ import annotations

import json
import logging

log = logging.getLogger("sda.telemetry")


def emit(event: str, fields: dict) -> None:
    """One JSON log line for ``fields`` (must already carry trace_id when
    there is one). No-op unless something listens at DEBUG."""
    if not log.isEnabledFor(logging.DEBUG):
        return
    try:
        log.debug("%s", json.dumps({"event": event, **fields}, default=repr))
    except (TypeError, ValueError):
        log.debug('{"event": %r, "error": "unserializable record"}', event)


def install(path, level: int = logging.DEBUG) -> logging.Handler:
    """Attach a JSON-lines file handler to the telemetry logger and
    return it (pass to :func:`uninstall` to detach). The formatter is
    bare ``%(message)s`` — records are already JSON."""
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(message)s"))
    handler.setLevel(level)
    log.addHandler(handler)
    if log.level == logging.NOTSET or log.level > level:
        log.setLevel(level)
    return handler


def uninstall(handler: logging.Handler) -> None:
    log.removeHandler(handler)
    handler.close()
