"""Prometheus text-format exposition (version 0.0.4) of a registry snapshot
(copy of ``sda_tpu/telemetry/prom.py``).

Pure string building over :meth:`Registry.snapshot` — no client library,
no HTTP. Series render in deterministic (sorted) order so two scrapes of
the same state are byte-identical, which the CI parse gate and the
replay-minded tests rely on.

Format notes:
- counters render as ``name{labels} value`` with ``# TYPE name counter``;
- histograms render cumulative ``name_bucket{le=...}`` plus ``_sum`` and
  ``_count`` (the ``le`` label is appended after user labels);
- label values are escaped per the exposition spec (backslash, quote,
  newline);
- metric names registered but never observed still emit HELP/TYPE, so a
  scrape taken before traffic proves the series exists.
"""

from __future__ import annotations

import re

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")


def _esc(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _name(raw: str) -> str:
    if _NAME_OK.fullmatch(raw):
        return raw
    safe = re.sub(r"[^a-zA-Z0-9_:]", "_", raw)
    return safe if _NAME_OK.fullmatch(safe) else "_" + safe


def _labelstr(labels: tuple, extra: str = "") -> str:
    parts = [f'{_name(k)}="{_esc(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return repr(value)


def render(snapshot: dict, prefix_comment: str | None = None) -> str:
    """The full exposition for one registry snapshot."""
    meta = snapshot.get("meta", {})
    out: list = []
    if prefix_comment:
        out.append(f"# {prefix_comment}")

    by_name: dict = {}
    for key, value in snapshot.get("counters", {}).items():
        by_name.setdefault(key[0], []).append((key[1], "counter", value))
    for key, value in snapshot.get("gauges", {}).items():
        by_name.setdefault(key[0], []).append((key[1], "gauge", value))
    for key, hist in snapshot.get("histograms", {}).items():
        by_name.setdefault(key[0], []).append((key[1], "histogram", hist))
    # registered-but-unsampled series still announce themselves
    for name in meta:
        by_name.setdefault(name, [])

    for raw_name in sorted(by_name):
        name = _name(raw_name)
        kind, _, help_text = meta.get(raw_name, (None, None, ""))
        if kind is None:
            kind = by_name[raw_name][0][1] if by_name[raw_name] else "untyped"
        if help_text:
            out.append(f"# HELP {name} {_esc(help_text)}")
        out.append(f"# TYPE {name} {kind}")
        for labels, series_kind, value in sorted(
            by_name[raw_name], key=lambda item: item[0]
        ):
            if series_kind == "histogram":
                cumulative = 0
                bounds = [*value["buckets"], float("inf")]
                for bound, count in zip(bounds, value["counts"]):
                    cumulative += count
                    le = 'le="' + _fmt(bound) + '"'
                    out.append(f"{name}_bucket{_labelstr(labels, le)} {cumulative}")
                out.append(f"{name}_sum{_labelstr(labels)} {_fmt(value['sum'])}")
                out.append(f"{name}_count{_labelstr(labels)} {value['count']}")
            else:
                out.append(f"{name}{_labelstr(labels)} {_fmt(value)}")
    return "\n".join(out) + "\n"
