"""The CI gate's drivers over the protocol plane (counterparts of the
reference's ``scripts/``), each run as ``python -m
sda_tpu_torch.scripts.<name>``:

- ``check_metrics``: a live ``/v1/metrics`` scrape that must show every
  core series, the observability routes and a merged two-process history;
- ``load_soak``: paced rounds against live REST with the time-series
  sampler, banked as ``soak-*.json``;
- ``trace_report``: one trace's flight-recorder timeline from a banked
  artifact;
- ``flagship``: the certified-cohort ladder of tiered rounds over several
  ``sdad`` frontend and committee processes;
- ``soak``: randomized in-process rounds across the scheme matrix;
- ``rest_ingest``: participation POSTs against a live server, rows
  counted in the store;
- ``scenarios``: the named churn scenarios over (store x transport)
  deployment cells, banked as ``scenario-*.json`` with the survivability
  matrix;
- ``crash_soak``: randomized rounds over two ``sdad --sqlite`` processes on
  one file, one of them SIGKILLed mid-round.

The flags, exit codes and artifact shapes are the reference's. Every
script that builds a client or spawns a committee takes ``--device``
(``cuda`` by default; without a GPU it exits 2) and spawns only
``sda_tpu_torch.cli.sdad``.
"""

from __future__ import annotations

import pathlib
import sys

#: the checkout's root: spawned ``sdad`` processes run from here, and
#: ``--artifacts`` defaults under it
REPO = pathlib.Path(__file__).resolve().parents[2]


def device_or_exit(name: str, device):
    """``resolve_device(device)``, or the message on stderr and exit code
    2 when it cannot be had (no GPU and no ``--device cpu``)."""
    from ..device import resolve_device

    try:
        return resolve_device(device)
    except RuntimeError as exc:
        print(f"{name}: {exc}", file=sys.stderr)
        raise SystemExit(2) from None
