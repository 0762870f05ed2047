"""Device spans: ``torch.profiler`` ranges at the port's device-plane layer
boundaries, and at the places where the host waits on the card.

``device_span(name)`` opens a ``record_function`` range named ``sda.<name>``
while a profiler records, so the range lands in the profiler's own trace,
on the clock of every device record: a device op belongs to the innermost
range that was open when the host launched it. Any profiler turns the
ranges on (``utils.metrics.torch_trace``, or an operator's own
``torch.profiler.profile``); with none recording, a span costs one check
and returns one shared null context, so the hot loops pay next to nothing.

``sync(site)`` marks a host sync (``int``/``bool`` of a device tensor,
``.cpu()``) as the range ``sync.<site>``. The card idles from the sync
until the host's next launch; in a trace that gap begins inside the sync's
range, and the ranges of a site count its syncs.

The module imports no torch: the protocol plane (``sdad`` and its stores)
runs without it, and where torch is not loaded no profiler records.
"""

from __future__ import annotations

import contextlib
import sys

#: prefix of every range the port opens in a profiler's trace
PREFIX = "sda."

_NULL = contextlib.nullcontext()


def device_span(name: str):
    """A ``torch.profiler.record_function`` range ``sda.<name>`` while a
    profiler records; otherwise one shared null context."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def sync(site: str):
    """A host sync at ``site``: the range ``sync.<site>``."""
    return device_span("sync." + site)
