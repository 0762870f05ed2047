"""Deterministic arrival traces: diurnal ramps, bursts, churn (counterpart
of ``sda_tpu/utils/arrivals.py``).

The flagship campaign and the load soak need *realistic* open-loop
arrival processes — phones check in on a diurnal cycle, push
notifications produce thundering-herd bursts, and a slice of the cohort
churns (disconnects and retries late) — while staying byte-replayable:
the same spec and seed must produce the same arrival sequence on any
host, any wall clock, any PID, and the same floats, bit for bit, as
``sda_tpu``'s traces: the draws are the same Python ``random`` and
``math`` calls. This module is the fault plane's
(:mod:`.faults`) sibling for *offered load* instead of injected
failure: a tiny spec grammar, pure ``(seed, index)`` draws, no global
state.

Spec grammar (``--trace <spec>[:<seed>]``)::

    spec  := rule ("," rule)*
    rule  := "base"    "=" rate            — baseline arrivals/second
           | "diurnal" "=" amp ["@" period]
                — sinusoidal day-cycle: rate multiplier
                  1 + amp*sin(2*pi*t/period); amp in [0,1],
                  period seconds (default 60 — a compressed "day"
                  so a minutes-long soak sees full cycles)
           | "burst"   "=" prob ["@" mult]
                — each 1-second slot independently becomes a burst
                  slot with probability ``prob`` (pure (seed, slot)
                  draw); during a burst the rate is multiplied by
                  ``mult`` (default 5) — the push-notification herd
           | "churn"   "=" prob
                — each arrival independently churns with probability
                  ``prob`` (pure (seed, index) draw): the caller
                  delays that participant's upload to the end of the
                  round, modelling disconnect-and-retry. Churn moves
                  *when* a phone arrives, never *whether* — reveals
                  stay exact
    seed  := integer (default 0)

Examples::

    base=20
    base=50,diurnal=0.8@30,burst=0.1@8:42
    base=10,churn=0.25:7

Determinism: the k-th inter-arrival gap is ``-ln(1-u)/rate(t_k)`` with
``u`` a pure function of (seed, k) — a seed-replayable inhomogeneous
Poisson process (rate frozen over each gap, fine at soak rates). Burst
slots and churn flags draw from disjoint index spaces of the same seed
so adding a rule never shifts another rule's sequence.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .faults import _unit

#: disjoint (seed, index) spaces: gap draws, burst-slot draws, churn
#: draws must not consume each other's sequence
_GAP_SPACE = 0
_BURST_SPACE = 1 << 40
_CHURN_SPACE = 2 << 40

#: burst slots are drawn per whole second of trace time
_SLOT_S = 1.0


@dataclass(frozen=True)
class TraceSpec:
    base: float
    diurnal_amp: float = 0.0
    diurnal_period: float = 60.0
    burst_prob: float = 0.0
    burst_mult: float = 5.0
    churn_prob: float = 0.0
    seed: int = 0


def parse_trace(text: str) -> TraceSpec:
    """Parse ``<spec>[:<seed>]`` into a :class:`TraceSpec`. Raises
    ValueError on unknown rules, rates/probabilities out of range, or a
    missing ``base``."""
    text = text.strip()
    if not text:
        raise ValueError("empty arrival-trace spec")
    spec, seed = text, 0
    if ":" in text:
        spec, _, tail = text.rpartition(":")
        try:
            seed = int(tail)
        except ValueError:
            raise ValueError(f"trace seed must be an integer, got {tail!r}")
    fields = {"seed": seed}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        kind, eq, rhs = item.partition("=")
        if not eq:
            raise ValueError(f"trace rule {item!r} is not kind=value[@param]")
        value_text, at, param_text = rhs.partition("@")
        value = float(value_text)
        if kind == "base":
            if value <= 0:
                raise ValueError(f"trace base rate must be > 0, got {value}")
            fields["base"] = value
        elif kind == "diurnal":
            if not 0.0 <= value <= 1.0:
                raise ValueError(f"diurnal amplitude must be in [0,1], got {value}")
            fields["diurnal_amp"] = value
            if at:
                period = float(param_text)
                if period <= 0:
                    raise ValueError(f"diurnal period must be > 0, got {period}")
                fields["diurnal_period"] = period
        elif kind == "burst":
            if not 0.0 <= value <= 1.0:
                raise ValueError(f"burst probability must be in [0,1], got {value}")
            fields["burst_prob"] = value
            if at:
                mult = float(param_text)
                if mult < 1.0:
                    raise ValueError(f"burst multiplier must be >= 1, got {mult}")
                fields["burst_mult"] = mult
        elif kind == "churn":
            if not 0.0 <= value <= 1.0:
                raise ValueError(f"churn probability must be in [0,1], got {value}")
            fields["churn_prob"] = value
        else:
            raise ValueError(
                f"unknown trace rule {kind!r} (know base/diurnal/burst/churn)"
            )
    if "base" not in fields:
        raise ValueError("arrival-trace spec needs a base=<rate> rule")
    return TraceSpec(**fields)


class ArrivalTrace:
    """One parsed spec's pure arrival process.

    Everything is a function of (spec, seed, index) — two traces built
    from the same text produce identical sequences independently.
    """

    def __init__(self, spec: TraceSpec):
        self.spec = spec

    @classmethod
    def from_text(cls, text: str) -> "ArrivalTrace":
        return cls(parse_trace(text))

    def is_burst_slot(self, slot: int) -> bool:
        s = self.spec
        return s.burst_prob > 0 and _unit(s.seed, _BURST_SPACE + slot) < s.burst_prob

    def rate_at(self, t: float) -> float:
        """Instantaneous offered rate (arrivals/second) at trace time t."""
        s = self.spec
        rate = s.base
        if s.diurnal_amp > 0:
            rate *= 1.0 + s.diurnal_amp * math.sin(
                2.0 * math.pi * t / s.diurnal_period
            )
        if self.is_burst_slot(int(t // _SLOT_S)):
            rate *= s.burst_mult
        # the diurnal trough of amp=1 touches zero; floor so the gap
        # integral below always terminates
        return max(rate, s.base * 1e-3)

    def is_churned(self, index: int) -> bool:
        """Whether the index-th arrival churns (upload deferred to the
        end of the round by the caller)."""
        s = self.spec
        return s.churn_prob > 0 and _unit(s.seed, _CHURN_SPACE + index) < s.churn_prob

    def next_arrival(self, index: int, t: float) -> float:
        """Arrival time of the ``index``-th event given the previous
        arrival at trace time ``t``: an exponential gap from the pure
        (seed, index) draw, rate frozen over the gap. Callers stepping a
        live trace keep (index, t) as their cursor."""
        u = _unit(self.spec.seed, _GAP_SPACE + index)
        # u in [0,1): 1-u in (0,1], so the log is finite
        return t + -math.log(1.0 - u) / self.rate_at(t)

    def times(self, n: int, start: float = 0.0) -> list[float]:
        """The first ``n`` arrival offsets (seconds from trace start)."""
        out = []
        t = start
        for k in range(n):
            t = self.next_arrival(k, t)
            out.append(t)
        return out
