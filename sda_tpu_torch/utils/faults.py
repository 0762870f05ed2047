"""Deterministic fault injection + retry/backoff primitives (copy of
``sda_tpu/utils/faults.py``).

The churn-and-chaos plane's transport half: a seed-driven fault plane
that the REST client and server interpose to inject the failures flaky
cloud transport actually produces — dead connections, transient 5xx
with Retry-After, latency spikes, truncated response bodies — plus the
jittered exponential ``Backoff`` the hardened client and the daemon
poll loops share.

Spec grammar (``SDA_FAULTS=<spec>:<seed>``)::

    spec  := rule ("," rule)*
    rule  := [side "."] kind "=" rate ["@" param]
    side  := "client" | "server"          (default: server)
    kind  := "drop"     — kill the connection without an HTTP response
           | "e503"     — answer 503; param = Retry-After seconds (0.05)
           | "latency"  — stall before handling; param = seconds (0.05)
           | "truncate" — declare the full Content-Length but send half
           | "reset"    — send half the body then abort the connection
                          (the mid-response-body RST flaky LBs produce)
    rate  := probability in [0, 1] that a request draws this fault
    seed  := integer (default 0)

Examples::

    SDA_FAULTS=e503=0.1@0.2:42
    SDA_FAULTS=drop=0.05,latency=0.2@0.01,truncate=0.05:7
    SDA_FAULTS=client.drop=0.1,e503=0.1:3

Determinism: the fault drawn for the N-th request on a side is a pure
function of (seed, N) — ``FaultPlane.decide(n)`` — so the same spec and
seed replay the same failure sequence regardless of wall clock or PID.
Each request draws at most one fault (rules partition one uniform
draw), and the client and server sides count requests independently.

The plane is OFF unless ``SDA_FAULTS`` is set; the interposition points
check a cached module accessor (one env read) per request, so the cost
when disabled is a dict lookup.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass

from .. import telemetry

SPEC_ENV = "SDA_FAULTS"

KINDS = ("drop", "e503", "latency", "truncate", "reset")

#: default per-kind parameter (seconds: Retry-After for e503, stall for
#: latency; drop/truncate/reset take no parameter)
_DEFAULT_PARAM = {
    "drop": 0.0,
    "e503": 0.05,
    "latency": 0.05,
    "truncate": 0.0,
    "reset": 0.0,
}


@dataclass(frozen=True)
class Fault:
    kind: str
    param: float


@dataclass(frozen=True)
class Rule:
    side: str  # "client" | "server"
    kind: str
    rate: float
    param: float


def parse_spec(text: str) -> tuple[list[Rule], int]:
    """Parse ``<spec>:<seed>`` into (rules, seed). Raises ValueError on
    unknown kinds/sides, rates outside [0, 1], or per-side rates summing
    past 1 (the rules partition a single uniform draw)."""
    text = text.strip()
    if not text:
        raise ValueError("empty SDA_FAULTS spec")
    spec, seed = text, 0
    if ":" in text:
        spec, _, tail = text.rpartition(":")
        try:
            seed = int(tail)
        except ValueError:
            raise ValueError(f"SDA_FAULTS seed must be an integer, got {tail!r}")
    rules = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        lhs, eq, rhs = item.partition("=")
        if not eq:
            raise ValueError(f"SDA_FAULTS rule {item!r} is not kind=rate[@param]")
        side, dot, kind = lhs.partition(".")
        if not dot:
            side, kind = "server", lhs
        if side not in ("client", "server"):
            raise ValueError(f"SDA_FAULTS side must be client or server, got {side!r}")
        if kind not in KINDS:
            raise ValueError(f"unknown SDA_FAULTS kind {kind!r} (know {KINDS})")
        rate_text, at, param_text = rhs.partition("@")
        rate = float(rate_text)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"SDA_FAULTS rate for {kind} must be in [0,1], got {rate}")
        param = float(param_text) if at else _DEFAULT_PARAM[kind]
        if param < 0:
            raise ValueError(f"SDA_FAULTS param for {kind} must be >= 0, got {param}")
        rules.append(Rule(side=side, kind=kind, rate=rate, param=param))
    if not rules:
        raise ValueError("SDA_FAULTS spec has no rules")
    for side in ("client", "server"):
        total = sum(r.rate for r in rules if r.side == side)
        if total > 1.0 + 1e-9:
            raise ValueError(f"{side}-side SDA_FAULTS rates sum to {total} > 1")
    return rules, seed


def _unit(seed: int, index: int) -> float:
    """One uniform draw in [0, 1) as a pure function of (seed, index).
    Mersenne-Twister int seeding is stable across platforms and runs,
    so the whole failure sequence replays from the spec alone."""
    return random.Random((seed * 1_000_003 + index) & 0xFFFFFFFFFFFFFFFF).random()


class FaultPlane:
    """One side's view of a parsed spec: a thread-safe request counter
    plus the pure (seed, index) -> fault decision."""

    def __init__(self, rules: list[Rule], seed: int, side: str):
        self.rules = tuple(r for r in rules if r.side == side)
        self.seed = seed
        self.side = side
        self._lock = threading.Lock()
        self._index = 0

    def decide(self, index: int) -> Fault | None:
        """The deterministic core: walk the rules through one uniform
        draw, so a request suffers at most one fault."""
        u = _unit(self.seed, index)
        acc = 0.0
        for rule in self.rules:
            acc += rule.rate
            if u < acc:
                return Fault(rule.kind, rule.param)
        return None

    def draw(self) -> Fault | None:
        """Decide for the next request index (counted per side)."""
        with self._lock:
            index = self._index
            self._index += 1
        fault = self.decide(index)
        if fault is not None and telemetry.enabled():
            telemetry.counter(
                "sda_fault_injections_total",
                "faults injected by the SDA_FAULTS plane, by side and kind",
                side=self.side,
                kind=fault.kind,
            ).inc()
        return fault


# planes are cached per (spec text, side) so the request counter — and
# with it the deterministic failure sequence — survives across requests;
# changing the env spec mid-process starts a fresh sequence
_cache_lock = threading.Lock()
_planes: dict = {}


def plane(side: str) -> FaultPlane | None:
    text = os.environ.get(SPEC_ENV)
    if not text:
        return None
    key = (text, side)
    with _cache_lock:
        cached = _planes.get(key)
        if cached is None and key not in _planes:
            rules, seed = parse_spec(text)
            built = FaultPlane(rules, seed, side)
            cached = _planes[key] = built if built.rules else None
        return cached


def client_draw() -> Fault | None:
    p = plane("client")
    return p.draw() if p is not None else None


def server_draw() -> Fault | None:
    p = plane("server")
    return p.draw() if p is not None else None


class Backoff:
    """Jittered exponential backoff (full jitter): delay i is uniform in
    [0, min(cap, base * factor**i)], optionally floored by a server's
    Retry-After. Shared by the REST client's retry loop and the
    clerk/committee daemon poll loops — ``reset()`` after useful work so
    a busy queue drains at ``base`` cadence while an idle or stalled
    peer is probed at most every ``cap`` seconds.
    """

    def __init__(self, base: float = 0.05, factor: float = 2.0, cap: float = 2.0,
                 rng: random.Random | None = None):
        self.base = base
        self.factor = factor
        self.cap = cap
        self._attempt = 0
        self._rng = rng if rng is not None else random.Random()

    def ceiling(self) -> float:
        """The next delay's upper bound (before jitter)."""
        return min(self.cap, self.base * self.factor ** self._attempt)

    def next_delay(self, floor: float = 0.0) -> float:
        delay = self._rng.uniform(0.0, self.ceiling())
        self._attempt += 1
        return max(floor, delay)

    def sleep(self, floor: float = 0.0) -> float:
        delay = self.next_delay(floor)
        if delay > 0:
            time.sleep(delay)
        return delay

    def reset(self) -> None:
        self._attempt = 0
