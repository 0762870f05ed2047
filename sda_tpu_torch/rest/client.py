"""REST binding of the SDA service — the client proxy (counterpart of
``sda_tpu/rest/client.py``, on the standard library's ``http.client``).

Re-implements the full ``SdaService`` interface over HTTP (the SDA HTTP
client's client.rs:173-370), decorating every authenticated request with
Basic auth from the ``TokenStore``. Response protocol: 404 with the
``Resource-not-found`` header means ``None``; 401/403/400 map back to the
protocol error types; any other failure is an ``SdaError`` carrying the
status and body.

Transport: a keep-alive pool of ``http.client`` connections per server
root (up to ``POOL_MAXSIZE`` idle ones), reused across the client's
lifetime and safe to share between threads — the server holds these
connections open, so a round is mostly zero-handshake. A pooled connection
the server has since closed is detected before reuse (its socket reads as
ready) and replaced. The hot bulk routes — the participation batch POST
and the clerking-job / snapshot-result chunk GETs — default to the
negotiated ``application/x-sda-binary`` frames from ``rest/wire.py``; GETs
advertise it via ``Accept`` and parse whatever Content-Type the server
answers with, so a JSON-only server downgrades transparently.
``SDA_WIRE=json`` forces the JSON bodies on every route.

Multi-frontend routing: constructed with a *list* of base URLs, the client
becomes its own router over the frontends — aggregation-keyed requests
hash their aggregation id on the same ``HashRing`` the reference's sharded
store uses, so one aggregation's traffic converges on one frontend without
coordination; unkeyed requests pin to the first frontend. A frontend that
fails at the transport level is quarantined for ``SDA_REST_QUARANTINE_S``
and the request falls over to the next frontend in the key's
ring-preference order; 429 (admission shed) is pacing, not failure — it
backs off against the *same* frontend honoring Retry-After.
"""

from __future__ import annotations

import base64
import http.client
import json
import os
import random
import re
import select
import threading
import time
from urllib.parse import quote, urlencode, urlsplit

from .. import telemetry
from ..utils import faults
from . import wire
from ..protocol import (
    Agent,
    Aggregation,
    AggregationId,
    AggregationStatus,
    ClerkCandidate,
    ClerkingJob,
    ClerkingResult,
    Committee,
    Encryption,
    InvalidCredentialsError,
    InvalidRequestError,
    PermissionDeniedError,
    Pong,
    Profile,
    SdaError,
    SdaService,
    SnapshotResult,
    TierStatus,
    signed_encryption_key_from_json,
)
from ..utils.hashring import HashRing


#: connect + per-socket-operation timeout (each socket operation gets this
#: long, NOT the whole request — a server dripping bytes can still hold a
#: connection open longer). No protocol call long-polls
#: (get_clerking_job returns immediately), so a stalled socket is a sick
#: server: surface it as SdaError instead of blocking indefinitely. Pass
#: ``timeout=None`` to wait forever, as the SDA HTTP client does.
DEFAULT_TIMEOUT_S = 300.0

#: idle keep-alive connections kept per server root: the concurrent
#: committee runner's clerks and the recipient's range fetches share one
#: client, and overflow connections are closed after use
POOL_MAXSIZE = 32

#: what a failed exchange raises: socket errors (refused, reset, timeout)
#: and malformed or short HTTP responses
_TRANSPORT_ERRORS = (OSError, http.client.HTTPException)


def _retry_budget() -> int:
    """Extra attempts after the first, for retryable requests
    (``SDA_REST_RETRIES``, default 4). 0 disables retrying."""
    return max(0, int(os.environ.get("SDA_REST_RETRIES", "4")))


def _backoff_base_s() -> float:
    return float(os.environ.get("SDA_REST_BACKOFF_BASE_S", "0.05"))


def _backoff_cap_s() -> float:
    return float(os.environ.get("SDA_REST_BACKOFF_CAP_S", "2.0"))


def _retry_after_cap_s() -> float:
    """Upper bound honored for a server's Retry-After header — a sick or
    hostile server must not be able to park the client for an hour."""
    return float(os.environ.get("SDA_REST_RETRY_AFTER_CAP_S", "30.0"))


def _quarantine_s() -> float:
    """How long a frontend that failed at the transport level sits out of
    the candidate rotation (``SDA_REST_QUARANTINE_S``, default 3.0) — long
    enough that a dead frontend is not re-probed on every request, short
    enough that a restarted one rejoins promptly."""
    try:
        return max(0.0, float(os.environ.get("SDA_REST_QUARANTINE_S", "3.0")))
    except ValueError:
        return 3.0


#: transient server-side statuses worth retrying; 4xx are the caller's
#: fault and never retried — except 429, which is the admission-control
#: plane explicitly asking for a paced retry (Retry-After honored)
_RETRYABLE_STATUSES = (429, 500, 502, 503, 504)


def _retry_after_s(resp) -> float:
    """Parse a delta-seconds Retry-After (the only form the SDA server
    emits), clamped to the cap; HTTP-date forms fall back to 0."""
    raw = resp.headers.get("Retry-After")
    if not raw:
        return 0.0
    try:
        return min(max(0.0, float(raw)), _retry_after_cap_s())
    except ValueError:
        return 0.0


class _Response:
    """One fully-read HTTP response: status, headers (case-insensitive
    ``get``), body bytes."""

    __slots__ = ("status_code", "headers", "content")

    def __init__(self, status_code: int, headers, content: bytes):
        self.status_code = status_code
        self.headers = headers
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content)


def _is_dropped(conn) -> bool:
    """Has the peer closed (or written into) this idle pooled connection?
    A live idle keep-alive socket has nothing to read; EOF or stray bytes
    make it readable, and reusing it would fail the next request."""
    if conn.sock is None:
        return True
    try:
        return bool(select.select([conn.sock], [], [], 0)[0])
    except (OSError, ValueError):
        return True


class _Pool:
    """Idle keep-alive connections to one server root, shared by threads."""

    def __init__(self, root: str, timeout):
        parts = urlsplit(root)
        self.factory = (
            http.client.HTTPSConnection if parts.scheme == "https" else http.client.HTTPConnection
        )
        self.host, self.port, self.prefix = parts.hostname, parts.port, parts.path
        self.timeout = timeout
        self._idle: list = []
        self._lock = threading.Lock()

    def take(self):
        with self._lock:
            while self._idle:
                conn = self._idle.pop()
                if not _is_dropped(conn):
                    return conn
                conn.close()
        return self.factory(self.host, self.port, timeout=self.timeout)

    def give(self, conn) -> None:
        with self._lock:
            if len(self._idle) < POOL_MAXSIZE:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class SdaHttpClient(SdaService):
    def __init__(self, server_root, token_store,
                 timeout: float | None = DEFAULT_TIMEOUT_S):
        """``server_root`` is one base URL, or a list of them (one per
        frontend of a sharded deployment, in frontend order — the order
        the ring indexes into; every client must agree on it)."""
        roots = [server_root] if isinstance(server_root, str) else list(server_root)
        if not roots:
            raise ValueError("SdaHttpClient needs at least one server root")
        self.roots = [r.rstrip("/") for r in roots]
        self.server_root = self.roots[0]
        self._ring = HashRing(len(self.roots)) if len(self.roots) > 1 else None
        #: root -> monotonic quarantine expiry (transport failures only)
        self._quarantined = {}
        #: per-client RNG for quarantine full jitter (injectable in tests)
        self._jitter = random.Random()
        self.token_store = token_store
        self.timeout = timeout
        self._pools = {root: _Pool(root, timeout) for root in self.roots}

    def close(self) -> None:
        """Close every idle pooled connection."""
        for pool in self._pools.values():
            pool.close()

    def _exchange(self, root: str, method: str, target: str, body, headers) -> _Response:
        """One HTTP request/response on a pooled connection to ``root``;
        raises one of ``_TRANSPORT_ERRORS`` when the exchange fails. The
        connection goes back to the pool only after a complete response
        the server did not mark as its last."""
        pool = self._pools[root]
        conn = pool.take()
        try:
            conn.request(method, pool.prefix + target, body=body,
                         headers={"User-Agent": "sda-tpu-torch client", **headers})
            resp = conn.getresponse()
            content = resp.read()
        except BaseException:
            conn.close()
            raise
        if resp.will_close:
            conn.close()
        else:
            pool.give(conn)
        return _Response(resp.status, resp.headers, content)

    # -- plumbing -----------------------------------------------------------

    def _quarantine_expiry(self, now: float) -> float:
        """Quarantine deadline for a frontend that just failed: full
        jitter over (0, SDA_REST_QUARANTINE_S]. A fixed sit-out would
        re-synchronize every client that watched the same frontend die —
        they would all re-probe the recovering process on the same tick,
        exactly the thundering herd the quarantine exists to prevent.
        Uniform jitter spreads the re-probes over the whole window; a
        short draw just means one early scout, not a stampede, because
        the other clients' deadlines stay spread out."""
        q = _quarantine_s()
        return now + (self._jitter.uniform(0.0, q) if q > 0 else 0.0)

    def route_index(self, route_key) -> int:
        """Which frontend (index into ``self.roots``) ``route_key``'s
        traffic homes on: ``HashRing(len(roots)).shard_for(str(key))``,
        the reference's placement function, so a launcher can place a
        committee daemon on the exact frontend the client's keyed requests
        will use (failover aside)."""
        if self._ring is None:
            return 0
        return self._ring.shard_for(str(route_key))

    def _candidate_roots(self, route_key) -> list:
        """Frontend base URLs in try-order for this request: the key's
        ring-preference order (or plain frontend order when unkeyed),
        with currently-quarantined frontends demoted to the back — never
        dropped, so a fully-quarantined plane still tries everything."""
        if len(self.roots) == 1:
            return self.roots
        if route_key is not None and self._ring is not None:
            ordered = [self.roots[ix] for ix in self._ring.preference(str(route_key))]
        else:
            ordered = list(self.roots)
        now = time.monotonic()
        live = [r for r in ordered if self._quarantined.get(r, 0.0) <= now]
        dead = [r for r in ordered if self._quarantined.get(r, 0.0) > now]
        return live + dead

    def _request(self, method: str, path: str, caller=None, body=None, params=None,
                 idempotent: bool | None = None, raw_body: bytes | None = None,
                 content_type: str | None = None, accept: str | None = None,
                 raw: bool = False, route_key=None):
        """One protocol call, with transient-failure hardening.

        ``raw_body``/``content_type`` send a pre-encoded body (the binary
        wire frames) instead of a JSON one; ``accept`` advertises an
        alternate response format; ``raw=True`` returns the response on
        2xx so the caller can negotiate on the response Content-Type
        (``None``/error mapping is unchanged).

        ``idempotent=None`` (the default) retries GET/DELETE only. POST
        call sites whose server handlers are idempotent by construction
        (create-if-identical stores, upsert semantics, deterministic
        snapshot no-op) pass ``idempotent=True`` to opt in — a replayed
        create either matches byte-for-byte (absorbed) or conflicts
        (fails like the first attempt would have). Retries cover
        transport failures and transient 5xx/429 only, with full-jitter
        exponential backoff floored by the server's Retry-After; other
        4xx are never retried.

        ``route_key`` (an aggregation id, usually) picks the frontend on
        a multi-root client; a transport failure quarantines the frontend
        and the retry falls over to the next one in ring order, while a
        retryable *status* stays on the same frontend (it answered).
        """
        target = path + ("?" + urlencode(params) if params else "")
        candidates = self._candidate_roots(route_key)
        root_ix = 0
        data = None
        headers = {}
        if caller is not None:
            cred = f"{caller.id}:{self.token_store.get()}".encode("utf-8")
            headers["Authorization"] = "Basic " + base64.b64encode(cred).decode("ascii")
        if raw_body is not None:
            data = raw_body
            headers["Content-Type"] = content_type or wire.CONTENT_TYPE
        elif body is not None:
            payload = body.to_json() if hasattr(body, "to_json") else body
            # compact, like the reference client's serde_json bodies
            data = json.dumps(payload, separators=(",", ":")).encode("utf-8")
            headers["Content-Type"] = "application/json"
        if accept is not None:
            headers["Accept"] = accept
        trace_id = telemetry.current_trace_id() if telemetry.enabled() else None
        if trace_id:
            # propagate the caller's trace id so server-side spans join it
            headers[telemetry.TRACE_HEADER] = trace_id
        if idempotent is None:
            idempotent = method in ("GET", "DELETE")
        attempts = 1 + (_retry_budget() if idempotent else 0)
        backoff = None  # built lazily: the happy path never touches it
        floor = 0.0
        t0 = time.perf_counter()
        for attempt in range(attempts):
            if attempt:
                if backoff is None:
                    backoff = faults.Backoff(
                        base=_backoff_base_s(), cap=_backoff_cap_s()
                    )
                backoff.sleep(floor)
                floor = 0.0
            try:
                fault = faults.client_draw()
                if fault is not None:
                    if fault.kind == "latency":
                        time.sleep(fault.param)
                    elif fault.kind == "drop":
                        # synthetic connection death, routed through the
                        # same except arm a real one would take
                        raise ConnectionError(
                            "SDA_FAULTS: injected client-side connection drop"
                        )
                    elif fault.kind == "reset":
                        # a client-side reset surfaces the same way a
                        # server RST mid-body does: a dead connection
                        raise ConnectionResetError(
                            "SDA_FAULTS: injected client-side connection reset"
                        )
                resp = self._exchange(candidates[root_ix], method, target, data, headers)
            except _TRANSPORT_ERRORS as exc:
                if attempt + 1 < attempts:
                    if len(candidates) > 1:
                        # this frontend is unreachable: bench it and fall
                        # over to the next one in the key's ring order
                        self._quarantined[candidates[root_ix]] = (
                            self._quarantine_expiry(time.monotonic())
                        )
                        root_ix = (root_ix + 1) % len(candidates)
                    self._count_retry(method, path, "transport")
                    continue
                # timeouts/connection failures join the documented error
                # surface — daemon loops (e.g. `sda clerk`) catch SdaError
                # and keep polling instead of dying on a transient stall
                raise SdaError(f"HTTP/REST transport failure: {exc!r}") from exc
            if resp.status_code in _RETRYABLE_STATUSES and attempt + 1 < attempts:
                floor = _retry_after_s(resp)
                self._count_retry(method, path, f"status_{resp.status_code}")
                continue
            break
        if telemetry.enabled():
            telemetry.histogram(
                "sda_http_client_request_seconds",
                "client-observed REST request latency by route template",
                method=method,
                route=re.sub(r"[0-9a-fA-F-]{36}", "{id}", path),
            ).observe(time.perf_counter() - t0)
        return self._process(resp, raw=raw)

    @staticmethod
    def _count_retry(method: str, path: str, reason: str) -> None:
        if telemetry.enabled():
            telemetry.counter(
                "sda_rest_retries_total",
                "REST client retries by route template and reason",
                method=method,
                route=re.sub(r"[0-9a-fA-F-]{36}", "{id}", path),
                reason=reason,
            ).inc()

    @staticmethod
    def _process(resp, raw: bool = False):
        if resp.status_code in (200, 201):
            if raw:
                return resp if resp.content else None
            return resp.json() if resp.content else None
        if resp.status_code == 404:
            if "Resource-not-found" in resp.headers:
                return None
            raise SdaError("HTTP/REST route not found")
        if resp.status_code == 401:
            raise InvalidCredentialsError(resp.text)
        if resp.status_code == 403:
            raise PermissionDeniedError(resp.text)
        if resp.status_code == 400:
            raise InvalidRequestError(resp.text)
        raise SdaError(f"HTTP/REST error: {resp.status_code} {resp.text}")

    # -- base ---------------------------------------------------------------

    def ping(self) -> Pong:
        return Pong.from_json(self._request("GET", "/v1/ping"))

    # -- observability (additive, unauthenticated) ---------------------------

    def get_metrics_history(self, n: int | None = None) -> dict:
        """The server's time-series window (``GET /v1/metrics/history``):
        ``{running, interval_s, samples: [...]}``, newest-last."""
        params = {"n": int(n)} if n else None
        return self._request("GET", "/v1/metrics/history", params=params)

    def get_healthz(self) -> dict:
        return self._request("GET", "/v1/healthz")

    def get_readyz(self) -> tuple:
        """Readiness probe: ``(ready, body)`` — unlike the protocol calls
        a 503 here is an *answer* (drain me), not an error, so this reads
        the raw response instead of the retrying error-mapped path."""
        try:
            resp = self._exchange(self.server_root, "GET", "/v1/readyz", None, {})
        except _TRANSPORT_ERRORS as exc:
            raise SdaError(f"HTTP/REST transport failure: {exc!r}") from exc
        try:
            body = resp.json()
        except ValueError:
            body = {"status": "unready", "error": resp.text}
        return resp.status_code == 200, body

    # -- agents -------------------------------------------------------------

    # The POSTs below opt into retries (idempotent=True): every matching
    # server handler is idempotent by construction — stores create via
    # create-if-identical (byte-identical replays absorbed, conflicting
    # ones rejected exactly like a first attempt), profiles are upserts,
    # snapshot creation is a deterministic no-op on retry, and clerking
    # results are job-keyed overwrites of identical bodies — so a replay
    # after a lost response cannot double-apply.

    def create_agent(self, caller, agent) -> None:
        # TOFU token registration accepts an identical re-registration
        self._request("POST", "/v1/agents/me", caller, agent, idempotent=True)

    def get_agent(self, caller, agent_id):
        obj = self._request("GET", f"/v1/agents/{quote(str(agent_id))}", caller)
        return None if obj is None else Agent.from_json(obj)

    def upsert_profile(self, caller, profile) -> None:
        self._request("POST", "/v1/agents/me/profile", caller, profile,
                      idempotent=True)

    def get_profile(self, caller, owner_id):
        obj = self._request("GET", f"/v1/agents/{quote(str(owner_id))}/profile", caller)
        return None if obj is None else Profile.from_json(obj)

    def create_encryption_key(self, caller, signed_key) -> None:
        self._request("POST", "/v1/agents/me/keys", caller, signed_key,
                      idempotent=True)

    def get_encryption_key(self, caller, key_id):
        obj = self._request("GET", f"/v1/agents/any/keys/{quote(str(key_id))}", caller)
        return None if obj is None else signed_encryption_key_from_json(obj)

    # -- aggregations -------------------------------------------------------

    def list_aggregations(self, caller, filter=None, recipient=None):
        params = {}
        if filter is not None:
            params["title"] = filter
        if recipient is not None:
            params["recipient"] = str(recipient)
        obj = self._request("GET", "/v1/aggregations", caller, params=params)
        return [AggregationId(i) for i in obj]

    def get_aggregation(self, caller, aggregation_id):
        obj = self._request("GET", f"/v1/aggregations/{quote(str(aggregation_id))}", caller,
                            route_key=aggregation_id)
        return None if obj is None else Aggregation.from_json(obj)

    def get_committee(self, caller, aggregation_id):
        obj = self._request(
            "GET", f"/v1/aggregations/{quote(str(aggregation_id))}/committee", caller,
            route_key=aggregation_id,
        )
        return None if obj is None else Committee.from_json(obj)

    # -- recipient ----------------------------------------------------------

    def create_aggregation(self, caller, aggregation) -> None:
        self._request("POST", "/v1/aggregations", caller, aggregation,
                      idempotent=True, route_key=aggregation.id)

    def delete_aggregation(self, caller, aggregation_id) -> None:
        self._request("DELETE", f"/v1/aggregations/{quote(str(aggregation_id))}", caller,
                      route_key=aggregation_id)

    def suggest_committee(self, caller, aggregation_id):
        obj = self._request(
            "GET",
            f"/v1/aggregations/{quote(str(aggregation_id))}/committee/suggestions",
            caller,
            route_key=aggregation_id,
        )
        return [ClerkCandidate.from_json(c) for c in obj]

    def create_committee(self, caller, committee) -> None:
        self._request("POST", "/v1/aggregations/implied/committee", caller,
                      committee, idempotent=True, route_key=committee.aggregation)

    def get_aggregation_status(self, caller, aggregation_id):
        obj = self._request(
            "GET", f"/v1/aggregations/{quote(str(aggregation_id))}/status", caller,
            route_key=aggregation_id,
        )
        return None if obj is None else AggregationStatus.from_json(obj)

    def get_tier_status(self, caller, aggregation_id):
        obj = self._request(
            "GET", f"/v1/aggregations/{quote(str(aggregation_id))}/tiers", caller,
            route_key=aggregation_id,
        )
        return None if obj is None else TierStatus.from_json(obj)

    def create_snapshot(self, caller, snapshot) -> None:
        self._request("POST", "/v1/aggregations/implied/snapshot", caller,
                      snapshot, idempotent=True, route_key=snapshot.aggregation)

    def get_snapshot_result(self, caller, aggregation_id, snapshot_id):
        obj = self._request(
            "GET",
            f"/v1/aggregations/{quote(str(aggregation_id))}/snapshots/{quote(str(snapshot_id))}/result",
            caller,
            route_key=aggregation_id,
        )
        return None if obj is None else SnapshotResult.from_json(obj)

    def _get_negotiated(self, path, caller, decode_binary, decode_json,
                        route_key=None):
        """A chunk GET that prefers the binary wire format: advertise it
        via Accept (unless ``SDA_WIRE=json``), then parse by the response
        Content-Type — a JSON-only server downgrades transparently."""
        if wire.mode() != "binary":
            obj = self._request("GET", path, caller, route_key=route_key)
            return None if obj is None else decode_json(obj)
        resp = self._request("GET", path, caller, accept=wire.CONTENT_TYPE,
                             raw=True, route_key=route_key)
        if resp is None:
            return None
        if wire.is_binary(resp.headers.get("Content-Type")):
            try:
                return decode_binary(resp.content)
            except wire.WireError as e:
                # a fully-delivered but undecodable frame is a server bug,
                # not a transport blip — surface it, never half-decode
                raise SdaError(f"undecodable binary response: {e}") from e
        return decode_json(resp.json())

    def get_snapshot_result_masks(self, caller, aggregation_id, snapshot_id, start):
        return self._get_negotiated(
            f"/v1/aggregations/{quote(str(aggregation_id))}/snapshots/"
            f"{quote(str(snapshot_id))}/result/masks/{int(start)}",
            caller,
            wire.decode_encryptions,
            lambda obj: [Encryption.from_json(e) for e in obj],
            route_key=aggregation_id,
        )

    def get_snapshot_result_clerks(self, caller, aggregation_id, snapshot_id, start):
        return self._get_negotiated(
            f"/v1/aggregations/{quote(str(aggregation_id))}/snapshots/"
            f"{quote(str(snapshot_id))}/result/clerks/{int(start)}",
            caller,
            wire.decode_clerking_results,
            lambda obj: [ClerkingResult.from_json(c) for c in obj],
            route_key=aggregation_id,
        )

    # -- participation ------------------------------------------------------

    def create_participation(self, caller, participation) -> None:
        self._request("POST", "/v1/aggregations/participations", caller,
                      participation, idempotent=True,
                      route_key=participation.aggregation)

    def create_participations(self, caller, participations) -> None:
        """Batched submit: the whole array in one request on the batch
        route — one auth check, one response, one store transaction —
        over a pooled keep-alive connection. Overrides
        the interface's sequential (non-atomic) default. The body is one
        binary wire frame by default (columns of raw sealed boxes, no
        base64, no per-field JSON); ``SDA_WIRE=json`` restores the legacy
        JSON array for old servers. Tier-promotion rows (tier_reshare
        tagged — client/clerk.py, client/tiers.py) always go as the JSON
        body: the binary frame has no tag column, and tagged batches are
        a handful of rows per committee, never the ingest hot path."""
        tagged = any(p.tier_reshare is not None for p in participations)
        if wire.mode() == "binary" and not tagged:
            self._request(
                "POST",
                "/v1/aggregations/participations/batch",
                caller,
                raw_body=wire.encode_participations(participations),
                idempotent=True,
                route_key=participations[0].aggregation if participations else None,
            )
        else:
            self._request(
                "POST",
                "/v1/aggregations/participations/batch",
                caller,
                [p.to_json() for p in participations],
                idempotent=True,
                route_key=participations[0].aggregation if participations else None,
            )

    # -- clerking -----------------------------------------------------------

    def get_clerking_job(self, caller, clerk_id):
        # keyed by the polling clerk: spreads committee polling across
        # frontends; any frontend can answer (server-side polls fan out)
        obj = self._request("GET", "/v1/aggregations/any/jobs", caller,
                            route_key=clerk_id)
        return None if obj is None else ClerkingJob.from_json(obj)

    def get_clerking_job_chunk(self, caller, job_id, start):
        return self._get_negotiated(
            f"/v1/aggregations/implied/jobs/{quote(str(job_id))}/chunks/{int(start)}",
            caller,
            wire.decode_encryptions,
            lambda obj: [Encryption.from_json(e) for e in obj],
            route_key=job_id,
        )

    def create_clerking_result(self, caller, result) -> None:
        self._request(
            "POST",
            f"/v1/aggregations/implied/jobs/{quote(str(result.job))}/result",
            caller,
            result,
            idempotent=True,
            route_key=result.job,
        )

    def complete_clerking_job(self, caller, job_id) -> None:
        self._request(
            "POST",
            f"/v1/aggregations/implied/jobs/{quote(str(job_id))}/complete",
            caller,
            idempotent=True,
            route_key=job_id,
        )
