"""REST binding of the SDA service — the server side (copy of
``sda_tpu/rest/server.py``).

Route table, auth model, and status-code mapping are wire-compatible with
the SDA server's rouille binding (server-http/src/lib.rs) and with
``sda_tpu``'s, so either package's client talks to either package's server:

    GET    /v1/ping
    GET    /v1/agents/{AgentId}
    POST   /v1/agents/me
    GET    /v1/agents/{AgentId}/profile
    POST   /v1/agents/me/profile
    GET    /v1/agents/any/keys/{EncryptionKeyId}
    POST   /v1/agents/me/keys
    POST   /v1/aggregations
    GET    /v1/aggregations?title=&recipient=
    GET    /v1/aggregations/{AggregationId}
    DELETE /v1/aggregations/{AggregationId}
    GET    /v1/aggregations/{AggregationId}/committee/suggestions
    POST   /v1/aggregations/implied/committee
    GET    /v1/aggregations/{AggregationId}/committee
    POST   /v1/aggregations/participations
    POST   /v1/aggregations/participations/batch   (additive; JSON array
                              or one application/x-sda-binary frame)
    GET    /v1/aggregations/{AggregationId}/status
    GET    /v1/aggregations/{AggregationId}/tiers     (additive; tiers)
    POST   /v1/aggregations/implied/snapshot
    GET    /v1/aggregations/any/jobs
    GET    /v1/aggregations/implied/jobs/{ClerkingJobId}/chunks/{start}
                              (additive; one ciphertext range of a paged job)
    POST   /v1/aggregations/implied/jobs/{ClerkingJobId}/result
    POST   /v1/aggregations/implied/jobs/{ClerkingJobId}/complete (additive; tiers)
    GET    /v1/aggregations/{AggregationId}/snapshots/{SnapshotId}/result
    GET    /v1/aggregations/{AggregationId}/snapshots/{SnapshotId}/result/masks/{start}
    GET    /v1/aggregations/{AggregationId}/snapshots/{SnapshotId}/result/clerks/{start}
    GET    /v1/metrics        (additive; unauthenticated Prometheus text)
    GET    /v1/metrics.json   (additive; unauthenticated telemetry snapshot)
    GET    /v1/metrics/history (additive; time-series sampler window)
    GET    /v1/healthz        (additive; liveness — process is serving)
    GET    /v1/readyz         (additive; readiness — store reachable, else 503)

Wire negotiation (docs/protocol.md): the hot bulk routes — the
participation batch POST and the three chunk GETs — speak
``application/x-sda-binary`` (``rest/wire.py``) when the request asks
for it via ``Content-Type`` / ``Accept``; every other request, and every
legacy client, gets the byte-identical JSON bodies as before.

Observability: every request gets a fresh id, echoed as
``X-SDA-Request-Id`` and stamped on 404/500 log lines; an incoming
``X-SDA-Trace`` header is adopted for the handler (and echoed back), so
server-side spans — dispatch, service, store — carry the client's trace
id. Per-route request counts and latencies land in the telemetry
registry under a normalized route template (uuid segments become
``{id}``), with the wire-format split tracked by
``sda_rest_route_seconds{route,wire}`` and payload volume by
``sda_wire_bytes_total{route,wire,direction}``. See docs/observability.md.

Auth: HTTP Basic, username = AgentId, password = token recorded on first
``create_agent`` (trust-on-first-use, lib.rs:298-315). Missing resources are
404 with a ``Resource-not-found: true`` header so clients can distinguish
"no resource" from "no route" (lib.rs:338-343). Errors map to
401 / 403 / 400 / 500 (lib.rs:112-117).

Transport: an asyncio event-loop server speaking HTTP/1.1 with
keep-alive. Idle connections cost a coroutine, not a thread; request *handling* runs on a
bounded executor pool (``SDA_REST_WORKERS``) because the service layer
is synchronous by design. Keep-alive accounting: idle connections are
reaped after ``SDA_REST_IDLE_TIMEOUT_S`` (default 60), and ``shutdown()``
force-closes every live connection so teardown never waits out a
persistent client. The public surface is ThreadingHTTPServer-shaped —
``server_address``, ``serve_forever()``, ``shutdown()``,
``server_close()``.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import json
import logging
import os
import re
import socket
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from http import HTTPStatus
from urllib.parse import unquote_plus

from .. import telemetry
from ..telemetry import timeseries
from ..utils import faults
from . import wire
from ..protocol import (
    Agent,
    AgentId,
    Aggregation,
    AggregationId,
    ClerkingJobId,
    ClerkingResult,
    Committee,
    EncryptionKeyId,
    InvalidCredentialsError,
    InvalidRequestError,
    Labelled,
    Participation,
    PermissionDeniedError,
    Profile,
    Snapshot,
    SnapshotId,
    signed_encryption_key_from_json,
)

log = logging.getLogger("sda.rest.server")

_UUID = r"[0-9a-fA-F-]{36}"

#: request-header section cap per request (stdlib http.server allows 100
#: headers; a byte cap is the same guard in keep-alive-friendly form)
_MAX_HEADER_BYTES = 64 * 1024


def _idle_timeout_s() -> float:
    """How long a keep-alive connection may sit idle between requests
    before the server reaps it (``SDA_REST_IDLE_TIMEOUT_S``, default 60).
    Bounds the connection table against phones that connect once and
    vanish; ``shutdown()`` does not wait for it — live connections are
    force-closed at teardown."""
    return max(0.05, float(os.environ.get("SDA_REST_IDLE_TIMEOUT_S", "60")))


def _slow_request_s() -> float:
    """Latency above which a request earns a warning log line and an
    ``sda_slow_requests_total`` tick (``SDA_SLOW_REQUEST_S``, default 1s;
    0 disables)."""
    try:
        return max(0.0, float(os.environ.get("SDA_SLOW_REQUEST_S", "1.0")))
    except ValueError:
        return 1.0


def _max_inflight() -> int:
    """Admission-control target for concurrently *executing* requests
    (``SDA_REST_MAX_INFLIGHT``). 0 (the default) disables admission
    control entirely — the frontend admits everything."""
    try:
        return max(0, int(os.environ.get("SDA_REST_MAX_INFLIGHT", "0")))
    except ValueError:
        return 0


def _queue_high_water() -> int:
    """Extra admitted-but-queued requests allowed on top of
    ``SDA_REST_MAX_INFLIGHT`` before the frontend starts shedding
    (``SDA_REST_QUEUE_HIGH_WATER``, default 0 = shed as soon as the
    in-flight target is reached). Together the two knobs bound the
    executor backlog: admitted = executing + queued <= max_inflight +
    queue_high_water."""
    try:
        return max(0, int(os.environ.get("SDA_REST_QUEUE_HIGH_WATER", "0")))
    except ValueError:
        return 0


def _retry_after_hint_s() -> float:
    """Retry-After seconds a shed (429) response advertises
    (``SDA_REST_RETRY_AFTER_S``, default 0.25). The client honors it
    as the backoff floor, so a saturated frontend paces its own retry
    storm without the client guessing."""
    try:
        return max(0.0, float(os.environ.get("SDA_REST_RETRY_AFTER_S", "0.25")))
    except ValueError:
        return 0.25


#: routes admission control never sheds: liveness/readiness probes and
#: the metrics planes must answer *especially* when the frontend is
#: saturated — a 429'd readyz would make the balancer drain the node
#: for being busy, and a 429'd scrape would blind the operator to the
#: very saturation being shed
_ADMISSION_EXEMPT = frozenset(
    {
        "/v1/ping",
        "/v1/healthz",
        "/v1/readyz",
        "/v1/metrics",
        "/v1/metrics.json",
        "/v1/metrics/history",
    }
)


def _worker_count() -> int:
    """Executor threads that run the (synchronous) service layer
    (``SDA_REST_WORKERS``). This bounds *active requests*, not open
    connections — thousands of idle keep-alive phones cost coroutines
    only."""
    env = os.environ.get("SDA_REST_WORKERS")
    if env:
        return max(1, int(env))
    return max(8, min(32, (os.cpu_count() or 1) * 4))


class _Response:
    """One fully-assembled HTTP response, plus transport directives:
    ``close`` ends the keep-alive stream after writing, ``truncate``
    (fault injection) declares the full Content-Length but delivers half,
    ``drop`` (fault injection) kills the connection with no bytes at all,
    ``reset`` (fault injection) delivers half the body then aborts the
    transport — the mid-response RST a flaky load balancer produces."""

    __slots__ = ("status", "headers", "body", "close", "truncate", "drop",
                 "reset")

    def __init__(self, status=500, headers=(), body=b"", close=False,
                 truncate=False, drop=False, reset=False):
        self.status = status
        self.headers = list(headers)
        self.body = body
        self.close = close
        self.truncate = truncate
        self.drop = drop
        self.reset = reset


class Router:
    """Transport-independent request handling: routing, auth, fault
    injection, wire negotiation, error mapping, and telemetry. One
    ``handle()`` call maps a fully-read request to a ``_Response`` —
    the asyncio transport below feeds it, and tests can drive it
    directly without a socket."""

    #: request body cap — an authed client must not be able to stream
    #: arbitrary gigabytes into server memory by claiming a huge
    #: Content-Length. Sized ~30x the largest legitimate participation
    #: we target (100K dims x 8 clerks ~= 15 MB of sealed JSON).
    MAX_BODY_BYTES = 512 * 1024 * 1024

    def __init__(self, service):
        self.service = service

    def handle(self, method: str, target: str, headers: dict,
               body: bytes = b"", body_error: str | None = None) -> _Response:
        """Handle one request. ``headers`` is lower-cased-key dict;
        ``body`` is the fully-read request body; ``body_error`` is set by
        the transport when the body could not be framed (bad or oversized
        Content-Length) — the request must then 400 and the connection
        must close, since the stream position is unknowable."""
        if method not in ("GET", "POST", "DELETE"):
            return _Response(501, [], b"Unsupported method", close=False)
        ctx = _RequestContext(self.service, method, target, headers, body, body_error)
        ctx.dispatch()
        return ctx.response


class _RequestContext:
    """Per-request state and the route table (one instance per request)."""

    def __init__(self, service, method, target, headers, body, body_error):
        self.service = service
        self.method = method
        path, _, query = target.partition("?")
        params = {}
        for pair in query.split("&"):
            if "=" in pair:
                k, _, v = pair.partition("=")
                params[k] = unquote_plus(v)
        self.path = path
        self.params = params
        self.headers = headers
        self.body = body
        self.body_error = body_error
        self.request_id = uuid.uuid4().hex[:16]
        self.trace_id = None
        self.status = None
        #: which wire format served this request ("json" unless a binary
        #: frame was read or written) — telemetry label only
        self.wire = "json"
        self._truncate_body = False
        self._reset_body = False
        self._close = False
        self.response = _Response()

    # -- plumbing -----------------------------------------------------------

    def _auth_token(self):
        header = (self.headers.get("authorization") or "").strip()
        if not header.startswith("Basic "):
            raise InvalidCredentialsError("Basic Authorization required")
        try:
            decoded = base64.b64decode(header[len("Basic ") :]).decode("utf-8")
            username, _, password = decoded.partition(":")
            return Labelled(AgentId(username), password)
        except (ValueError, UnicodeDecodeError):
            raise InvalidCredentialsError("Invalid Auth header")

    def _caller(self) -> Agent:
        return self.service.server.check_auth_token(self._auth_token())

    def _read_body(self) -> bytes:
        def refuse(msg):
            # the transport could not (or must not) frame the body, so
            # the unread/unframed bytes would desync the keep-alive
            # stream — drop the connection after responding
            self._close = True
            raise InvalidRequestError(msg)

        if self.body_error:
            refuse(self.body_error)
        if not self.body:
            refuse("Expected a body")
        return self.body

    def _read_json(self):
        try:
            return json.loads(self._read_body())
        except json.JSONDecodeError as e:
            raise InvalidRequestError(f"malformed JSON body: {e}")

    def _read(self, from_json):
        """Read + decode the request body; malformed payloads are 400s
        (the SDA server maps these to 500 via its catch-all)."""
        payload = self._read_json()
        try:
            return from_json(payload)
        except InvalidRequestError:
            raise
        except Exception as e:
            raise InvalidRequestError(f"malformed body: {e}")

    def _send(self, status: int, body: bytes = b"", headers=()):
        self.status = status
        hs = list(headers)
        have_type = any(k.lower() == "content-type" for k, _ in hs)
        if body and not have_type:
            hs.append(("Content-Type", "application/json"))
        if self.request_id:
            hs.append(("X-SDA-Request-Id", self.request_id))
        if self.trace_id:
            hs.append((telemetry.TRACE_HEADER, self.trace_id))
        resp = _Response(status, hs, bytes(body), close=self._close)
        if self._truncate_body and len(body) > 1:
            # injected truncation: the declared length stands, only half
            # the bytes arrive, and the connection dies — the client's
            # content read sees a short body and surfaces a transport
            # error
            resp.truncate = True
            resp.close = True
        if self._reset_body and len(body) > 1:
            # injected mid-body reset: half the bytes then a transport
            # abort — unlike truncate's orderly FIN, the client sees the
            # connection die under it (ConnectionResetError / aborted
            # read) while already consuming the response
            resp.reset = True
            resp.close = True
        self.response = resp

    def _send_json_option(self, obj):
        if obj is None:
            self._send(404, headers=[("Resource-not-found", "true")])
        else:
            payload = obj.to_json() if hasattr(obj, "to_json") else obj
            # compact separators: the SDA server emits serde_json::to_string
            # (no whitespace, server-http/src/lib.rs:338-343)
            self._send(
                200, json.dumps(payload, separators=(",", ":")).encode("utf-8")
            )

    def _send_wire(self, frame: bytes):
        """A negotiated binary response body (one x-sda-binary frame)."""
        self.wire = "binary"
        self._send(200, frame, headers=[("Content-Type", wire.CONTENT_TYPE)])

    def _wants_binary(self) -> bool:
        return wire.accepts_binary(self.headers.get("accept"))

    # -- dispatch -----------------------------------------------------------

    def dispatch(self):
        fault = faults.server_draw()
        if fault is not None:
            if fault.kind == "latency":
                time.sleep(fault.param)  # stall, then handle normally
            elif fault.kind == "drop":
                # connection death without an HTTP response; closing the
                # keep-alive stream keeps the next request in sync
                self.response = _Response(drop=True, close=True)
                return
            elif fault.kind == "e503":
                self._close = True
                self._send(
                    503,
                    b"SDA_FAULTS: injected transient failure",
                    headers=[("Retry-After", f"{fault.param:g}"),
                             ("Content-Type", "text/plain")],
                )
                return
            elif fault.kind == "truncate":
                self._truncate_body = True
            elif fault.kind == "reset":
                self._reset_body = True
        if telemetry.enabled():
            # adopt the client's trace id (or mint one) for this handler;
            # echoed back by _send alongside the request id
            self.trace_id = telemetry.sanitize_trace_id(
                self.headers.get(telemetry.TRACE_HEADER.lower())
            ) or telemetry.new_trace_id()
            telemetry.set_trace_id(self.trace_id)
        t0 = time.perf_counter()
        try:
            with telemetry.span("http.request", method=self.method) as span_record:
                handled = self._dispatch_inner()
                route = re.sub(_UUID, "{id}", self.path) if handled else "<unmatched>"
                if span_record is not None:
                    span_record["attrs"] = {
                        "method": self.method,
                        "route": route,
                        "status": self.status,
                        "request_id": self.request_id,
                    }
            # slow-request visibility is independent of the metrics plane:
            # the warning line fires even with telemetry disabled
            elapsed = time.perf_counter() - t0
            slow_after = _slow_request_s()
            if slow_after and elapsed >= slow_after:
                log.warning(
                    "slow request: %s %s took %.3fs (threshold %.3gs, "
                    "status %s, request %s, trace %s)",
                    self.method, self.path, elapsed, slow_after,
                    self.status, self.request_id, self.trace_id,
                )
                if telemetry.enabled():
                    telemetry.counter(
                        "sda_slow_requests_total",
                        "requests slower than SDA_SLOW_REQUEST_S by route template",
                        route=route,
                    ).inc()
            if telemetry.enabled():
                telemetry.histogram(
                    "sda_http_request_seconds",
                    "REST request latency by route template",
                    method=self.method,
                    route=route,
                ).observe(elapsed)
                telemetry.counter(
                    "sda_http_requests_total",
                    "REST requests served by route template and status",
                    method=self.method,
                    route=route,
                    status=str(self.status or 0),
                ).inc()
                # wire-plane split: route latency by negotiated format,
                # and payload volume in each direction (docs/observability.md)
                telemetry.histogram(
                    "sda_rest_route_seconds",
                    "REST route latency by route template and wire format",
                    route=route,
                    wire=self.wire,
                ).observe(elapsed)
                telemetry.counter(
                    "sda_wire_bytes_total",
                    "REST payload bytes by route, wire format, and direction",
                    route=route,
                    wire=self.wire,
                    direction="in",
                ).inc(len(self.body or b""))
                telemetry.counter(
                    "sda_wire_bytes_total",
                    "REST payload bytes by route, wire format, and direction",
                    route=route,
                    wire=self.wire,
                    direction="out",
                ).inc(len(self.response.body))
        finally:
            if self.trace_id is not None:
                telemetry.set_trace_id(None)

    def _dispatch_inner(self) -> bool:
        """Route + error mapping; returns whether the path was routed."""
        try:
            if self.body_error:
                # unframeable body (bad/oversized Content-Length): the
                # stream position is unknowable, so 400 and close no
                # matter which route was asked for
                self._close = True
                raise InvalidRequestError(self.body_error)
            handled = self._route()
            if not handled:
                log.error(
                    "route not found: %s %s (request %s)",
                    self.method, self.path, self.request_id,
                )
                self._send(404)
            return handled
        except InvalidCredentialsError as e:
            self._send(401, str(e).encode())
        except PermissionDeniedError as e:
            self._send(403, str(e).encode())
        except InvalidRequestError as e:
            self._send(400, str(e).encode())
        except Exception as e:  # ServerError and unexpected -> 500
            log.error(
                "%s %s -> 500: %s (request %s)",
                self.method, self.path, e, self.request_id,
            )
            self._send(500, str(e).encode())
        return True  # an error from a handler still means the path routed

    # -- routes -------------------------------------------------------------

    def _route(self) -> bool:
        method, path, params = self.method, self.path, self.params
        m = lambda pat: re.fullmatch(pat, path)
        svc = self.service

        if method == "GET" and path == "/v1/ping":
            self._send_json_option(svc.ping())
            return True

        if method == "GET" and path == "/v1/metrics":
            # additive observability route (not in the reference protocol):
            # Prometheus text exposition, unauthenticated like /v1/ping —
            # aggregate series only, no resource data (docs/observability.md)
            body = telemetry.prometheus_text().encode("utf-8")
            self._send(
                200,
                body,
                headers=[("Content-Type", telemetry.PROMETHEUS_CONTENT_TYPE)],
            )
            return True

        if method == "GET" and path == "/v1/metrics.json":
            # the same registry as JSON (plus recent spans), for tooling
            # that wants telemetry.snapshot() without Prometheus parsing
            body = json.dumps(
                telemetry.snapshot(), separators=(",", ":"), default=repr
            ).encode("utf-8")
            self._send(200, body)
            return True

        if method == "GET" and path == "/v1/metrics/history":
            # the time-series sampler's in-memory window (docs/api.md):
            # unauthenticated like /v1/metrics — windowed rates/quantiles
            # only, no resource data. ?n= caps the returned samples.
            n = None
            raw_n = params.get("n")
            if raw_n:
                try:
                    n = int(raw_n)
                except ValueError:
                    raise InvalidRequestError("n must be a positive integer")
                if n <= 0:
                    raise InvalidRequestError("n must be a positive integer")
            body = json.dumps(
                timeseries.history(n), separators=(",", ":")
            ).encode("utf-8")
            self._send(200, body)
            return True

        if method == "GET" and path == "/v1/healthz":
            # liveness: the process is up and serving requests
            self._send(200, b'{"status":"ok"}')
            return True

        if method == "GET" and path == "/v1/readyz":
            # readiness: the service can actually reach its store; a
            # wedged backend answers 503 so a balancer drains this node
            try:
                svc.ping()
                self._send(200, b'{"status":"ready"}')
            except Exception as e:
                self._send(
                    503,
                    json.dumps(
                        {"status": "unready", "error": str(e)},
                        separators=(",", ":"),
                    ).encode("utf-8"),
                )
            return True

        if method == "POST" and path == "/v1/agents/me":
            # TOFU: token recorded on successful agent creation (lib.rs:192-201)
            token = self._auth_token()
            agent = self._read(Agent.from_json)
            if agent.id != token.id:
                self._send(400, b"inconsistent agent ids")
                return True
            svc.server.register_auth_token(token)
            svc.create_agent(agent, agent)
            self._send(201)
            return True

        if method == "GET" and (match := m(rf"/v1/agents/({_UUID})")):
            self._send_json_option(svc.get_agent(self._caller(), AgentId(match.group(1))))
            return True

        if method == "GET" and (match := m(rf"/v1/agents/({_UUID})/profile")):
            self._send_json_option(svc.get_profile(self._caller(), AgentId(match.group(1))))
            return True

        if method == "POST" and path == "/v1/agents/me/profile":
            svc.upsert_profile(self._caller(), self._read(Profile.from_json))
            self._send(201)
            return True

        if method == "GET" and (match := m(rf"/v1/agents/any/keys/({_UUID})")):
            self._send_json_option(
                svc.get_encryption_key(self._caller(), EncryptionKeyId(match.group(1)))
            )
            return True

        if method == "POST" and path == "/v1/agents/me/keys":
            svc.create_encryption_key(
                self._caller(), self._read(signed_encryption_key_from_json)
            )
            self._send(201)
            return True

        if method == "POST" and path == "/v1/aggregations":
            svc.create_aggregation(self._caller(), self._read(Aggregation.from_json))
            self._send(201)
            return True

        if method == "GET" and path == "/v1/aggregations":
            recipient = params.get("recipient")
            ids = svc.list_aggregations(
                self._caller(),
                params.get("title"),
                AgentId(recipient) if recipient else None,
            )
            self._send_json_option([str(i) for i in ids])
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/committee/suggestions")):
            out = svc.suggest_committee(self._caller(), AggregationId(match.group(1)))
            self._send_json_option([c.to_json() for c in out])
            return True

        if method == "POST" and path == "/v1/aggregations/implied/committee":
            svc.create_committee(self._caller(), self._read(Committee.from_json))
            self._send(201)
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/committee")):
            self._send_json_option(
                svc.get_committee(self._caller(), AggregationId(match.group(1)))
            )
            return True

        if method == "POST" and path == "/v1/aggregations/participations":
            svc.create_participation(
                self._caller(), self._read(Participation.from_json)
            )
            self._send(201)
            return True

        if method == "POST" and path == "/v1/aggregations/participations/batch":
            # batched ingest (additive route, not in the reference): one
            # auth check, one response, one store transaction for the
            # whole batch. Two negotiated body formats: the legacy JSON
            # array, or one binary frame of varint-framed columns
            # (Content-Type: application/x-sda-binary, rest/wire.py) that
            # skips base64 + per-field JSON entirely. The service layer
            # accepts or rejects the array atomically either way.
            if wire.is_binary(self.headers.get("content-type")):
                self.wire = "binary"
                raw = self._read_body()
                try:
                    participations = wire.decode_participations(raw)
                except wire.WireError as e:
                    raise InvalidRequestError(f"malformed binary body: {e}")
            else:
                payload = self._read_json()
                if not isinstance(payload, list):
                    raise InvalidRequestError("expected a JSON array of participations")
                try:
                    participations = [Participation.from_json(p) for p in payload]
                except Exception as e:
                    raise InvalidRequestError(f"malformed body: {e}")
            svc.create_participations(self._caller(), participations)
            self._send(201)
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/status")):
            self._send_json_option(
                svc.get_aggregation_status(self._caller(), AggregationId(match.group(1)))
            )
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})/tiers")):
            # per-node readiness of a tiered aggregation's derived tree
            # (recipient-only by ACL); 404 for flat aggregations
            self._send_json_option(
                svc.get_tier_status(self._caller(), AggregationId(match.group(1)))
            )
            return True

        if method == "POST" and path == "/v1/aggregations/implied/snapshot":
            svc.create_snapshot(self._caller(), self._read(Snapshot.from_json))
            self._send(201)
            return True

        if method == "GET" and path == "/v1/aggregations/any/jobs":
            caller = self._caller()
            self._send_json_option(svc.get_clerking_job(caller, caller.id))
            return True

        if method == "GET" and (
            match := m(rf"/v1/aggregations/implied/jobs/({_UUID})/chunks/(\d+)")
        ):
            # one ciphertext range of a paged clerking job; the clerk is
            # implied by auth (chunk reads answer 404 unless the caller
            # owns the job). Response: bare JSON array of encryptions, or
            # one binary encryption column when the request Accepts it.
            chunk = svc.get_clerking_job_chunk(
                self._caller(), ClerkingJobId(match.group(1)), int(match.group(2))
            )
            if chunk is not None and self._wants_binary():
                self._send_wire(wire.encode_encryptions(chunk))
            else:
                self._send_json_option(
                    None if chunk is None else [e.to_json() for e in chunk]
                )
            return True

        if method == "POST" and (match := m(rf"/v1/aggregations/implied/jobs/({_UUID})/result")):
            result = self._read(ClerkingResult.from_json)
            # the route is job-scoped: a body naming a DIFFERENT job
            # would silently file the result under the body's job while
            # every URL-derived check looked at the route's — reject the
            # mismatch instead of trusting whichever id the caller likes
            # (the SDA server marks the equivalent hole "FIXME no job
            # spoofing", server.rs:351)
            if str(result.job) != match.group(1):
                raise InvalidRequestError(
                    f"result body names job {result.job}, "
                    f"route names {match.group(1)}"
                )
            svc.create_clerking_result(self._caller(), result)
            self._send(201)
            return True

        if method == "POST" and (
            match := m(rf"/v1/aggregations/implied/jobs/({_UUID})/complete")
        ):
            # resultless retirement (tier share-promotion): the clerk's
            # output went upward as tagged participations, so the job is
            # marked done with nothing to file. Bodyless + idempotent.
            svc.complete_clerking_job(self._caller(), ClerkingJobId(match.group(1)))
            self._send(201)
            return True

        if method == "GET" and (
            match := m(rf"/v1/aggregations/({_UUID})/snapshots/({_UUID})/result/masks/(\d+)")
        ):
            # one recipient-mask-encryption range of a paged snapshot
            # result (recipient-only by ACL). Response: bare JSON array,
            # or one binary encryption column when negotiated.
            chunk = svc.get_snapshot_result_masks(
                self._caller(),
                AggregationId(match.group(1)),
                SnapshotId(match.group(2)),
                int(match.group(3)),
            )
            if chunk is not None and self._wants_binary():
                self._send_wire(wire.encode_encryptions(chunk))
            else:
                self._send_json_option(
                    None if chunk is None else [e.to_json() for e in chunk]
                )
            return True

        if method == "GET" and (
            match := m(rf"/v1/aggregations/({_UUID})/snapshots/({_UUID})/result/clerks/(\d+)")
        ):
            # one clerk-result range, in the canonical job-id order
            chunk = svc.get_snapshot_result_clerks(
                self._caller(),
                AggregationId(match.group(1)),
                SnapshotId(match.group(2)),
                int(match.group(3)),
            )
            if chunk is not None and self._wants_binary():
                self._send_wire(wire.encode_clerking_results(chunk))
            else:
                self._send_json_option(
                    None if chunk is None else [c.to_json() for c in chunk]
                )
            return True

        if method == "GET" and (
            match := m(rf"/v1/aggregations/({_UUID})/snapshots/({_UUID})/result")
        ):
            self._send_json_option(
                svc.get_snapshot_result(
                    self._caller(), AggregationId(match.group(1)), SnapshotId(match.group(2))
                )
            )
            return True

        if method == "GET" and (match := m(rf"/v1/aggregations/({_UUID})")):
            self._send_json_option(
                svc.get_aggregation(self._caller(), AggregationId(match.group(1)))
            )
            return True

        if method == "DELETE" and (match := m(rf"/v1/aggregations/({_UUID})")):
            svc.delete_aggregation(self._caller(), AggregationId(match.group(1)))
            self._send(200)
            return True

        return False


# -- transport --------------------------------------------------------------


class SdaRestServer:
    """Asyncio HTTP/1.1 keep-alive server around a ``Router``.

    Mirrors the stdlib server surface the rest of the codebase already
    uses: bind in the constructor (so ``server_address`` is final
    immediately, port 0 included), ``serve_forever()`` blocks the calling
    thread, ``shutdown()`` from any other thread stops it and returns
    once the loop has exited, ``server_close()`` releases the socket.
    """

    def __init__(self, addr: tuple, service):
        self.router = Router(service)
        self._sock = socket.create_server(addr, backlog=128)
        self.server_address = self._sock.getsockname()
        self._loop = None
        self._stop_event = None  # asyncio.Event, created on the loop
        self._started = threading.Event()
        self._stopped = threading.Event()
        self._shutdown_requested = threading.Event()
        self._executor = None
        self._writers = set()
        self._conn_tasks = set()
        #: requests admitted to the executor (executing + queued); only
        #: touched on the event loop, so a plain int is race-free
        self._inflight = 0

    # -- lifecycle ----------------------------------------------------------

    def serve_forever(self) -> None:
        if self._shutdown_requested.is_set():
            self._stopped.set()
            return
        self._executor = ThreadPoolExecutor(
            max_workers=_worker_count(), thread_name_prefix="sda-rest"
        )
        # the time-series sampler rides the server lifecycle (refcounted:
        # N in-process servers share one thread); SDA_TS=0 opts out
        sampler_held = os.environ.get("SDA_TS", "1") != "0"
        if sampler_held:
            timeseries.acquire()
        try:
            asyncio.run(self._main())
        finally:
            self._started.set()  # unblock shutdown() even on startup failure
            self._stopped.set()
            self._executor.shutdown(wait=False)
            if sampler_held:
                timeseries.release()

    async def _main(self):
        self._loop = asyncio.get_running_loop()
        self._stop_event = asyncio.Event()
        # the default 64 KiB StreamReader buffer makes readexactly() of a
        # multi-hundred-KB binary batch wake up dozens of times; a 1 MiB
        # limit lets typical hot-route bodies arrive in a few reads
        server = await asyncio.start_server(
            self._handle_connection, sock=self._sock, limit=1 << 20
        )
        self._started.set()
        if self._shutdown_requested.is_set():
            self._stop_event.set()
        try:
            await self._stop_event.wait()
        finally:
            server.close()
            # keep-alive accounting: force-close every live connection so
            # teardown is prompt no matter how many phones are parked on
            # open sockets (they reconnect-and-retry by contract)
            for writer in list(self._writers):
                with contextlib.suppress(Exception):
                    writer.close()
            with contextlib.suppress(Exception):
                await server.wait_closed()
            pending = [t for t in self._conn_tasks if not t.done()]
            if pending:
                await asyncio.wait(pending, timeout=5)

    def shutdown(self) -> None:
        """Stop ``serve_forever`` (thread-safe) and wait for it to exit,
        closing live keep-alive connections rather than waiting them out."""
        self._shutdown_requested.set()
        if not self._started.wait(timeout=1):
            return  # never started serving; nothing to unwind
        if self._loop is not None and self._stop_event is not None:
            with contextlib.suppress(RuntimeError):
                self._loop.call_soon_threadsafe(self._stop_event.set)
        self._stopped.wait(timeout=10)

    def server_close(self) -> None:
        with contextlib.suppress(OSError):
            self._sock.close()
        if self._executor is not None:
            self._executor.shutdown(wait=False)

    # -- connection handling ------------------------------------------------

    async def _handle_connection(self, reader, writer):
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self._writers.add(writer)
        try:
            await self._serve_connection(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError,
                TimeoutError, BrokenPipeError):
            pass  # peer went away mid-request; nothing to answer
        except Exception:
            log.exception("connection handler failed")
        finally:
            self._writers.discard(writer)
            self._conn_tasks.discard(task)
            with contextlib.suppress(Exception):
                writer.close()

    async def _serve_connection(self, reader, writer):
        idle = _idle_timeout_s()
        loop = asyncio.get_running_loop()
        while True:
            try:
                line = await asyncio.wait_for(reader.readline(), timeout=idle)
            except (asyncio.TimeoutError, TimeoutError):
                return  # idle keep-alive connection expired
            if not line:
                return  # clean EOF between requests
            if line in (b"\r\n", b"\n"):
                continue  # stray CRLF between requests (RFC 7230 §3.5)
            try:
                parts = line.decode("latin-1").strip().split()
                method, target = parts[0], parts[1]
                version = parts[2] if len(parts) > 2 else "HTTP/1.0"
            except (IndexError, UnicodeDecodeError):
                await self._write_response(
                    writer, _Response(400, [], b"malformed request line", close=True)
                )
                return

            headers = {}
            header_bytes = 0
            overflow = False
            while True:
                hline = await asyncio.wait_for(reader.readline(), timeout=idle)
                if hline in (b"\r\n", b"\n", b""):
                    break
                header_bytes += len(hline)
                if header_bytes > _MAX_HEADER_BYTES:
                    overflow = True
                    continue  # keep draining to the blank line, then reject
                key, sep, value = hline.decode("latin-1").partition(":")
                if sep:
                    headers[key.strip().lower()] = value.strip()
            if overflow:
                await self._write_response(
                    writer,
                    _Response(431, [], b"request header section too large", close=True),
                )
                return

            body = b""
            body_error = None
            raw_length = headers.get("content-length")
            if headers.get("transfer-encoding"):
                # no SDA client chunks uploads; without a Content-Length
                # the stream cannot be reframed, so reject and close
                body_error = "chunked request bodies are not supported"
            elif raw_length is not None:
                try:
                    length = int(raw_length)
                except ValueError:
                    length = None
                if length is None:
                    body_error = "invalid Content-Length"
                elif length > Router.MAX_BODY_BYTES:
                    body_error = (
                        f"body exceeds the {Router.MAX_BODY_BYTES}-byte limit"
                    )
                elif length > 0:
                    if headers.get("expect", "").lower() == "100-continue":
                        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    body = await asyncio.wait_for(
                        reader.readexactly(length), timeout=idle
                    )

            response = await self._dispatch(loop, method, target, headers,
                                            body, body_error)
            if response.drop:
                return  # injected connection death: no bytes at all
            if version != "HTTP/1.1" or headers.get("connection", "").lower() == "close":
                response.close = True
            await self._write_response(writer, response)
            if response.close:
                return

    async def _dispatch(self, loop, method, target, headers, body, body_error):
        """Admission control, then the executor. The body is already
        fully read, so shedding answers without consuming a worker
        thread — and the keep-alive stream stays in sync either way."""
        max_inflight = _max_inflight()
        if max_inflight:
            path = target.partition("?")[0]
            if (
                self._inflight >= max_inflight + _queue_high_water()
                and path not in _ADMISSION_EXEMPT
            ):
                return self._shed(method, path)
        self._inflight += 1
        try:
            return await loop.run_in_executor(
                self._executor, self.router.handle,
                method, target, headers, body, body_error,
            )
        finally:
            self._inflight -= 1

    def _shed(self, method: str, path: str) -> _Response:
        route = re.sub(_UUID, "{id}", path)
        if telemetry.enabled():
            telemetry.counter(
                "sda_rest_shed_total",
                "requests shed with 429 by admission control, by route template",
                route=route,
            ).inc()
        log.debug(
            "shedding %s %s: %d in flight (max %d + queue %d)",
            method, path, self._inflight, _max_inflight(), _queue_high_water(),
        )
        return _Response(
            429,
            [
                ("Retry-After", f"{_retry_after_hint_s():g}"),
                ("Content-Type", "text/plain"),
            ],
            b"server saturated; retry later",
        )

    @staticmethod
    async def _write_response(writer, response: _Response):
        body = response.body
        try:
            reason = HTTPStatus(response.status).phrase
        except ValueError:
            reason = ""
        head = [f"HTTP/1.1 {response.status} {reason}".rstrip()]
        for k, v in response.headers:
            head.append(f"{k}: {v}")
        head.append(f"Content-Length: {len(body)}")
        if response.close:
            head.append("Connection: close")
        payload = ("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
        if (response.truncate or response.reset) and len(body) > 1:
            payload += body[: len(body) // 2]
            response.close = True
        else:
            payload += body
        writer.write(payload)
        await writer.drain()
        if response.reset and len(body) > 1:
            # slam the connection mid-body: abort discards the FIN
            # handshake, so the peer's read fails hard instead of seeing
            # a short-but-orderly body
            writer.transport.abort()


# -- module API --------------------------------------------------------------


def make_handler(service):
    """The reference's compatibility name from its ThreadingHTTPServer era:
    the 'handler' for a service is its transport-independent ``Router``."""
    return Router(service)


def listen(addr: tuple, service) -> SdaRestServer:
    """Create (but do not start) an HTTP server bound to addr."""
    return SdaRestServer(addr, service)


def serve_forever(addr: tuple, service) -> None:
    httpd = listen(addr, service)
    log.info("sda REST server listening on %s:%s", *httpd.server_address[:2])
    httpd.serve_forever()


@contextlib.contextmanager
def serve_background(service, host: str = "127.0.0.1", port: int = 0):
    """Run the REST server on a daemon thread; yields the base URL."""
    httpd = listen((host, port), service)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://{httpd.server_address[0]}:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=5)


@contextlib.contextmanager
def serve_background_multi(service, frontends: int, host: str = "127.0.0.1"):
    """Run ``frontends`` REST servers over one (typically sharded)
    service, each on its own daemon thread and kernel-assigned port;
    yields the list of base URLs in frontend order — the order the
    client-side router's hash ring indexes into. In-process frontends
    share the GIL, so this is the *coordination* shape (routing,
    failover, admission control) rather than a CPU-scaling one."""
    httpds = [listen((host, 0), service) for _ in range(frontends)]
    threads = [
        threading.Thread(target=h.serve_forever, daemon=True) for h in httpds
    ]
    for t in threads:
        t.start()
    try:
        yield [f"http://{h.server_address[0]}:{h.server_address[1]}" for h in httpds]
    finally:
        for h in httpds:
            h.shutdown()
            h.server_close()
        for t in threads:
            t.join(timeout=5)
