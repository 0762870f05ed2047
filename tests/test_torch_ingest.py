"""The port's arrival-driven ingest (``sda_tpu_torch/client/ingest.py``),
its arrival traces (``utils/arrivals.py``) and the batched participant
path (``participate_many``, ``new_participations(cache=)``) against
``sda_tpu``.

The traces are pure functions of (spec, seed, index): ``parse_trace``
accepts and refuses the same specs with the same messages, and
``ArrivalTrace`` gives the same floats bit for bit (``float.hex``) for
gaps, rates, burst slots and churn flags; ``plan_arrivals`` leaves the
same cursor and schedule. Then the port's cases of the reference's
``tests/test_ingest_pipeline.py`` and ``tests/test_batch_ingest.py:167``:
a pipelined cohort and the serial loop reveal the same sum as the
reference's pipelined cohort on the same trace (in process and over
loopback HTTP, additive and packed Shamir), no live row leaves before its
arrival minus the slack and churned rows upload last, the backlog stays
under its bound under a burst, a faulted round drains exactly, and
``participate_many`` lands every row once and stops submitting after a
failed chunk.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

import sda_tpu.protocol as jp
import sda_tpu.rest as jrest
import sda_tpu_torch.protocol as tp
import sda_tpu_torch.rest as trest
from sda_tpu.client import SdaClient as JClient
from sda_tpu.client import ingest as jingest
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.server import new_mem_server as j_server
from sda_tpu.utils import arrivals as jarrivals
from sda_tpu_torch import telemetry
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.client import ingest
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.server import new_mem_server as t_server
from sda_tpu_torch.utils import arrivals

# -- traces and plans -----------------------------------------------------------

SPECS = [
    "base=20", "base=50,diurnal=0.8@30,burst=0.1@8:42", "base=10,churn=0.25:7",
    " base=0.5, diurnal=0.6@20, burst=0.15@4, churn=0.25:16 ", "base=3,diurnal=1:-5",
    "base=1,burst=1", "base=2,,churn=0", "",
    "burst=0.1", "base=0", "base=-1", "base=x", "base=1,diurnal=1.5", "base=1,diurnal=0.5@0",
    "base=1,burst=2", "base=1,burst=0.5@0.5", "base=1,churn=-0.1", "base=1,tide=2",
    "base=1,diurnal", "base=1:seven", "base=1:2:3",
]


@pytest.mark.parametrize("text", SPECS)
def test_parse_trace_accepts_and_refuses_like_the_reference(text):
    outcomes = []
    for module in (arrivals, jarrivals):
        try:
            outcomes.append(repr(vars(module.parse_trace(text))))
        except ValueError as e:
            outcomes.append(f"ValueError: {e}")
    assert outcomes[0] == outcomes[1]


TRACES = ["base=0.5,diurnal=0.6@20,burst=0.15@4,churn=0.25:16", "base=400,churn=0.25:13",
          "base=30,burst=0.3@8,churn=0.1:9", "base=7,diurnal=1@3:123456789"]


@pytest.mark.parametrize("text", TRACES)
def test_trace_draws_are_bit_equal(text):
    ours, theirs = arrivals.ArrivalTrace.from_text(text), jarrivals.ArrivalTrace.from_text(text)
    assert [t.hex() for t in ours.times(64)] == [t.hex() for t in theirs.times(64)]
    assert [t.hex() for t in ours.times(8, start=3.25)] == [t.hex() for t in theirs.times(8, 3.25)]
    probes = [0.0, 0.3, 1.0, 2.5, 7.75, 19.99, 33.0]
    assert [ours.rate_at(t).hex() for t in probes] == [theirs.rate_at(t).hex() for t in probes]
    assert [ours.is_burst_slot(s) for s in range(100)] == [theirs.is_burst_slot(s)
                                                         for s in range(100)]
    assert [ours.is_churned(k) for k in range(100)] == [theirs.is_churned(k) for k in range(100)]


def test_the_ingest_rounds_trace_matches_its_description():
    """The trace the card's ingest round uses: 16 arrivals over ~26.9 s,
    indexes 0, 7 and 15 churned, seven burst slots inside the trace."""
    trace = arrivals.ArrivalTrace.from_text("base=0.5,diurnal=0.6@20,burst=0.15@4,churn=0.25:16")
    times = trace.times(16)
    assert 26.0 < times[-1] < 28.0
    assert [k for k in range(16) if trace.is_churned(k)] == [0, 7, 15]
    assert sum(trace.is_burst_slot(s) for s in range(int(times[-1]) + 1)) == 7


@pytest.mark.parametrize("start", [{"index": 0, "t": 0.0}, {"index": 5, "t": 2.5, "t0": 11.0}])
def test_plan_arrivals_leaves_equal_cursors(start):
    trace_text = "base=30,burst=0.3@8,churn=0.1:9"
    cursors, plans = [], []
    for module, trace_mod in ((ingest, arrivals), (jingest, jarrivals)):
        cursor = dict(start)
        plan = module.plan_arrivals(trace_mod.ArrivalTrace.from_text(trace_text), cursor, 25)
        plan += module.plan_arrivals(trace_mod.ArrivalTrace.from_text(trace_text), cursor, 5)
        cursors.append({k: (v.hex() if isinstance(v, float) else v) for k, v in cursor.items()})
        plans.append([(e.slot, e.index, e.at.hex(), e.churned) for e in plan])
    assert cursors[0] == cursors[1]
    assert plans[0] == plans[1]


@pytest.mark.parametrize("knob,raw", [
    ("SDA_INGEST_PIPELINE", None), ("SDA_INGEST_PIPELINE", "0"), ("SDA_INGEST_PIPELINE", "1"),
    ("SDA_INGEST_PIPELINE", "no"), ("SDA_ARRIVAL_SLACK_S", None), ("SDA_ARRIVAL_SLACK_S", " "),
    ("SDA_ARRIVAL_SLACK_S", "0.2"), ("SDA_ARRIVAL_SLACK_S", "-1"), ("SDA_ARRIVAL_SLACK_S", "soon"),
])
def test_knobs_parse_like_the_reference(monkeypatch, knob, raw):
    if raw is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, raw)
    outcomes = []
    for module in (ingest, jingest):
        read = module.pipeline_enabled if knob == "SDA_INGEST_PIPELINE" else module.arrival_slack_s
        try:
            outcomes.append(read())
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


# -- cohorts through the service --------------------------------------------------

P, DIM = 433, 4
PORT = {"proto": tp, "client": TClient, "keystore": TKeystore, "server": t_server,
        "rest": trest, "ingest": ingest, "arrivals": arrivals}
REFERENCE = {"proto": jp, "client": JClient, "keystore": JKeystore, "server": j_server,
             "rest": jrest, "ingest": jingest, "arrivals": jarrivals}
SCHEMES = {
    "additive": lambda pr: pr.AdditiveSharing(share_count=3, modulus=P),
    "packed": lambda pr: pr.PackedShamirSharing(3, 8, 4, P, 354, 150),
}


class _Cohort:
    """A recipient, its committee (chosen explicitly) and ``phones``
    participant identities of ``pkg``, every member on ``service_for``."""

    def __init__(self, pkg, root, service_for, scheme, phones):
        self.pkg, self.root, self.service_for = pkg, root, service_for
        self.proto = pkg["proto"]
        self.scheme = SCHEMES[scheme](self.proto)
        self.recipient = self.member("recipient")
        self.recipient.upload_agent()
        self.rkey = self.recipient.new_encryption_key()
        self.recipient.upload_encryption_key(self.rkey)
        self.clerks = [self.member(f"clerk{i}") for i in range(self.scheme.output_size)]
        for clerk in self.clerks:
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key())
        self.phones = [self.member(f"phone{i}") for i in range(phones)]
        for phone in self.phones:
            phone.upload_agent()

    def member(self, name):
        keystore = self.pkg["keystore"](self.root / name)
        agent = self.pkg["client"].new_agent(keystore)
        if self.pkg is PORT:
            return TClient(agent, keystore, self.service_for(name), device="cpu")
        return JClient(agent, keystore, self.service_for(name))

    def aggregation(self, title):
        proto = self.proto
        agg = proto.Aggregation(
            id=proto.AggregationId.random(), title=title, vector_dimension=DIM, modulus=P,
            recipient=self.recipient.agent.id, recipient_key=self.rkey,
            masking_scheme=proto.NoMasking(), committee_sharing_scheme=self.scheme,
            recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
            committee_encryption_scheme=proto.SodiumEncryptionScheme())
        self.recipient.upload_aggregation(agg)
        self.recipient.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in self.clerks])
        return agg

    def reveal(self, agg):
        self.recipient.end_aggregation(agg.id)
        for clerk in self.clerks:
            clerk.run_chores(-1)
        return np.asarray(list(self.recipient.reveal_aggregation(agg.id).positive().values))

    def count(self, agg):
        return self.recipient.service.get_aggregation_status(
            self.recipient.agent, agg.id).number_of_participations


def _serial_leg(phones, values, agg, trace, cursor):
    """The serial arrivals loop: sleep to each arrival, build a batch of
    one, POST it alone; churned phones deferred to the round's end."""
    deferred = []
    for i, v in enumerate(values):
        k = cursor["index"]
        cursor["index"] = k + 1
        cursor["t"] = trace.next_arrival(k, cursor["t"])
        delay = cursor["t0"] + cursor["t"] - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        p = phones[i % len(phones)]
        part = p.new_participations([v], agg.id)[0]
        if trace.is_churned(k):
            deferred.append((p, part))
            continue
        p.upload_participation(part)
    for p, part in deferred:
        p.upload_participation(part)
    return len(deferred)


def _with_service(pkg, binding, root, body):
    if binding == "rest":
        with pkg["rest"].serve_background(pkg["server"]()) as url:
            return body(lambda name: pkg["rest"].SdaHttpClient(url, pkg["rest"].TokenStore(root
                                                                                        / name)))
    server = pkg["server"]()
    return body(lambda name: server)


@pytest.mark.parametrize("binding", ["mem", "rest"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_pipelined_and_serial_reveal_the_references_sum(tmp_path, binding, scheme):
    values = [[i % 7, (i + 1) % 5, 1, i % 3] for i in range(12)]
    trace_text = "base=400,churn=0.25:13"
    want = [sum(v[d] for v in values) % P for d in range(DIM)]
    legs = {}

    def port_round(service_for):
        cohort = _Cohort(PORT, tmp_path / "port", service_for, scheme, 3)
        trace = arrivals.ArrivalTrace.from_text(trace_text)
        for leg in ("serial", "pipelined"):
            agg = cohort.aggregation(f"ingest-{leg}")
            cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
            if leg == "serial":
                churned = _serial_leg(cohort.phones, values, agg, trace, cursor)
            else:
                report = ingest.ingest_cohort(cohort.phones, values, agg.id, trace=trace,
                                              cursor=cursor, window=4)
                assert report.rows == len(values) and report.windows == 3
                churned = report.churned
            legs[leg] = (churned, cohort.reveal(agg))

    def reference_round(service_for):
        cohort = _Cohort(REFERENCE, tmp_path / "reference", service_for, scheme, 3)
        agg = cohort.aggregation("ingest-reference")
        cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
        report = jingest.ingest_cohort(cohort.phones, values, agg.id,
                                       trace=jarrivals.ArrivalTrace.from_text(trace_text),
                                       cursor=cursor, window=4)
        legs["reference"] = (report.churned, cohort.reveal(agg))

    _with_service(PORT, binding, tmp_path / "port", port_round)
    _with_service(REFERENCE, binding, tmp_path / "reference", reference_round)
    churns = {leg: churned for leg, (churned, _) in legs.items()}
    assert churns["serial"] == churns["pipelined"] == churns["reference"] > 0
    outs = [out for _, out in legs.values()]
    assert outs[0].tobytes() == outs[1].tobytes() == outs[2].tobytes()
    np.testing.assert_array_equal(outs[0], want)


def test_trace_fidelity(tmp_path):
    """No live row reaches the service before its arrival minus the slack,
    batches are churn-homogeneous, and every churned row uploads after
    every live row; the report's counts match the schedule, and the three
    series are exported."""
    slack, n, window = 0.02, 20, 4
    trace = arrivals.ArrivalTrace.from_text("base=40,churn=0.2:5")
    schedule = ingest.plan_arrivals(trace, {"index": 0, "t": 0.0}, n)
    assert any(e.churned for e in schedule) and any(not e.churned for e in schedule)
    telemetry.set_enabled(True)
    telemetry.reset()
    server = t_server()
    cohort = _Cohort(PORT, tmp_path, lambda name: server, "additive", 2)
    agg = cohort.aggregation("fidelity")
    id_to_slot, uploads = {}, []
    for p in cohort.phones:
        def record_build(vals, agg_id, _orig=p.new_participations, **kw):
            parts = _orig(vals, agg_id, **kw)
            for v, part in zip(vals, parts):
                id_to_slot[part.id] = v[0]
            return parts

        def record_upload(parts, _orig=p.upload_participations):
            uploads.append((time.perf_counter(), [id_to_slot[part.id] for part in parts]))
            return _orig(parts)

        p.new_participations = record_build
        p.upload_participations = record_upload
    values = [[i, 0, 1, 0] for i in range(n)]
    cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
    report = ingest.ingest_cohort(cohort.phones, values, agg.id, trace=trace, cursor=cursor,
                                  window=window, slack_s=slack)
    assert sorted(s for _, slots in uploads for s in slots) == list(range(n))
    assert report.churned == sum(e.churned for e in schedule)
    assert report.deferred_batches == len({s % 2 for s in range(n) if schedule[s].churned})
    churned_batches, last_live = [], -1
    for ix, (t, slots) in enumerate(uploads):
        flags = {schedule[s].churned for s in slots}
        assert len(flags) == 1, "a batch mixed live and churned rows"
        if flags == {True}:
            churned_batches.append(ix)
            continue
        last_live = ix
        for s in slots:
            assert t >= cursor["t0"] + schedule[s].at - slack - 1e-9
    assert churned_batches and min(churned_batches) > last_live
    assert report.max_backlog_seen <= 4 * window
    np.testing.assert_array_equal(cohort.reveal(agg),
                                  [sum(v[d] for v in values) % P for d in range(DIM)])
    text = telemetry.prometheus_text()
    for series in ("sda_ingest_stage_seconds", "sda_arrival_lag_seconds", "sda_ingest_backlog"):
        assert series in text


def test_bounded_backlog_under_burst(tmp_path):
    server = t_server()
    cohort = _Cohort(PORT, tmp_path, lambda name: server, "additive", 3)
    agg = cohort.aggregation("burst")
    values = [[i % 7, (i + 2) % 5, 1, 0] for i in range(30)]
    trace = arrivals.ArrivalTrace.from_text("base=30,burst=0.3@8,churn=0.1:9")
    cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
    report = ingest.ingest_cohort(cohort.phones, values, agg.id, trace=trace, cursor=cursor,
                                  window=4, max_backlog=8)
    assert report.max_backlog_seen <= 8
    assert report.windows == 8
    assert report.rows == 30 and cohort.count(agg) == 30
    np.testing.assert_array_equal(cohort.reveal(agg),
                                  [sum(v[d] for v in values) % P for d in range(DIM)])


def test_faulted_round_drains(tmp_path, monkeypatch):
    """A 15 % drop/e503 mix during the pipelined cohort over HTTP: every
    micro-batch lands once through the retries (batch replay is
    idempotent), and the reveal is exact."""
    monkeypatch.setenv("SDA_REST_RETRIES", "8")
    monkeypatch.setenv("SDA_REST_BACKOFF_BASE_S", "0.005")
    monkeypatch.setenv("SDA_REST_BACKOFF_CAP_S", "0.2")
    with trest.serve_background(t_server()) as url:
        cohort = _Cohort(PORT, tmp_path, lambda name: trest.SdaHttpClient(
            url, trest.TokenStore(tmp_path / name)), "additive", 2)
        agg = cohort.aggregation("storm")
        monkeypatch.setenv("SDA_FAULTS", "drop=0.075,e503=0.075@0.01:17")
        values = [[i % 7, i % 5, 1, i % 3] for i in range(16)]
        cursor = {"index": 0, "t": 0.0, "t0": time.perf_counter()}
        report = ingest.ingest_cohort(cohort.phones, values, agg.id,
                                      trace=arrivals.ArrivalTrace.from_text("base=400,churn=0.2:11"),
                                      cursor=cursor, window=4)
        assert report.rows == 16
        monkeypatch.delenv("SDA_FAULTS")
        assert cohort.count(agg) == 16
        np.testing.assert_array_equal(cohort.reveal(agg),
                                      [sum(v[d] for v in values) % P for d in range(DIM)])


@pytest.mark.parametrize("binding", ["mem", "rest"])
def test_participate_many_equals_singles(tmp_path, binding):
    values = [[i % 5, (i + 1) % 5, 0, 1] for i in range(10)]
    want = [sum(v[d] for v in values) % P for d in range(DIM)]

    def run(pkg, root):
        def body(service_for):
            cohort = _Cohort(pkg, root, service_for, "additive", 1)
            many = cohort.aggregation("many")
            ids = cohort.phones[0].participate_many(values, many.id, chunk_size=4)
            assert len(ids) == len(set(ids)) == 10 and cohort.count(many) == 10
            singles = cohort.aggregation("singles")
            for v in values:
                cohort.phones[0].participate(v, singles.id)
            return cohort.reveal(many), cohort.reveal(singles)

        return _with_service(pkg, binding, root, body)

    ours = run(PORT, tmp_path / "port")
    theirs = run(REFERENCE, tmp_path / "reference")
    for out in ours + theirs:
        np.testing.assert_array_equal(out, want)


def test_a_failed_chunk_stops_later_submits(tmp_path):
    """Chunk 2's upload fails: ``participate_many`` raises that error
    before chunk 3 is submitted, and only chunk 1 stays stored, in both
    packages."""
    outcomes = []
    for pkg in (PORT, REFERENCE):
        server = pkg["server"]()
        cohort = _Cohort(pkg, tmp_path / pkg["proto"].__name__, lambda name: server, "additive", 1)
        agg = cohort.aggregation("failing")
        phone = cohort.phones[0]
        submitted = []
        real = phone.upload_participations

        def upload(parts, _real=real):
            submitted.append(len(parts))
            if len(submitted) == 2:
                raise pkg["proto"].ServerError("chunk 2 refused")
            return _real(parts)

        phone.upload_participations = upload
        with pytest.raises(pkg["proto"].ServerError, match="chunk 2 refused"):
            phone.participate_many([[i, 0, 0, 0] for i in range(11)], agg.id, chunk_size=4)
        outcomes.append((submitted, cohort.count(agg)))
    assert outcomes[0] == outcomes[1] == ([4, 4], 4)


def test_new_participations_cache_skips_repeated_fetches(tmp_path):
    """With one cache per round, repeated builds fetch the aggregation and
    the committee once, as the reference's do."""
    counts = []
    for pkg in (PORT, REFERENCE):
        server = pkg["server"]()
        cohort = _Cohort(pkg, tmp_path / pkg["proto"].__name__, lambda name: server, "additive", 1)
        agg = cohort.aggregation("cached")
        phone = cohort.phones[0]
        calls = {"get_aggregation": 0, "get_committee": 0}

        class Counting:
            def __getattr__(self, name, _inner=phone.service):
                if name in calls:
                    calls[name] += 1
                return getattr(_inner, name)

        phone.service = Counting()
        cache = {}
        for i in range(3):
            phone.upload_participations(phone.new_participations([[i, 1, 2, 3]], agg.id,
                                                                 cache=cache))
        phone.new_participations([[9, 9, 9, 9]], agg.id)
        counts.append(dict(calls))
        assert cohort.count(agg) == 3
    assert counts[0] == counts[1] == {"get_aggregation": 2, "get_committee": 2}
