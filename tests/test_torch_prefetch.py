"""The port's bounded prefetch pipeline (``sda_tpu_torch/client/prefetch.py``)
and the paged reads that run on it, against ``sda_tpu``.

``iter_chunks`` is held against the reference's on the same fetch
functions: the chunks it yields, in order, a resynchronisation when the
server changes its chunk length mid-column, a worker's error raised in the
consumer, the trace id rebound in every worker, ``depth()``'s parsing and
refusals. Then whole rounds with every job and every result paged
(thresholds 0, chunk sizes 1, 4 and 8), in process and over loopback HTTP:
each clerk's paged combine equals its monolithic one, the paged reveal of a
snapshot equals its monolithic reveal byte for byte and the reference's
reveal of the same inputs, and the two overlap gauges lie in [0, 1] and are
set only by paged reads. Last, a paged ChaCha reveal with the device
threshold lowered folds each mask range through ``combine_masks_device``'s
plain version on the consumer thread, once per range.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import sda_tpu.protocol as jp
from sda_tpu import telemetry as jtelemetry
from sda_tpu.client import SdaClient as JClient
from sda_tpu.client import prefetch as jprefetch
from sda_tpu.crypto import Keystore as JKeystore
from sda_tpu.rest import SdaHttpClient as JHttpClient
from sda_tpu.rest import TokenStore as JTokenStore
from sda_tpu.rest import serve_background as j_serve
from sda_tpu.server import new_mem_server as j_server
import sda_tpu_torch.protocol as tp
from sda_tpu_torch import telemetry
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.client import prefetch
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.crypto import masking as tmasking
from sda_tpu_torch.ops.modular import positive
from sda_tpu_torch.rest import SdaHttpClient, TokenStore, serve_background
from sda_tpu_torch.server import new_mem_server

# -- iter_chunks and depth against the reference -----------------------------


def _column_fetch(total: int, lengths):
    """``fetch(start)`` over ``range(total)`` whose k-th call on a start
    returns ``lengths(start)`` items; records every start it was asked."""
    asked = []
    lock = threading.Lock()

    def fetch(start):
        with lock:
            asked.append(start)
        return list(range(start, min(total, start + lengths(start))))

    return fetch, asked


@pytest.mark.parametrize("total,stride,depth", [(1, 4, "3"), (10, 4, "3"), (12, 4, "1"),
                                                (25, 3, "8"), (7, 7, "2"), (0, 4, "3")])
def test_iter_chunks_yields_the_column_in_order(monkeypatch, total, stride, depth):
    monkeypatch.setenv("SDA_PREFETCH_DEPTH", depth)
    outs = []
    for module in (prefetch, jprefetch):
        fetch, _ = _column_fetch(total, lambda start: stride)
        outs.append(list(module.iter_chunks(fetch, total)))
    assert outs[0] == outs[1]
    assert [x for chunk in outs[0] for x in chunk] == list(range(total))


def test_iter_chunks_resyncs_when_the_stride_changes(monkeypatch):
    """The server answers 4 items for chunk 0 and 3 from start 4 on: the
    speculative fetches at 8 and 12 are discarded and the window restarts
    at the real cursor, so no item is skipped or repeated."""
    monkeypatch.setenv("SDA_PREFETCH_DEPTH", "3")
    outs, starts = [], []
    for module in (prefetch, jprefetch):
        fetch, asked = _column_fetch(20, lambda start: 4 if start == 0 else 3)
        outs.append(list(module.iter_chunks(fetch, 20)))
        starts.append(sorted(asked))
    assert outs[0] == outs[1]
    assert [x for chunk in outs[0] for x in chunk] == list(range(20))
    assert starts[0] == starts[1]
    assert 8 in starts[0] and 7 in starts[0]  # a stale guess, then the resync


@pytest.mark.parametrize("module", [prefetch, jprefetch], ids=["port", "reference"])
def test_a_worker_error_is_raised_in_the_consumer(monkeypatch, module):
    monkeypatch.setenv("SDA_PREFETCH_DEPTH", "2")
    consumer = threading.current_thread()

    def fetch(start):
        if start == 8:
            raise ConnectionError(f"range {start} lost")
        return list(range(start, start + 4))

    got = []
    with pytest.raises(ConnectionError, match="range 8 lost"):
        for chunk in module.iter_chunks(fetch, 16):
            assert threading.current_thread() is consumer
            got.append(chunk)
    assert got == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_chunk_zero_is_synchronous_and_workers_carry_the_trace_id(monkeypatch):
    monkeypatch.setenv("SDA_PREFETCH_DEPTH", "3")
    for module, tel in ((prefetch, telemetry), (jprefetch, jtelemetry)):
        seen = {}
        lock = threading.Lock()

        def fetch(start):
            with lock:
                seen[start] = (threading.current_thread(), tel.current_trace_id())
            return list(range(start, min(13, start + 2)))

        with tel.trace("trace-prefetch-1"):
            assert [x for c in module.iter_chunks(fetch, 13) for x in c] == list(range(13))
        assert seen[0][0] is threading.current_thread()
        assert {tid for _, tid in seen.values()} == {"trace-prefetch-1"}
        assert any(thread is not threading.current_thread() for thread, _ in seen.values())


@pytest.mark.parametrize("raw", [None, "", "1", "3", "7", "0", "-4", "two", "2.5"])
def test_depth_parses_and_refuses_like_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("SDA_PREFETCH_DEPTH", raising=False)
    else:
        monkeypatch.setenv("SDA_PREFETCH_DEPTH", raw)
    outcomes = []
    for module in (prefetch, jprefetch):
        try:
            outcomes.append(module.depth())
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


# -- paged rounds ---------------------------------------------------------------

P, DIM, PARTICIPANTS, CLERKS = 433, 6, 9, 8
PORT = {"proto": tp, "client": TClient, "keystore": TKeystore, "server": new_mem_server,
        "serve": serve_background, "http": SdaHttpClient, "tokens": TokenStore}
REFERENCE = {"proto": jp, "client": JClient, "keystore": JKeystore, "server": j_server,
             "serve": j_serve, "http": JHttpClient, "tokens": JTokenStore}
MASKINGS = {
    "none": lambda pr: pr.NoMasking(),
    "full": lambda pr: pr.FullMasking(modulus=P),
    "chacha": lambda pr: pr.ChaChaMasking(modulus=P, dimension=DIM, seed_bitsize=128),
}


def _page(monkeypatch, chunk: int) -> None:
    for key in ("SDA_JOB_PAGE_THRESHOLD", "SDA_RESULT_PAGE_THRESHOLD"):
        monkeypatch.setenv(key, "0")
    for key in ("SDA_JOB_CHUNK_SIZE", "SDA_RESULT_CHUNK_SIZE"):
        monkeypatch.setenv(key, str(chunk))


def _inputs():
    return np.random.default_rng(14).integers(0, P, size=(PARTICIPANTS, DIM))


class _Round:
    """A recipient, 8 clerks and the participants of one packed-Shamir
    round in ``pkg``, every member on ``service_for(name)``; ``upload``
    runs it up to the snapshot."""

    def __init__(self, pkg, root, service_for, masking):
        self.pkg, self.root, self.service_for = pkg, root, service_for
        proto = pkg["proto"]
        self.recipient = self.member("recipient")
        key = self.recipient.new_encryption_key()
        self.recipient.upload_agent()
        self.recipient.upload_encryption_key(key)
        self.clerks = [self.member(f"clerk{i}") for i in range(CLERKS)]
        for clerk in self.clerks:
            clerk.upload_agent()
            clerk.upload_encryption_key(clerk.new_encryption_key())
        self.aggregation = proto.Aggregation(
            id=proto.AggregationId.random(), title="paged round", vector_dimension=DIM,
            modulus=P, recipient=self.recipient.agent.id, recipient_key=key,
            masking_scheme=MASKINGS[masking](proto),
            committee_sharing_scheme=proto.PackedShamirSharing(3, 8, 4, P, 354, 150),
            recipient_encryption_scheme=proto.SodiumEncryptionScheme(),
            committee_encryption_scheme=proto.SodiumEncryptionScheme())
        self.recipient.upload_aggregation(self.aggregation)
        self.recipient.begin_aggregation(self.aggregation.id)

    def member(self, name):
        pkg = self.pkg
        keystore = pkg["keystore"](self.root / name)
        agent = pkg["client"].new_agent(keystore)
        if pkg is PORT:
            return TClient(agent, keystore, self.service_for(name), device="cpu")
        return pkg["client"](agent, keystore, self.service_for(name))

    def upload(self, values):
        for i, row in enumerate(values):
            part = self.member(f"participant{i}")
            part.upload_agent()
            part.participate([int(v) for v in row], self.aggregation.id)
        self.recipient.end_aggregation(self.aggregation.id)


def _services(pkg, binding, root, url):
    if binding == "rest":
        return lambda name: pkg["http"](url, pkg["tokens"](root / name))
    server = pkg["server"]()
    return lambda name: server


def _gauge(name):
    return [value for (n, _), value in telemetry.get_registry().snapshot()["gauges"].items()
            if n == name]


def _reference_reveal(tmp_path, binding, masking, values):
    def run(url=None):
        rnd = _Round(REFERENCE, tmp_path / "reference", _services(REFERENCE, binding,
                                                                 tmp_path / "reference", url),
                     masking)
        rnd.upload(values)
        for clerk in rnd.clerks:
            clerk.run_chores(-1)
        return np.asarray(rnd.recipient.reveal_aggregation(rnd.aggregation.id).positive().values)

    if binding == "rest":
        with j_serve(j_server()) as url:
            return run(url)
    return run()


CASES = [(1, "mem", "chacha"), (4, "mem", "full"), (8, "mem", "chacha"),
         (1, "rest", "full"), (4, "rest", "chacha"), (8, "rest", "none")]


@pytest.mark.parametrize("chunk,binding,masking", CASES)
def test_paged_round_equals_monolithic_and_reference(tmp_path, monkeypatch, chunk, binding,
                                                     masking):
    _page(monkeypatch, chunk)
    monkeypatch.setenv("SDA_PREFETCH_DEPTH", "3")
    telemetry.set_enabled(True)
    values = _inputs()

    def run(url=None):
        rnd = _Round(PORT, tmp_path / "port", _services(PORT, binding, tmp_path / "port", url),
                     masking)
        rnd.upload(values)
        # every clerk's job: the paged combine equals the monolithic one
        for clerk in rnd.clerks:
            monkeypatch.setenv("SDA_JOB_PAGE_THRESHOLD", "100000")
            job = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
            assert not job.is_paged()
            telemetry.reset()
            _, _, whole = clerk._combine_job(job)
            assert _gauge("sda_clerk_overlap_efficiency") == []
            monkeypatch.setenv("SDA_JOB_PAGE_THRESHOLD", "0")
            paged_job = clerk.service.get_clerking_job(clerk.agent, clerk.agent.id)
            assert paged_job.is_paged() and paged_job.id == job.id
            _, _, paged = clerk._combine_job(paged_job)
            np.testing.assert_array_equal(positive(paged, P), positive(whole, P))
            (overlap,) = _gauge("sda_clerk_overlap_efficiency")
            assert 0.0 <= overlap <= 1.0
            assert clerk.run_chores(-1) == 1
        # one snapshot revealed both ways
        aggregation_id = rnd.aggregation.id
        monkeypatch.setenv("SDA_RESULT_PAGE_THRESHOLD", "100000")
        telemetry.reset()
        whole = rnd.recipient.reveal_aggregation(aggregation_id).values
        assert _gauge("sda_reveal_overlap_efficiency") == []
        monkeypatch.setenv("SDA_RESULT_PAGE_THRESHOLD", "0")
        status = rnd.recipient.service.get_aggregation_status(rnd.recipient.agent, aggregation_id)
        result = rnd.recipient.service.get_snapshot_result(
            rnd.recipient.agent, aggregation_id, status.snapshots[0].id)
        assert result.is_paged() and result.clerk_result_count == CLERKS
        paged = rnd.recipient.reveal_aggregation(aggregation_id).values
        (overlap,) = _gauge("sda_reveal_overlap_efficiency")
        assert 0.0 <= overlap <= 1.0
        assert np.asarray(paged).tobytes() == np.asarray(whole).tobytes()
        return positive(np.asarray(paged), P)

    if binding == "rest":
        with serve_background(new_mem_server()) as url:
            ours = run(url)
    else:
        ours = run()
    theirs = _reference_reveal(tmp_path, binding, masking, values)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, values.sum(axis=0) % P)


def test_paged_chacha_reveal_folds_each_range_on_the_consumer(tmp_path, monkeypatch):
    """With ``DEVICE_COMBINE_THRESHOLD`` at 1 every mask range takes the
    device fold, here its plain version (the masker's device is the CPU):
    9 rows in ranges of 4 are three folds, each on the reveal's own thread,
    and the reveal equals the reference's."""
    _page(monkeypatch, 4)
    monkeypatch.setattr(tmasking.ChaChaMasker, "DEVICE_COMBINE_THRESHOLD", 1)
    folds = []
    real = tmasking.combine_masks_device

    def counted(seeds, dim, modulus, **kwargs):
        assert kwargs["device"].type == "cpu"
        folds.append((len(seeds), threading.current_thread()))
        return real(seeds, dim, modulus, **kwargs)

    monkeypatch.setattr(tmasking, "combine_masks_device", counted)
    values = _inputs()
    rnd = _Round(PORT, tmp_path / "port", _services(PORT, "mem", tmp_path, None), "chacha")
    rnd.upload(values)
    for clerk in rnd.clerks:
        clerk.run_chores(-1)
    reveal_thread = threading.current_thread()
    ours = rnd.recipient.reveal_aggregation(rnd.aggregation.id).positive().values
    assert [rows for rows, _ in folds] == [4, 4, 1]
    assert all(thread is reveal_thread for _, thread in folds)
    theirs = _reference_reveal(tmp_path, "mem", "chacha", values)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, values.sum(axis=0) % P)


def test_request_counter_loses_no_update_under_concurrent_exchanges(monkeypatch):
    """``chip_smoke._Traffic`` counts the exchanges of clerk threads and
    prefetch workers at once: 48 threads of 300 exchanges each, with the
    interpreter switching threads every microsecond, lose no count."""
    import sys
    import types

    import chip_smoke

    def exchange(self, root, method, target, body, headers):
        return types.SimpleNamespace(content=b"xy")

    monkeypatch.setattr(SdaHttpClient, "_exchange", exchange)
    traffic = chip_smoke._Traffic()
    target = "/v1/aggregations/implied/jobs/j1/chunks/4"
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with traffic:
            threads = [threading.Thread(target=lambda: [
                SdaHttpClient._exchange(None, "root", "GET", target, b"abc", {})
                for _ in range(300)]) for _ in range(48)]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=60)
            assert not any(thread.is_alive() for thread in threads)
    finally:
        sys.setswitchinterval(interval)
    assert SdaHttpClient._exchange is exchange
    assert traffic.counts == {"requests": 14_400, "bytes_up": 43_200, "bytes_down": 28_800}
    assert traffic.ranges == {("chunks", "j1"): 14_400}
