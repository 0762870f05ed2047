"""Clerk role: poll queue, decrypt, combine, re-encrypt to recipient
(counterpart of ``sda_tpu/client/clerk.py``, flat aggregations only).

The SDA client's clerk.rs. The hot loop — decrypt every participant's share
vector and sum mod m — runs as stacked numpy reductions over fixed-size
chunks (``DECRYPT_CHUNK`` participants at a time), folding each chunk's
partial into a running modular sum, so peak memory is one chunk of
plaintext vectors (the accumulating combiner clerk.rs:71-73 suggests).

Large jobs arrive PAGED: the server returns metadata only
(``total_encryptions`` + suggested ``chunk_size``) and the clerk pulls the
ciphertext column range by range via ``get_clerking_job_chunk``, one range
after the other: the reference's prefetch thread, which overlaps the next
range's download with the current one's decrypt, is not ported (its folds
are byte-identical either way). Tier share promotion is not ported.
"""

from __future__ import annotations

import time

from .. import telemetry
from ..protocol import ClerkingResult, SdaError
from ..protocol.resources import TIERS_NOT_PORTED
from ..utils.metrics import get_metrics
from .keys import VerifiedKeys

#: pipeline stage latency — one histogram per stage
_STAGE_SERIES = "sda_clerk_stage_seconds"
_STAGE_HELP = "clerk job pipeline stage latency by stage"


def iter_ranges(fetch, total: int):
    """Yield the ranges ``fetch(start)`` returns for ``[0, total)`` in
    order; the cursor advances by the length the server actually returned,
    so a server configured with another chunk size stays in lockstep."""
    start = 0
    while start < total:
        chunk = fetch(start)
        start += len(chunk)
        yield chunk


class Clerking(VerifiedKeys):
    #: participants decrypted + folded per block in process_clerking_job;
    #: bounds clerk memory to one block of plaintext share vectors (and is
    #: the fallback chunk length when a paged job suggests none)
    DECRYPT_CHUNK = 4096

    def clerk_once(self) -> bool:
        """Process the next pending job, if any; returns whether one ran."""
        job = self.service.get_clerking_job(self.agent, self.agent.id)
        if job is None:
            return False
        result = self.process_clerking_job(job)
        self.service.create_clerking_result(self.agent, result)
        return True

    def run_chores(self, max_iterations: int) -> int:
        """Clerk repeatedly; negative means drain until no work is left.
        Returns the number of jobs processed, so daemon poll loops can
        back off when a pass found the queue empty."""
        done = 0
        if max_iterations < 0:
            while self.clerk_once():
                done += 1
        else:
            for _ in range(max_iterations):
                if not self.clerk_once():
                    break
                done += 1
        return done

    def _iter_job_chunks(self, job):
        """Yield the job's ciphertext column as decrypt-ready blocks:
        monolithic jobs slice the in-memory column by ``DECRYPT_CHUNK``,
        paged jobs fetch the column range by range."""
        if not job.is_paged():
            for start in range(0, len(job.encryptions), self.DECRYPT_CHUNK):
                yield job.encryptions[start : start + self.DECRYPT_CHUNK]
            return

        total = job.total_encryptions
        download_hist = telemetry.histogram(
            _STAGE_SERIES, _STAGE_HELP, stage="download"
        )

        def fetch(start: int):
            t0 = time.perf_counter()
            with telemetry.span("clerk.download", start=start):
                chunk = self.service.get_clerking_job_chunk(self.agent, job.id, start)
            download_hist.observe(time.perf_counter() - t0)
            if chunk is None:
                raise SdaError(f"clerking job {job.id} disappeared mid-download")
            if not chunk:
                raise SdaError(
                    f"clerking job {job.id} column truncated at {start}/{total}"
                )
            return chunk

        yield from iter_ranges(fetch, total)

    def process_clerking_job(self, job) -> ClerkingResult:
        """Decrypt + combine the job's column and seal it to the
        recipient."""
        aggregation = self.service.get_aggregation(self.agent, job.aggregation)
        if aggregation is None:
            raise ValueError("Unknown aggregation")
        if aggregation.is_tiered() or aggregation.tier_parent is not None:
            raise NotImplementedError(TIERS_NOT_PORTED)
        committee = self.service.get_committee(self.agent, job.aggregation)
        if committee is None:
            raise ValueError("Unknown committee")

        # which of our encryption keys was used
        own_key_id = next(
            (key for (clerk, key) in committee.clerks_and_keys if clerk == self.agent.id),
            None,
        )
        if own_key_id is None:
            raise ValueError("Could not find own encryption key in keyset")

        total = job.total_encryptions if job.is_paged() else len(job.encryptions)
        metrics = get_metrics()
        metrics.count("clerk.jobs")
        metrics.count("clerk.participations", total)
        decryptor = self.crypto.new_share_decryptor(
            own_key_id, aggregation.committee_encryption_scheme
        )
        decrypt_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="decrypt")
        combine_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="combine")
        # chunked partial sums are congruent mod m to the one-shot combine
        # (signed-remainder representatives can differ; reconstruction
        # reduces mod p and the reveal lifts via positive())
        combiner = self.crypto.new_share_combiner(aggregation.committee_sharing_scheme)
        combined = None
        for block in self._iter_job_chunks(job):
            t0 = time.perf_counter()
            with metrics.phase("clerk.decrypt"), telemetry.span(
                "clerk.decrypt", rows=len(block)
            ):
                share_vectors = decryptor.decrypt_batch(block)
            decrypt_hist.observe(time.perf_counter() - t0)
            t0 = time.perf_counter()
            with metrics.phase("clerk.combine"), telemetry.span("clerk.combine"):
                partial = combiner.combine(share_vectors)
                combined = (
                    partial
                    if combined is None
                    else combiner.combine([combined, partial])
                )
            combine_hist.observe(time.perf_counter() - t0)
        if combined is None:  # empty snapshot cut
            combined = combiner.combine([])

        # fetch + verify recipient key (cached across jobs — keys.py
        # VerifiedKeys), re-encrypt the combined vector
        recipient_key = self._fetch_verified_key(
            aggregation.recipient, aggregation.recipient_key
        )
        encryptor = self.crypto.new_share_encryptor(
            recipient_key, aggregation.recipient_encryption_scheme
        )
        return ClerkingResult(
            job=job.id, clerk=job.clerk, encryption=encryptor.encrypt(combined)
        )
