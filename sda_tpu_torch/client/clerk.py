"""Clerk role: poll queue, decrypt, combine, re-encrypt to recipient
(counterpart of ``sda_tpu/client/clerk.py``).

The SDA client's clerk.rs. The hot loop — decrypt every participant's share
vector and sum mod m — runs as stacked numpy reductions over fixed-size
chunks (``DECRYPT_CHUNK`` participants at a time), folding each chunk's
partial into a running modular sum, so peak memory is one chunk of
plaintext vectors (the accumulating combiner clerk.rs:71-73 suggests).

Large jobs arrive PAGED: the server returns metadata only
(``total_encryptions`` + suggested ``chunk_size``) and the clerk pulls the
ciphertext column range by range via ``get_clerking_job_chunk``. Download
and compute overlap in a bounded pipeline — up to ``SDA_PREFETCH_DEPTH``
(default 3) range requests in flight while this thread decrypts and folds
the current range (``client/prefetch.py``) — so wall time approaches
max(download, decrypt+combine) instead of their sum, with at most depth+1
ranges resident. ``sda_clerk_overlap_efficiency`` gauges how much of the
download the last paged job hid behind its compute.

Under a Packed Paillier recipient scheme the combined column is lifted to
canonical nonnegative residues before it is sealed (packing holds
nonnegative values only). On a derived tier child under share promotion
the combined column is not sealed to the recipient: the clerk expands it by
its Lagrange coefficients and submits it to the parent aggregation as a
tagged participation (``_promote_share_column``), keeping the column cached
for an epoch-1 reissue after a peer's death (``reshare_tier_child``).
"""

from __future__ import annotations

import threading
import time

from .. import telemetry
from ..ops.modular import positive
from ..ops.shamir import reshare_coefficients, reshare_column
from ..protocol import (
    ClerkingResult,
    PackedPaillierEncryptionScheme,
    SdaError,
    ServerError,
    TierReshare,
)
from ..protocol import tiers as tiers_mod
from ..utils.metrics import get_metrics
from . import prefetch
from .keys import VerifiedKeys

#: pipeline stage latency — one histogram per stage
_STAGE_SERIES = "sda_clerk_stage_seconds"
_STAGE_HELP = "clerk job pipeline stage latency by stage"
#: share-promotion latency (expand the aggregated column by its Lagrange
#: coefficients + build and submit the tagged parent participation)
_RESHARE_SERIES = "sda_tier_reshare_seconds"
_RESHARE_HELP = "clerk share-promotion latency (column expand + submit)"


class Clerking(VerifiedKeys):
    #: participants decrypted + folded per block in process_clerking_job;
    #: bounds clerk memory to one block of plaintext share vectors (and is
    #: the fallback chunk length when a paged job suggests none)
    DECRYPT_CHUNK = 4096

    def clerk_once(self) -> bool:
        """Process the next pending job, if any; returns whether one ran.

        On a derived tier child in share-promotion mode
        (``protocol.tiers.is_reshare_child``) the aggregated column is NOT
        sealed into a clerking result — the child never reveals. Instead
        the clerk immediately re-shares the column to the child's parent
        as a tagged ordinary participation (epoch 0 = full committee); the
        column stays cached so a survivor reissue (epoch 1) can follow a
        peer's death without reprocessing the job."""
        job = self.service.get_clerking_job(self.agent, self.agent.id)
        if job is None:
            return False
        aggregation, committee, combined = self._combine_job(job)
        if tiers_mod.is_reshare_child(aggregation):
            n = aggregation.committee_sharing_scheme.output_size
            self._promote_share_column(
                aggregation, committee, combined, survivors=list(range(n)), epoch=0
            )
            # retire the job only AFTER the promotion landed: a crash in
            # between redelivers the job, recomputes the identical column,
            # and the deterministic participation id collides idempotently
            self.service.complete_clerking_job(self.agent, job.id)
        else:
            result = self._seal_result(job, aggregation, combined)
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

    def _iter_job_chunks(self, job, stage_times: dict):
        """Yield the job's ciphertext column as decrypt-ready blocks.

        Monolithic jobs slice the in-memory column by ``DECRYPT_CHUNK``.
        Paged jobs (``is_paged()`` — column left server-side) run the
        download stage of the pipeline: up to ``SDA_PREFETCH_DEPTH``
        range requests in flight while the consumer decrypts the current
        chunk (client/prefetch.py ``iter_chunks``). The range cursor
        advances by the length the server actually returned, so a server
        configured with a different chunk size stays in lockstep; the
        download seconds add up in ``stage_times["download"]``.
        """
        if not job.is_paged():
            for start in range(0, len(job.encryptions), self.DECRYPT_CHUNK):
                yield job.encryptions[start : start + self.DECRYPT_CHUNK]
            return

        total = job.total_encryptions
        if total <= 0:
            return

        download_hist = telemetry.histogram(
            _STAGE_SERIES, _STAGE_HELP, stage="download"
        )
        # fetches run on prefetch workers, several at once
        lock = threading.Lock()

        def fetch(start: int):
            t0 = time.perf_counter()
            with telemetry.span("clerk.download", start=start):
                chunk = self.service.get_clerking_job_chunk(self.agent, job.id, start)
            dt = time.perf_counter() - t0
            download_hist.observe(dt)
            with lock:
                stage_times["download"] += dt
            if chunk is None:
                raise SdaError(f"clerking job {job.id} disappeared mid-download")
            if not chunk:
                raise SdaError(
                    f"clerking job {job.id} column truncated at {start}/{total}"
                )
            return chunk

        yield from prefetch.iter_chunks(fetch, total)

    def process_clerking_job(self, job) -> ClerkingResult:
        """Decrypt + combine the job's column and seal it to the
        recipient — the flat pipeline. Tier-child share promotion routes
        through ``clerk_once`` instead (the combined column must not be
        sealed into a local clerking result there)."""
        aggregation, _, combined = self._combine_job(job)
        return self._seal_result(job, aggregation, combined)

    def _combine_job(self, job):
        """(aggregation, committee, combined column) for ``job`` — the
        decrypt + chunked modular fold shared by both promotion paths."""
        aggregation = self.service.get_aggregation(self.agent, job.aggregation)
        if aggregation is None:
            raise ValueError("Unknown aggregation")
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
        stage_times = {"download": 0.0, "decrypt": 0.0, "combine": 0.0}
        combined = None
        t_wall0 = time.perf_counter()
        for block in self._iter_job_chunks(job, stage_times):
            t0 = time.perf_counter()
            with metrics.phase("clerk.decrypt"), telemetry.span(
                "clerk.decrypt", rows=len(block)
            ):
                share_vectors = decryptor.decrypt_batch(block)
            dt = time.perf_counter() - t0
            decrypt_hist.observe(dt)
            stage_times["decrypt"] += dt
            t0 = time.perf_counter()
            with metrics.phase("clerk.combine"), telemetry.span("clerk.combine"):
                partial = combiner.combine(share_vectors)
                combined = (
                    partial
                    if combined is None
                    else combiner.combine([combined, partial])
                )
            dt = time.perf_counter() - t0
            combine_hist.observe(dt)
            stage_times["combine"] += dt
        t_wall = time.perf_counter() - t_wall0
        if stage_times["download"] > 0:
            # how much of the download cost the pipeline hid behind
            # compute: 1.0 = fully overlapped, 0.0 = fully serial
            overlap = (
                stage_times["download"]
                + stage_times["decrypt"]
                + stage_times["combine"]
                - t_wall
            ) / stage_times["download"]
            telemetry.gauge(
                "sda_clerk_overlap_efficiency",
                "fraction of download time hidden behind decrypt+combine "
                "by the paged-job pipeline (last job)",
            ).set(min(1.0, max(0.0, overlap)))
        if combined is None:  # empty snapshot cut
            combined = combiner.combine([])
        return aggregation, committee, combined

    def _seal_result(self, job, aggregation, combined) -> ClerkingResult:
        if isinstance(
            aggregation.recipient_encryption_scheme, PackedPaillierEncryptionScheme
        ):
            # Paillier packing is nonnegative-only; lift the signed
            # residues (truncated-remainder semantics) to canonical form —
            # congruent mod m, so reconstruction is unchanged
            combined = positive(combined, aggregation.modulus)

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

    # -- share promotion (hierarchical plane) -------------------------------

    def _tier_column_cache(self) -> dict:
        """{child aggregation id: (position, combined column)} — lazily
        created; VerifiedKeys subclasses don't all share one __init__."""
        cache = getattr(self, "_tier_columns", None)
        if cache is None:
            cache = {}
            self._tier_columns = cache
        return cache

    def _promote_share_column(
        self, aggregation, committee, combined, *, survivors, epoch: int
    ) -> None:
        """Re-share our aggregated column toward ``aggregation``'s parent.

        The column (length B = batches of the sharing scheme) is expanded
        by this clerk's Lagrange coefficients over ``survivors`` into a
        dim-length vector (ops/shamir.py reshare_column) and submitted as
        an ORDINARY participation of the parent — freshly masked, shared,
        and sealed by the Participating half of this client — carrying a
        TierReshare tag and a deterministic id, so retries and re-drains
        land idempotently. The sub-cohort's own masks are cancelled by the
        child owner's separate mask-correction row (client/tiers.py);
        nothing on this path ever reconstructs the partial."""
        position = next(
            (
                ix
                for ix, (clerk, _) in enumerate(committee.clerks_and_keys)
                if clerk == self.agent.id
            ),
            None,
        )
        if position is None:
            raise SdaError("clerk is not a member of the child committee")
        if position not in survivors:
            raise SdaError(
                f"clerk position {position} is not in the survivor set"
            )
        t0 = time.perf_counter()
        with telemetry.span("clerk.reshare", epoch=epoch):
            self._tier_column_cache()[aggregation.id] = (position, combined)
            coefficients = reshare_coefficients(
                aggregation.committee_sharing_scheme, survivors, position
            )
            values = reshare_column(
                combined,
                coefficients,
                aggregation.modulus,
                aggregation.vector_dimension,
            )
            tag = TierReshare(
                child=aggregation.id,
                epoch=epoch,
                position=position,
                survivors=sorted(survivors),
            )
            pid = tiers_mod.reshare_participation_id(aggregation.id, epoch, position)
            rows = self.new_participations(
                [values],
                aggregation.tier_parent,
                route=False,
                ids=[pid],
                tier_reshare=tag,
            )
            try:
                self.upload_participations(rows)
            except ServerError as e:
                # deterministic id: an identical earlier attempt already
                # landed — exactly the idempotence the id exists for
                if "already exists" not in str(e):
                    raise
        telemetry.histogram(_RESHARE_SERIES, _RESHARE_HELP, stage="column").observe(
            time.perf_counter() - t0
        )

    def reshare_tier_child(self, child_aggregation, survivors, epoch: int) -> None:
        """Reissue our promotion for ``child_aggregation`` over a reduced
        ``survivors`` set (a peer died after end-of-aggregation): the
        cached column from the original job is expanded with the fresh
        Lagrange weights and submitted under the new epoch. Raises if this
        clerk never processed the child's job (its column is gone — the
        caller must treat this clerk as dead too)."""
        cached = self._tier_column_cache().get(child_aggregation.id)
        if cached is None:
            raise SdaError(
                f"no cached share column for {child_aggregation.id}; "
                "this clerk cannot re-share"
            )
        position, combined = cached
        committee = self.service.get_committee(self.agent, child_aggregation.id)
        if committee is None:
            raise ValueError("Unknown committee")
        self._promote_share_column(
            child_aggregation,
            committee,
            combined,
            survivors=list(survivors),
            epoch=epoch,
        )
