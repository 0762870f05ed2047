"""Recipient role: create/open/close aggregations and reveal results
(counterpart of ``sda_tpu/client/receive.py``).

The SDA client's receive.rs: committee election follows the service
suggestion (the first output_size candidates other than the recipient),
closing creates one snapshot if none exists, and reveal decrypts + combines
masks, decrypts clerk results into indexed share vectors, reconstructs, and
unmasks. ``RecipientOutput.positive()`` lifts truncated-remainder residues
into [0, m) (receive.rs:8-21).

The mask combine is where the device comes in: the crypto module's ChaCha
masker expands and folds a large cohort's seeds on its device (see
``crypto/masking.py``). Large snapshot results arrive PAGED: above the
server's threshold ``get_snapshot_result`` answers with counts only, and the
recipient streams the mask column and the clerk results range by range.
Download and compute overlap in a bounded pipeline — up to
``SDA_PREFETCH_DEPTH`` range requests in flight (``client/prefetch.py``)
while this thread decrypts the current range and folds its masks into a
streaming modular accumulator (``MaskCombiner.accumulator``), so every
range of a ChaCha column large enough for the device is one fold on it, and
no fold runs on a prefetch worker. Small results go through the same
accumulator as a single chunk, so both paths share one fold semantics.
``sda_reveal_overlap_efficiency`` gauges how much of a paged reveal's
download was hidden behind its compute. The tier promoter's
``combined_snapshot_mask`` reads a snapshot's mask column alone through
the same pipeline and accumulator (it sets no gauge).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from .. import telemetry
from ..ops.modular import positive
from ..protocol import AdditiveSharing, Committee, SdaError, Snapshot, SnapshotId
from . import prefetch


def require_reconstructible(scheme, present: int, committee_size: int) -> None:
    """Gate the degraded reveal: Shamir-family schemes reconstruct from
    any ``reconstruction_threshold``-sized subset of clerk results, so
    missing clerks are tolerated down to the threshold; additive sharing
    has no redundancy — summing a strict subset of shares silently
    yields a wrong aggregate, so anything short of full attendance must
    fail loudly here. The server's ``result_ready`` applies the same
    threshold, but the client re-checks because it must never hand back
    a wrong sum even against a miscounting (or malicious) server."""
    threshold = scheme.reconstruction_threshold
    if present >= threshold:
        return
    if isinstance(scheme, AdditiveSharing):
        raise SdaError(
            f"additive sharing cannot tolerate missing clerks: only "
            f"{present} of {committee_size} clerk results present and "
            "every share is required — a partial sum would be silently "
            "wrong, not approximate"
        )
    raise SdaError(
        f"not enough surviving clerk results to reconstruct: {present} of "
        f"{committee_size} present, {type(scheme).__name__} needs at "
        f"least {threshold}"
    )


#: reveal pipeline stage latency — one histogram per stage
_STAGE_SERIES = "sda_reveal_stage_seconds"
_STAGE_HELP = "recipient reveal pipeline stage latency by stage"


def _iter_result_chunks(fetch, total: int, what: str, stage_times: dict):
    """Yield a paged snapshot-result column as decrypt-ready blocks.

    ``fetch(start)`` is the range read (``get_snapshot_result_masks`` or
    ``get_snapshot_result_clerks``); chunks stream through the shared
    bounded pipeline (client/prefetch.py ``iter_chunks``): up to
    ``SDA_PREFETCH_DEPTH`` range requests in flight while the consumer
    decrypts the current chunk. The range cursor advances by the length
    the server actually returned, so a server configured with a
    different chunk size stays in lockstep.
    """
    if total <= 0:
        return

    download_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="download")
    # fetches run on prefetch workers, several at once
    lock = threading.Lock()

    def timed_fetch(start: int):
        t0 = time.perf_counter()
        with telemetry.span("reveal.download", what=what, start=start):
            chunk = fetch(start)
        dt = time.perf_counter() - t0
        download_hist.observe(dt)
        with lock:
            stage_times["download"] += dt
        if chunk is None:
            raise SdaError(f"snapshot result {what} disappeared mid-download")
        if not chunk:
            raise SdaError(f"snapshot result {what} truncated at {start}/{total}")
        return chunk

    yield from prefetch.iter_chunks(timed_fetch, total)


@dataclass
class RecipientOutput:
    modulus: int
    values: np.ndarray

    def positive(self) -> "RecipientOutput":
        return RecipientOutput(self.modulus, positive(self.values, self.modulus))


class Receiving:
    def upload_aggregation(self, aggregation) -> None:
        self.service.create_aggregation(self.agent, aggregation)

    def delete_aggregation(self, aggregation_id) -> None:
        """Remove an aggregation this agent is the recipient of."""
        self.service.delete_aggregation(self.agent, aggregation_id)

    def begin_aggregation(self, aggregation_id, *, chosen_clerks=None) -> None:
        """Elect the committee and open the aggregation for participation.

        Default: the first ``output_size`` suggested candidates that are
        not the recipient itself (drafting the recipient as a clerk would
        let one party hold both a share column and the combined result).
        ``chosen_clerks`` (a list of AgentIds) lets the recipient pick its
        own committee; order defines committee position, and every chosen
        clerk must be a candidate (i.e. has uploaded a signed encryption
        key). The server still validates size and keys independently.
        """
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise ValueError(f"Unknown aggregation {aggregation_id}")
        candidates = self.service.suggest_committee(self.agent, aggregation_id)
        size = aggregation.committee_sharing_scheme.output_size
        if chosen_clerks is None:
            eligible = [c for c in candidates if c.id != aggregation.recipient]
            selected = [(c.id, c.keys[0]) for c in eligible[:size]]
        else:
            if len(chosen_clerks) != size:
                raise ValueError(
                    f"committee needs exactly {size} clerks, "
                    f"{len(chosen_clerks)} chosen"
                )
            if len(set(chosen_clerks)) != len(chosen_clerks):
                raise ValueError("chosen clerks contain duplicates")
            by_id = {c.id: c for c in candidates}
            missing = [str(c) for c in chosen_clerks if c not in by_id]
            if missing:
                raise ValueError(
                    "chosen clerks are not candidates (no signed "
                    f"encryption key): {', '.join(missing)}"
                )
            selected = [(cid, by_id[cid].keys[0]) for cid in chosen_clerks]
        self.service.create_committee(
            self.agent, Committee(aggregation=aggregation_id, clerks_and_keys=selected)
        )

    def end_aggregation(self, aggregation_id):
        """Freeze the aggregation behind one snapshot (idempotent).
        Returns the snapshot's id — callers that go on to read the cut
        (tier promoters folding their mask column) can skip the status
        round-trip they'd otherwise need to rediscover it."""
        status = self.service.get_aggregation_status(self.agent, aggregation_id)
        if status is None:
            raise ValueError("Unknown aggregation")
        if len(status.snapshots) >= 1:
            return status.snapshots[0].id
        snapshot = Snapshot(id=SnapshotId.random(), aggregation=aggregation_id)
        self.service.create_snapshot(self.agent, snapshot)
        return snapshot.id

    def combined_snapshot_mask(
        self, aggregation_id, *, aggregation=None, snapshot_id=None
    ) -> np.ndarray:
        """Decrypt + fold the first snapshot's MASK column only, without
        touching (or waiting for) any clerk results.

        This is the tier promoter's whole job under share-promotion
        (client/tiers.py): the child owner cancels its sub-cohort's mask
        sum one tier up via a correction row, and the mask sum is the ONLY
        thing it ever decrypts — data-independent by the masking schemes'
        construction, so no promotion path reconstructs a partial. Works
        as soon as the snapshot is cut (``get_snapshot_result`` serves
        masks regardless of clerk readiness, and reshare children never
        turn result_ready at all). Returns the canonical [0, m) fold; the
        empty vector when the scheme stores no mask.

        ``aggregation`` and ``snapshot_id`` let a caller that already
        holds the record / just cut the snapshot (``end_aggregation``
        returns its id) skip the rediscovery round-trips — the correction
        sits on the tier round's per-node critical path."""
        if aggregation is None:
            aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise ValueError(f"Unknown aggregation {aggregation_id}")
        if snapshot_id is None:
            status = self.service.get_aggregation_status(self.agent, aggregation_id)
            if status is None:
                raise ValueError("Unknown aggregation")
            if not status.snapshots:
                raise ValueError("Aggregation has no snapshot yet")
            snapshot_id = status.snapshots[0].id
        result = self.service.get_snapshot_result(self.agent, aggregation_id, snapshot_id)
        if result is None:
            raise ValueError("Missing aggregation result")

        decryptor = self.crypto.new_share_decryptor(
            aggregation.recipient_key, aggregation.recipient_encryption_scheme
        )
        stage_times = {"download": 0.0}
        if result.is_paged():
            def fetch_masks(start):
                return self.service.get_snapshot_result_masks(
                    self.agent, aggregation_id, snapshot_id, start
                )

            mask_chunks = (
                None
                if result.mask_encryption_count is None
                else _iter_result_chunks(
                    fetch_masks, result.mask_encryption_count, "masks", stage_times
                )
            )
        else:
            mask_chunks = (
                None
                if result.recipient_encryptions is None
                else iter([result.recipient_encryptions])
            )
        if mask_chunks is None:
            return np.empty(0, dtype=np.int64)
        accumulator = self.crypto.new_mask_combiner(
            aggregation.masking_scheme
        ).accumulator()
        for block in mask_chunks:
            with telemetry.span("reveal.decrypt", what="masks", rows=len(block)):
                decrypted = decryptor.decrypt_batch(block)
            with telemetry.span("reveal.fold", what="tier mask", rows=len(block)):
                accumulator.fold(decrypted)
        return accumulator.finish()

    def reveal_aggregation(self, aggregation_id) -> RecipientOutput:
        aggregation = self.service.get_aggregation(self.agent, aggregation_id)
        if aggregation is None:
            raise ValueError(f"Unknown aggregation {aggregation_id}")
        committee = self.service.get_committee(self.agent, aggregation_id)
        if committee is None:
            raise ValueError(f"Unknown committee {aggregation_id}")

        status = self.service.get_aggregation_status(self.agent, aggregation_id)
        if status is None:
            raise ValueError("Unknown aggregation")
        ready = [s for s in status.snapshots if s.result_ready]
        if not ready:
            raise ValueError("Aggregation not ready")
        snapshot_id = ready[0].id
        result = self.service.get_snapshot_result(self.agent, aggregation_id, snapshot_id)
        if result is None:
            raise ValueError("Missing aggregation result")

        # one decryptor serves both mask and clerk-result payloads (same key)
        decryptor = self.crypto.new_share_decryptor(
            aggregation.recipient_key, aggregation.recipient_encryption_scheme
        )
        decrypt_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="decrypt")
        fold_hist = telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="fold")
        stage_times = {"download": 0.0, "decrypt": 0.0, "fold": 0.0, "reconstruct": 0.0}
        t_wall0 = time.perf_counter()

        # both wire shapes feed one streaming machinery: paged results
        # arrive as pipelined range reads, bulk results as a single chunk
        if result.is_paged():
            def fetch_masks(start):
                return self.service.get_snapshot_result_masks(
                    self.agent, aggregation_id, snapshot_id, start
                )

            def fetch_clerks(start):
                return self.service.get_snapshot_result_clerks(
                    self.agent, aggregation_id, snapshot_id, start
                )

            mask_chunks = (
                None
                if result.mask_encryption_count is None  # snapshot stored no mask
                else _iter_result_chunks(
                    fetch_masks, result.mask_encryption_count, "masks", stage_times
                )
            )
            clerk_chunks = _iter_result_chunks(
                fetch_clerks, result.clerk_result_count, "clerk results", stage_times
            )
        else:
            mask_chunks = (
                None
                if result.recipient_encryptions is None
                else iter([result.recipient_encryptions])
            )
            clerk_chunks = iter([result.clerk_encryptions])

        # decrypt + fold masks chunk by chunk: peak memory is one chunk of
        # ciphertexts (plus the prefetched next ones) and one combined
        # partial — never the whole cohort's mask column
        if mask_chunks is None:
            mask = np.empty(0, dtype=np.int64)
        else:
            accumulator = self.crypto.new_mask_combiner(
                aggregation.masking_scheme
            ).accumulator()
            for block in mask_chunks:
                t0 = time.perf_counter()
                with telemetry.span("reveal.decrypt", what="masks", rows=len(block)):
                    decrypted = decryptor.decrypt_batch(block)
                dt = time.perf_counter() - t0
                decrypt_hist.observe(dt)
                stage_times["decrypt"] += dt
                t0 = time.perf_counter()
                with telemetry.span("reveal.fold"):
                    accumulator.fold(decrypted)
                dt = time.perf_counter() - t0
                fold_hist.observe(dt)
                stage_times["fold"] += dt
            mask = accumulator.finish()

        # decrypt the clerk results into (committee index, share vector)
        clerk_positions = {
            clerk: ix for ix, (clerk, _) in enumerate(committee.clerks_and_keys)
        }
        indexed_shares = []
        for block in clerk_chunks:
            if not block:
                continue
            for clerking_result in block:
                if clerking_result.clerk not in clerk_positions:
                    raise ValueError(f"Missing clerk {clerking_result.clerk}")
            t0 = time.perf_counter()
            with telemetry.span("reveal.decrypt", what="clerks", rows=len(block)):
                share_vectors = decryptor.decrypt_batch([cr.encryption for cr in block])
            dt = time.perf_counter() - t0
            decrypt_hist.observe(dt)
            stage_times["decrypt"] += dt
            indexed_shares.extend(
                (clerk_positions[cr.clerk], shares)
                for cr, shares in zip(block, share_vectors)
            )

        # degraded reveal: any >= reconstruction_threshold subset of the
        # committee suffices for Shamir/packed; additive requires all.
        # Checked before the empty-cut shortcut so zero results can never
        # masquerade as an empty aggregate.
        require_reconstructible(
            aggregation.committee_sharing_scheme,
            len(indexed_shares),
            len(committee.clerks_and_keys),
        )

        if all(len(shares) == 0 for _, shares in indexed_shares):
            # an empty snapshot cut: the aggregate over the empty set is
            # the zero vector
            self._record_reveal_pipeline(stage_times, time.perf_counter() - t_wall0)
            return RecipientOutput(
                modulus=aggregation.modulus,
                values=np.zeros(aggregation.vector_dimension, dtype=np.int64),
            )

        t0 = time.perf_counter()
        with telemetry.span("reveal.reconstruct", shares=len(indexed_shares)):
            reconstructor = self.crypto.new_secret_reconstructor(
                aggregation.committee_sharing_scheme, aggregation.vector_dimension
            )
            masked_output = reconstructor.reconstruct(indexed_shares)
            unmasker = self.crypto.new_secret_unmasker(aggregation.masking_scheme)
            output = unmasker.unmask(mask, masked_output)
        dt = time.perf_counter() - t0
        telemetry.histogram(_STAGE_SERIES, _STAGE_HELP, stage="reconstruct").observe(dt)
        stage_times["reconstruct"] += dt
        self._record_reveal_pipeline(stage_times, time.perf_counter() - t_wall0)
        return RecipientOutput(modulus=aggregation.modulus, values=output)

    @staticmethod
    def _record_reveal_pipeline(stage_times: dict, t_wall: float) -> None:
        """Gauge how much download cost the prefetch pipeline hid behind
        compute: 1.0 = fully overlapped, 0.0 = fully serial. Only paged
        reveals accumulate download time (bulk results ride the one
        ``get_snapshot_result`` call), so the gauge tracks paged reveals.
        """
        if stage_times["download"] <= 0:
            return
        compute = (
            stage_times["decrypt"] + stage_times["fold"] + stage_times["reconstruct"]
        )
        overlap = (stage_times["download"] + compute - t_wall) / stage_times["download"]
        telemetry.gauge(
            "sda_reveal_overlap_efficiency",
            "fraction of download time hidden behind decrypt+fold by the "
            "paged-result reveal pipeline (last reveal)",
        ).set(min(1.0, max(0.0, overlap)))
