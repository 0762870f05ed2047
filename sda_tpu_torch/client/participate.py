"""Participant role: mask, share, seal, upload (counterpart of
``sda_tpu/client/participate.py``).

The SDA client's participate.rs:37-113: fetch aggregation and committee,
mask the secrets (sealing the mask to the recipient when the scheme masks),
share the masked vector across the committee, then per clerk fetch +
signature-verify the encryption key and seal that clerk's share vector.
``new_participation`` is separate from upload so retries are idempotent
under the client-chosen ParticipationId. ``new_participations`` builds a
batch against one fetch of the aggregation, committee and verified keys,
and ``upload_participations`` submits it through the service's atomic bulk
``create_participations``. ``participate_many`` pipelines the two: while
chunk k uploads on a worker thread, this thread seals chunk k+1. On a tiered
root a participant's rows go to its leaf sub-aggregation, resolved by pure
hashing (``protocol/tiers.py``). ``new_participations(..., cache=)`` keeps
the aggregation, the leaf and the committee of one round across calls, for
the windowed ingest pipeline (``client/ingest.py``).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .. import telemetry
from ..protocol import Participation, ParticipationId
from ..protocol import tiers as tiers_mod
from .keys import VerifiedKeys


class Participating(VerifiedKeys):
    def participate(self, values, aggregation_id, *, route: bool = True) -> None:
        participation = self.new_participation(values, aggregation_id, route=route)
        self.upload_participation(participation)

    def participate_many(
        self, values_list, aggregation_id, chunk_size: int = 256, *, route: bool = True
    ) -> list:
        """Build + upload one participation per entry of ``values_list``,
        batching both the crypto and the submission. Returns the ids.

        Chunks of ``chunk_size`` are PIPELINED: while chunk k uploads on a
        worker thread (one keep-alive POST on the batch route), the main
        thread is already sealing chunk k+1 — build and network never
        serialize. Each chunk is one atomic submit; a failed chunk raises
        before any later chunk is submitted (earlier chunks stay stored,
        and are idempotently replayable)."""
        values_list = list(values_list)
        ids: list = []
        errors: list = []

        build_hist = telemetry.histogram(
            "sda_client_chunk_seconds",
            "participate_many per-chunk latency by stage",
            stage="build",
        )
        upload_hist = telemetry.histogram(
            "sda_client_chunk_seconds",
            "participate_many per-chunk latency by stage",
            stage="upload",
        )
        built_total = telemetry.counter(
            "sda_client_participations_total",
            "participations built by the batched client path",
        )
        # the upload rides a worker thread, which starts with a FRESH
        # contextvars context — rebind the caller's trace id there so the
        # batch POST still carries X-SDA-Trace
        trace_id = telemetry.current_trace_id()

        def submit(batch):
            if trace_id:
                telemetry.set_trace_id(trace_id)
            t0 = time.perf_counter()
            try:
                with telemetry.span("ingest.upload", rows=len(batch)):
                    self.upload_participations(batch)
            except BaseException as e:
                errors.append(e)
            finally:
                upload_hist.observe(time.perf_counter() - t0)

        inflight = None
        for lo in range(0, len(values_list), chunk_size):
            t0 = time.perf_counter()
            with telemetry.span("ingest.build", rows=min(chunk_size, len(values_list) - lo)):
                batch = self.new_participations(
                    values_list[lo : lo + chunk_size], aggregation_id, route=route
                )
            build_hist.observe(time.perf_counter() - t0)
            built_total.inc(len(batch))
            if inflight is not None:
                inflight.join()
                if errors:
                    raise errors[0]
            ids.extend(p.id for p in batch)
            inflight = threading.Thread(target=submit, args=(batch,))
            inflight.start()
        if inflight is not None:
            inflight.join()
            if errors:
                raise errors[0]
        return ids

    def upload_participation(self, participation) -> None:
        self.service.create_participation(self.agent, participation)

    def upload_participations(self, participations) -> None:
        self.service.create_participations(self.agent, list(participations))

    def new_participation(self, values, aggregation_id, *, route: bool = True) -> Participation:
        return self.new_participations([values], aggregation_id, route=route)[0]

    def new_participations(
        self,
        values_list,
        aggregation_id,
        *,
        route: bool = True,
        ids=None,
        tier_reshare=None,
        cache=None,
    ) -> list:
        """``ids`` pins client-chosen participation ids (share-promotion
        rows use deterministic uuid5 ids so re-drains collide idempotently
        instead of double-counting); ``tier_reshare`` tags every built row
        as a tier promotion (``protocol.resources.TierReshare``). Both
        default off, leaving ordinary participations byte-unchanged.
        ``route=False`` sends rows to a tiered node itself instead of the
        participant's leaf: only tier promoters do that
        (``client/tiers.py``).

        ``cache`` (a caller-owned dict) memoizes the aggregation record,
        leaf resolution, and committee across repeated calls against the
        same round — the windowed ingest pipeline builds many small
        batches per phone, and without it every window re-pays the same
        service round-trips. Scope a cache to one round: it never
        observes committee changes made after the first fetch."""
        secrets_rows = [np.asarray(v, dtype=np.int64) for v in values_list]
        if ids is not None and len(ids) != len(secrets_rows):
            raise ValueError("ids must match values_list one to one")

        def cached(kind, key, fetch):
            if cache is None:
                return fetch()
            value = cache.get((kind, key))
            if value is None:
                value = fetch()
                if value is not None:
                    cache[(kind, key)] = value
            return value

        aggregation = cached(
            "aggregation", aggregation_id,
            lambda: self.service.get_aggregation(self.agent, aggregation_id),
        )
        if aggregation is None:
            raise ValueError("Could not find aggregation")
        if route and aggregation.is_tiered():
            # hierarchical root: real participations belong to this
            # participant's LEAF sub-aggregation, derived by pure hashing
            # from the root record — no extra server round-trips
            leaf_id = tiers_mod.leaf_aggregation_id(aggregation, self.agent.id)
            aggregation = cached(
                "aggregation", leaf_id,
                lambda: self.service.get_aggregation(self.agent, leaf_id),
            )
            if aggregation is None:
                raise ValueError(
                    "tiered aggregation's sub-committees are not provisioned yet "
                    "(run setup_tier_round first)"
                )
        for secrets in secrets_rows:
            if len(secrets) != aggregation.vector_dimension:
                raise ValueError("The input length does not match the aggregation.")

        committee = cached(
            "committee", aggregation.id,
            lambda: self.service.get_committee(self.agent, aggregation.id),
        )
        if committee is None:
            raise ValueError("Could not find committee")

        # mask the secrets
        masker = self.crypto.new_secret_masker(aggregation.masking_scheme)
        masked = [masker.mask(secrets) for secrets in secrets_rows]

        # recipient mask encryptions (absent under NoMasking)
        recipient_encryptions = [None] * len(masked)
        mask_rows = [m for m, _ in masked]
        if mask_rows and len(mask_rows[0]) > 0:
            recipient_key = self._fetch_verified_key(
                aggregation.recipient, aggregation.recipient_key
            )
            mask_encryptor = self.crypto.new_share_encryptor(
                recipient_key, aggregation.recipient_encryption_scheme
            )
            if hasattr(mask_encryptor, "encrypt_batch"):
                recipient_encryptions = mask_encryptor.encrypt_batch(mask_rows)
            else:
                recipient_encryptions = [mask_encryptor.encrypt(m) for m in mask_rows]

        # share the masked secrets: one share vector per clerk, for every
        # participation in the batch, then seal the whole P x C matrix
        generator = self.crypto.new_share_generator(aggregation.committee_sharing_scheme)
        share_rows = [generator.generate(masked_secrets) for _, masked_secrets in masked]

        clerk_ids = [clerk_id for clerk_id, _ in committee.clerks_and_keys]
        clerk_keys = [
            self._fetch_verified_key(clerk_id, clerk_key_id)
            for clerk_id, clerk_key_id in committee.clerks_and_keys
        ]
        encryption_rows = self.crypto.encrypt_share_matrix(
            clerk_keys, aggregation.committee_encryption_scheme, share_rows
        )

        return [
            Participation(
                id=ids[i] if ids is not None else ParticipationId.random(),
                participant=self.agent.id,
                aggregation=aggregation.id,
                recipient_encryption=recipient_encryptions[i],
                clerk_encryptions=list(zip(clerk_ids, encryption_rows[i])),
                tier_reshare=tier_reshare,
            )
            for i in range(len(secrets_rows))
        ]
