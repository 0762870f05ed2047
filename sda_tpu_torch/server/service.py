"""SdaServer core and its ACL-enforcing service wrapper (counterpart of
``sda_tpu/server/service.py``).

``SdaServer`` delegates every RPC to the four stores (the SDA server's
server.rs:23-191); ``SdaServerService`` implements the protocol's
``SdaService`` interface on top, adding per-route access control as
server.rs:193-361 does: recipient-only guards on all recipient routes,
caller == subject on create/upsert routes, and the clerk-job ownership
double check on result submission. The auth-token methods serve the REST
binding's trust-on-first-use login. Tiered aggregations are validated at
creation (``protocol/tiers.py`` bounds and promotion rules), a tiered
root's delete cascades over its derived tree, and share-promotion rows are
checked at the door. A Packed Paillier aggregation is checked at creation
(recipient encryption only, Full masking, masks within the component
bound), and each participation's Paillier mask ciphertext is checked for
well-formedness at the door, with the recipient's public key only.
"""

from __future__ import annotations

from typing import Optional

from .. import telemetry
from ..protocol import (
    AdditiveSharing,
    AggregationStatus,
    ChaChaMasking,
    EncryptionKey,
    FullMasking,
    InvalidCredentialsError,
    InvalidRequestError,
    PackedPaillierEncryptionScheme,
    PermissionDeniedError,
    Pong,
    SdaService,
    ServerError,
    SnapshotResult,
    SnapshotStatus,
    TierNodeStatus,
    TierStatus,
)
from ..protocol import tiers as tiers_mod
from . import snapshot as snapshot_mod
from . import stores

#: ``ops.modular.WIDE_MAX_MODULUS``, the wide field math's exactness bound,
#: restated: importing ``ops`` loads torch, which the coordination server
#: (``sdad``) otherwise never needs
WIDE_MAX_MODULUS = 1 << 62


class SdaServer:
    def __init__(self, agents_store, auth_tokens_store, aggregation_store, clerking_job_store):
        self.agents_store = agents_store
        self.auth_tokens_store = auth_tokens_store
        self.aggregation_store = aggregation_store
        self.clerking_job_store = clerking_job_store

    # -- base --------------------------------------------------------------

    def ping(self) -> Pong:
        self.agents_store.ping()
        return Pong(running=True)

    # -- agents ------------------------------------------------------------

    def create_agent(self, agent) -> None:
        self.agents_store.create_agent(agent)

    def get_agent(self, agent_id):
        return self.agents_store.get_agent(agent_id)

    def upsert_profile(self, profile) -> None:
        self.agents_store.upsert_profile(profile)

    def get_profile(self, agent_id):
        return self.agents_store.get_profile(agent_id)

    def create_encryption_key(self, key) -> None:
        self.agents_store.create_encryption_key(key)

    def get_encryption_key(self, key_id):
        return self.agents_store.get_encryption_key(key_id)

    # -- aggregations --------------------------------------------------------

    def list_aggregations(self, filter, recipient):
        return self.aggregation_store.list_aggregations(filter, recipient)

    def get_aggregation(self, aggregation_id):
        return self.aggregation_store.get_aggregation(aggregation_id)

    def get_committee(self, aggregation_id):
        return self.aggregation_store.get_committee(aggregation_id)

    def create_aggregation(self, aggregation) -> None:
        if not 0 < aggregation.modulus < WIDE_MAX_MODULUS:
            raise InvalidRequestError(
                f"modulus {aggregation.modulus} outside (0, 2^62): beyond the "
                "exactness bound of the wide math plane"
            )
        # the math plane computes with the SCHEME-embedded moduli, so they
        # must match the aggregation's group (and obey the same bound) —
        # a mismatch silently corrupts the revealed aggregate
        sharing = aggregation.committee_sharing_scheme
        scheme_modulus = getattr(sharing, "modulus", None) or getattr(
            sharing, "prime_modulus", None
        )
        if scheme_modulus != aggregation.modulus:
            raise InvalidRequestError(
                "committee sharing scheme modulus differs from aggregation modulus"
            )
        masking = aggregation.masking_scheme
        mask_modulus = getattr(masking, "modulus", None)
        if mask_modulus is not None and mask_modulus != aggregation.modulus:
            raise InvalidRequestError(
                "masking scheme modulus differs from aggregation modulus"
            )
        if (
            isinstance(masking, ChaChaMasking)
            and masking.dimension != aggregation.vector_dimension
        ):
            raise InvalidRequestError(
                "ChaCha masking dimension differs from aggregation vector dimension"
            )
        if isinstance(
            aggregation.committee_encryption_scheme, PackedPaillierEncryptionScheme
        ):
            # shares are signed residues (truncated-remainder semantics);
            # Paillier packing is nonnegative-only, so clerk transport
            # stays on sodium sealed boxes
            raise InvalidRequestError(
                "PackedPaillier applies to recipient encryption only"
            )
        if isinstance(
            aggregation.recipient_encryption_scheme, PackedPaillierEncryptionScheme
        ):
            pscheme = aggregation.recipient_encryption_scheme
            if not isinstance(masking, (FullMasking,)) and masking.has_mask():
                # ChaCha uploads SEEDS as masks — summing seeds
                # homomorphically would corrupt the unmask silently
                raise InvalidRequestError(
                    "PackedPaillier recipient encryption requires Full masking"
                )
            if aggregation.modulus.bit_length() > pscheme.max_value_bitsize:
                raise InvalidRequestError(
                    "mask values would not fit the Paillier component bound"
                )
        # hierarchical knobs travel together: tiers counts committee levels
        # (so 1 is just "flat" and must be spelled as absence — the fields
        # are omitted from wire/signing bytes when unset, and an explicit
        # tiers=1 would make two byte-encodings of the same flat semantics)
        if aggregation.tiers is not None or aggregation.sub_cohort_size is not None:
            t, m = aggregation.tiers, aggregation.sub_cohort_size
            if t is None or m is None:
                raise InvalidRequestError(
                    "tiers and sub_cohort_size must be set together"
                )
            if not 2 <= t <= tiers_mod.MAX_TIERS:
                raise InvalidRequestError(
                    f"tiers must be in [2, {tiers_mod.MAX_TIERS}] "
                    "(flat aggregations omit the field)"
                )
            if not 2 <= m <= tiers_mod.MAX_SUB_COHORTS:
                raise InvalidRequestError(
                    f"sub_cohort_size must be in [2, {tiers_mod.MAX_SUB_COHORTS}]"
                )
            telemetry.gauge(
                "sda_tier_depth",
                "committee levels of the most recently created tiered aggregation",
            ).set(t)
        if aggregation.tier_promotion is not None:
            if aggregation.tier_promotion not in (
                tiers_mod.PROMOTION_REVEAL,
                tiers_mod.PROMOTION_RESHARE,
            ):
                raise InvalidRequestError(
                    f"tier_promotion must be "
                    f"{tiers_mod.PROMOTION_REVEAL!r} or "
                    f"{tiers_mod.PROMOTION_RESHARE!r}"
                )
            # the knob only means something on the hierarchical plane: a
            # root (tiers set) or a derived child (tier_parent set — leaves
            # carry tiers=None but still promote)
            if aggregation.tiers is None and aggregation.tier_parent is None:
                raise InvalidRequestError(
                    "tier_promotion requires a tiered aggregation"
                )
            if aggregation.tier_promotion == tiers_mod.PROMOTION_RESHARE and isinstance(
                aggregation.committee_sharing_scheme, AdditiveSharing
            ):
                # an additive clerk column has no Lagrange weight to
                # re-share by — there is no share-promotion linear map
                raise InvalidRequestError(
                    "share-promotion requires a threshold (Shamir-family) "
                    "committee sharing scheme; additive sharing promotes "
                    "by reveal only"
                )
        if aggregation.tier_parent is not None:
            parent = self.aggregation_store.get_aggregation(aggregation.tier_parent)
            if parent is None or not parent.is_tiered():
                raise InvalidRequestError(
                    "tier_parent must name an existing tiered aggregation"
                )
            children = {
                tiers_mod.child_aggregation_id(parent.id, ix)
                for ix in range(parent.sub_cohort_size)
            }
            if aggregation.id not in children:
                raise InvalidRequestError(
                    "aggregation is not a derived child of its tier_parent"
                )
        self.aggregation_store.create_aggregation(aggregation)

    def delete_aggregation(self, aggregation_id) -> None:
        # a tiered root's sub-aggregations are DERIVED state of the root
        # record (protocol/tiers.py), so deleting the root cascades over
        # every provisioned node of its tree — orphaned sub-aggregations
        # would otherwise hold participations no one can ever reveal
        agg = self.aggregation_store.get_aggregation(aggregation_id)
        if agg is not None and agg.is_tiered():
            for node in tiers_mod.iter_tier_nodes(agg):
                if node.parent is None:
                    continue
                if self.aggregation_store.get_aggregation(node.aggregation_id) is not None:
                    self.aggregation_store.delete_aggregation(node.aggregation_id)
        self.aggregation_store.delete_aggregation(aggregation_id)

    def _sodium_key_of(self, key_id, owner):
        """The registered sodium box key ``key_id`` signed by ``owner``, or
        None. The single definition of "usable clerk key": clerk transport
        is sodium sealed boxes (a Paillier key would crash participants at
        share-sealing time), and participants verify signer == clerk
        client-side (participate.py), so a key signed by anyone else
        dead-ends the aggregation just the same."""
        signed = self.agents_store.get_encryption_key(key_id)
        if (
            signed is not None
            and signed.signer == owner
            and isinstance(signed.body.body, EncryptionKey)
        ):
            return signed
        return None

    def suggest_committee(self, aggregation_id):
        if self.aggregation_store.get_aggregation(aggregation_id) is None:
            raise ServerError("aggregation not found")
        # offer only keys a participant could actually seal shares to
        # (and drop agents left with none)
        candidates = []
        for cand in self.agents_store.suggest_committee():
            usable = [k for k in cand.keys if self._sodium_key_of(k, cand.id)]
            if usable:
                candidates.append(type(cand)(id=cand.id, keys=usable))
        return candidates

    def create_committee(self, committee) -> None:
        agg = self.aggregation_store.get_aggregation(committee.aggregation)
        if agg is None:
            raise ServerError("aggregation not found")
        expected = agg.committee_sharing_scheme.output_size
        if expected != len(committee.clerks_and_keys):
            raise InvalidRequestError(
                f"Expected {expected} clerks in the committee, "
                f"found {len(committee.clerks_and_keys)} instead"
            )
        # a clerk appearing twice would map two share columns onto one
        # reconstruction index, making the aggregation unrevealable
        clerk_ids = [c for (c, _) in committee.clerks_and_keys]
        if len(set(clerk_ids)) != len(clerk_ids):
            raise InvalidRequestError("committee contains duplicate clerks")
        # suggest_committee already filters to usable keys, but the
        # invariant must hold for committees built by any client, so
        # enforce it at the accept point too (see _sodium_key_of).
        for clerk_id, key_id in committee.clerks_and_keys:
            if self._sodium_key_of(key_id, clerk_id) is None:
                raise InvalidRequestError(
                    f"committee key {key_id} of clerk {clerk_id} is not a "
                    "registered sodium box key signed by that clerk"
                )
        self.aggregation_store.create_committee(committee)

    def _validate_participation(self, participation, committee, agg, expected=None) -> None:
        # Validate the clerk-encryption list against the committee: the
        # snapshot transpose routes ciphertexts to clerks *by position*
        # (stores.iter_snapshot_clerk_jobs_data), so a short/long/misordered
        # list would crash snapshotting or silently corrupt the aggregate.
        # (The reference accepts these unchecked — a deliberate hardening.)
        # ``expected`` lets batched ingest hoist the committee's clerk list
        # out of the per-item loop; it must equal the list derived here.
        if committee is None:
            raise InvalidRequestError("no committee for aggregation")
        if expected is None:
            expected = [clerk for (clerk, _) in committee.clerks_and_keys]
        ce = participation.clerk_encryptions
        if len(ce) != len(expected):
            raise InvalidRequestError(
                "participation clerk encryptions do not match the committee"
            )
        # one pass over the row: order against the committee, and clerk
        # transport is sodium — a mis-tagged ciphertext would only surface
        # as an opaque clerk-side decrypt failure later
        for (clerk, e), want in zip(ce, expected):
            if clerk != want:
                raise InvalidRequestError(
                    "participation clerk encryptions do not match the committee"
                )
            if e.variant != "Sodium":
                raise InvalidRequestError(
                    "clerk encryptions must be sodium sealed boxes"
                )
        self._validate_recipient_encryption(participation, agg)
        if participation.tier_reshare is not None:
            self._validate_tier_reshare(participation, agg)

    def _validate_recipient_encryption(self, participation, agg) -> None:
        """Shape-check the recipient (mask) ciphertext at the door. For
        Paillier the wire format is public, so a garbage blob — which would
        otherwise surface only at snapshot-combine or recipient-decrypt
        time, after the participant's shares are in the aggregate — is
        rejected here. Sodium sealed boxes are opaque; only the variant tag
        can be checked."""
        enc = participation.recipient_encryption
        if enc is None:
            return
        if agg is None:
            return  # caller's store write will surface the missing aggregation
        scheme = agg.recipient_encryption_scheme
        if not isinstance(scheme, PackedPaillierEncryptionScheme):
            if enc.variant != "Sodium":
                raise InvalidRequestError(
                    "recipient encryption must be a sodium sealed box"
                )
            return
        from ..crypto.encryption import paillier_ciphertext_well_formed

        signed = self.agents_store.get_encryption_key(agg.recipient_key)
        if signed is None:
            return  # can't check without the key; combine falls back safely
        if not paillier_ciphertext_well_formed(
            enc, signed.body.body, scheme, agg.vector_dimension
        ):
            raise InvalidRequestError("malformed Paillier recipient encryption")

    def _validate_tier_reshare(self, participation, agg) -> None:
        """Gate share-promotion rows at the door: a tagged row must target
        a tiered parent, name one of its derived children, carry a sane
        epoch/position/survivor set, and be submitted by the identity the
        tag claims (the child's clerk at ``position``, or the child's
        owner for the mask-correction row). Late rows — arriving after the
        parent froze a snapshot — are rejected so the prepare stage's
        epoch resolution stays pinned."""
        tag = participation.tier_reshare
        if agg is None:
            return  # the store write will surface the missing aggregation
        if not agg.is_tiered():
            raise InvalidRequestError(
                "tier_reshare rows may only target tiered aggregations"
            )
        children = {
            tiers_mod.child_aggregation_id(agg.id, ix)
            for ix in range(agg.sub_cohort_size)
        }
        if tag.child not in children:
            raise InvalidRequestError(
                "tier_reshare child is not a derived child of the aggregation"
            )
        if not 0 <= tag.epoch < tiers_mod.MAX_RESHARE_EPOCHS:
            raise InvalidRequestError(
                f"tier_reshare epoch must be in [0, {tiers_mod.MAX_RESHARE_EPOCHS})"
            )
        child = self.aggregation_store.get_aggregation(tag.child)
        if child is None:
            raise InvalidRequestError(
                "tier_reshare child aggregation is not provisioned"
            )
        if tag.position is None:
            # mask-correction row: the child's owner cancels its
            # sub-cohort's mask sum one tier up
            if tag.survivors is not None:
                raise InvalidRequestError(
                    "tier_reshare mask rows carry no survivor set"
                )
            if not agg.masking_scheme.has_mask():
                raise InvalidRequestError(
                    "tier_reshare mask row for a maskless aggregation"
                )
            if participation.participant != child.recipient:
                raise InvalidRequestError(
                    "tier_reshare mask row must come from the child's owner"
                )
        else:
            n = child.committee_sharing_scheme.output_size
            threshold = child.committee_sharing_scheme.reconstruction_threshold
            survivors = tag.survivors
            if survivors is None:
                raise InvalidRequestError(
                    "tier_reshare column rows must carry their survivor set"
                )
            if len(set(survivors)) != len(survivors) or any(
                not 0 <= s < n for s in survivors
            ):
                raise InvalidRequestError(
                    "tier_reshare survivors must be distinct committee positions"
                )
            if len(survivors) < threshold:
                raise InvalidRequestError(
                    f"tier_reshare survivor set below the reconstruction "
                    f"threshold {threshold}"
                )
            if tag.position not in survivors:
                raise InvalidRequestError(
                    "tier_reshare position must be among the survivors"
                )
            child_committee = self.aggregation_store.get_committee(tag.child)
            if child_committee is None:
                raise InvalidRequestError(
                    "tier_reshare child has no committee"
                )
            clerk, _ = child_committee.clerks_and_keys[tag.position]
            if participation.participant != clerk:
                raise InvalidRequestError(
                    "tier_reshare column row must come from the child's "
                    "clerk at the claimed position"
                )
        if self.aggregation_store.list_snapshots(participation.aggregation):
            raise InvalidRequestError(
                "tier_reshare row arrived after the aggregation snapshotted"
            )

    def create_participation(self, participation) -> None:
        committee = self.aggregation_store.get_committee(participation.aggregation)
        agg = self.aggregation_store.get_aggregation(participation.aggregation)
        self._validate_participation(participation, committee, agg)
        self.aggregation_store.create_participation(participation)
        self._count_promotion(agg, [participation])

    def create_participations(self, participations) -> None:
        """Batched ingest: every item passes the exact single-item checks
        (committee order, sodium variants, recipient-ciphertext shape),
        with committee/aggregation lookups amortized per aggregation, then
        ONE bulk store write — which rejects atomically, so one invalid
        participation stores nothing from the batch."""
        participations = list(participations)
        committees: dict = {}
        expected: dict = {}
        aggs: dict = {}
        for p in participations:
            a = p.aggregation
            if a not in committees:
                committees[a] = self.aggregation_store.get_committee(a)
                aggs[a] = self.aggregation_store.get_aggregation(a)
                if committees[a] is not None:
                    expected[a] = [clerk for (clerk, _) in committees[a].clerks_and_keys]
            self._validate_participation(p, committees[a], aggs[a], expected.get(a))
        self.aggregation_store.create_participations(participations)
        for a, agg in aggs.items():
            self._count_promotion(agg, [p for p in participations if p.aggregation == a])

    @staticmethod
    def _count_promotion(agg, participations) -> None:
        """Every participation accepted into a TIERED aggregation is a
        promotion by construction: real participants route to leaf
        sub-aggregations (which are flat), so anything landing on a node
        with tiers > 1 is a sub-cohort's partial climbing one level
        (client/tiers.py). ``path`` distinguishes the reveal-promotion rows
        (untagged re-submissions of a reconstructed partial) from
        share-promotion rows (tier_reshare-tagged columns + mask
        corrections)."""
        if agg is None or not agg.is_tiered():
            return
        counts: dict = {}
        for p in participations:
            path = "reshare" if p.tier_reshare is not None else "reveal"
            counts[path] = counts.get(path, 0) + 1
        for path, n in counts.items():
            telemetry.counter(
                "sda_tier_promotions_total",
                "partial-sum promotions accepted into parent-tier aggregations",
                tier=str(agg.tiers),
                path=path,
            ).inc(n)

    def get_aggregation_status(self, aggregation_id) -> Optional[AggregationStatus]:
        agg = self.aggregation_store.get_aggregation(aggregation_id)
        if agg is None:
            return None
        snapshots = []
        for snap_id in self.aggregation_store.list_snapshots(aggregation_id):
            results_count = len(self.clerking_job_store.list_results(snap_id))
            snapshots.append(
                SnapshotStatus(
                    id=snap_id,
                    number_of_clerking_results=results_count,
                    result_ready=results_count
                    >= agg.committee_sharing_scheme.reconstruction_threshold,
                )
            )
        return AggregationStatus(
            aggregation=aggregation_id,
            number_of_participations=self.aggregation_store.count_participations(
                aggregation_id
            ),
            snapshots=snapshots,
        )

    def get_tier_status(self, aggregation_id) -> Optional[TierStatus]:
        """Readiness of every node of a tiered aggregation's derived tree,
        BFS order root first — the recipient's one-call view of how far the
        bottom-up round has climbed. None for flat/unknown aggregations.
        The tree is enumerated from the root record alone (protocol/
        tiers.py); nodes the round driver has not provisioned yet report
        ``exists=False``."""
        agg = self.aggregation_store.get_aggregation(aggregation_id)
        if agg is None or not agg.is_tiered():
            return None
        nodes = []
        for node in tiers_mod.iter_tier_nodes(agg):
            st = self.get_aggregation_status(node.aggregation_id)
            nodes.append(
                TierNodeStatus(
                    aggregation=node.aggregation_id,
                    tier=node.tier,
                    parent=node.parent,
                    exists=st is not None,
                    number_of_participations=0
                    if st is None
                    else st.number_of_participations,
                    result_ready=st is not None
                    and any(s.result_ready for s in st.snapshots),
                )
            )
        return TierStatus(
            aggregation=aggregation_id,
            tiers=agg.tiers,
            sub_cohort_size=agg.sub_cohort_size,
            nodes=nodes,
        )

    def create_snapshot(self, snapshot) -> None:
        snapshot_mod.run_snapshot(self, snapshot)

    # -- clerking ------------------------------------------------------------

    def poll_clerking_job(self, clerk_id):
        return self.clerking_job_store.poll_clerking_job(clerk_id)

    def get_clerking_job(self, clerk_id, job_id):
        return self.clerking_job_store.get_clerking_job(clerk_id, job_id)

    def get_clerking_job_chunk(self, clerk_id, job_id, start, count):
        return self.clerking_job_store.get_clerking_job_chunk(
            clerk_id, job_id, start, count
        )

    def create_clerking_result(self, result) -> None:
        self.clerking_job_store.create_clerking_result(result)

    def complete_clerking_job(self, clerk_id, job_id) -> None:
        self.clerking_job_store.complete_clerking_job(clerk_id, job_id)

    def get_snapshot_result(self, aggregation_id, snapshot_id) -> Optional[SnapshotResult]:
        # The snapshot must exist AND belong to this aggregation — otherwise
        # a recipient could read another aggregation's results through their
        # own ACL check (the reference marks this hole "FIXME no
        # aggregation/snapshot spoofing", server.rs:324; fixed here).
        if self.aggregation_store.get_snapshot(aggregation_id, snapshot_id) is None:
            return None
        number_of_participations = self.aggregation_store.count_participations_snapshot(
            aggregation_id, snapshot_id
        )
        # wire shape decided per CALL from the current threshold (the
        # stored layout was decided at write time; either serves both):
        # above it, answer metadata only and let the recipient stream the
        # two payloads through the range routes
        mask_count = self.aggregation_store.count_snapshot_mask(snapshot_id)
        clerk_count = self.clerking_job_store.count_results(snapshot_id)
        if (mask_count or 0) + clerk_count > stores.result_page_threshold():
            return SnapshotResult(
                snapshot=snapshot_id,
                number_of_participations=number_of_participations,
                clerk_encryptions=[],
                recipient_encryptions=None,
                mask_encryption_count=mask_count,
                clerk_result_count=clerk_count,
                chunk_size=stores.result_chunk_size(),
            )
        # one bulk read (backends: single query/scan) — the old
        # list_results + get_result-per-job loop was an N+1
        results = self.clerking_job_store.get_results(snapshot_id)
        return SnapshotResult(
            snapshot=snapshot_id,
            number_of_participations=number_of_participations,
            clerk_encryptions=results,
            recipient_encryptions=self.aggregation_store.get_snapshot_mask(snapshot_id),
        )

    def get_snapshot_result_masks(self, aggregation_id, snapshot_id, start, count):
        # same anti-spoofing gate as get_snapshot_result
        if self.aggregation_store.get_snapshot(aggregation_id, snapshot_id) is None:
            return None
        return self.aggregation_store.get_snapshot_mask_range(snapshot_id, start, count)

    def get_snapshot_result_clerks(self, aggregation_id, snapshot_id, start, count):
        if self.aggregation_store.get_snapshot(aggregation_id, snapshot_id) is None:
            return None
        return self.clerking_job_store.get_results_range(snapshot_id, start, count)

    # -- auth ----------------------------------------------------------------

    def upsert_auth_token(self, token) -> None:
        self.auth_tokens_store.upsert_auth_token(token)

    def register_auth_token(self, token) -> None:
        """Trust-on-first-use registration: the first token presented for an
        agent id sticks; later attempts with a different token are rejected
        (otherwise anyone could re-post a public Agent object and hijack the
        account by overwriting its token). Delegated to the store as one
        atomic check-and-write."""
        if not self.auth_tokens_store.register_auth_token(token):
            _count_rejection("auth_token")
            raise InvalidCredentialsError("agent already registered")

    def check_auth_token(self, token):
        import hmac

        stored = self.auth_tokens_store.get_auth_token(token.id)
        # constant-time secret compare: a `==` on the token body leaks a
        # prefix-length timing oracle on a network-facing auth path (the
        # SDA server itself compares with ==, server.rs:174-186). Compared
        # as the body's canonical BYTES: a str() coercion would make any
        # non-string body with a matching repr authenticate, and would
        # diverge from what register_auth_token actually persisted.
        if stored is not None and hmac.compare_digest(
            _token_body_bytes(stored.body), _token_body_bytes(token.body)
        ):
            agent = self.agents_store.get_agent(token.id)
            if agent is None:
                _count_rejection("auth_token")
                raise InvalidCredentialsError("Agent not found")
            return agent
        _count_rejection("auth_token")
        raise InvalidCredentialsError("invalid token")

    def delete_auth_token(self, agent_id) -> None:
        self.auth_tokens_store.delete_auth_token(agent_id)


def _token_body_bytes(body) -> bytes:
    """Canonical byte encoding of an auth-token secret. Only the two wire
    shapes are comparable; anything else fails closed as a bad credential
    rather than being repr()-flattened into something comparable."""
    if isinstance(body, bytes):
        return bytes(body)
    if isinstance(body, str):
        return body.encode("utf-8")
    raise InvalidCredentialsError("malformed auth token")


def _count_rejection(check: str) -> None:
    telemetry.counter(
        "sda_acl_rejections_total", "denied service calls by ACL check", check=check
    ).inc()


def _acl_agent_is(caller, agent_id) -> None:
    if caller.id != agent_id:
        _count_rejection("agent_is")
        raise PermissionDeniedError(f"caller {caller.id} is not {agent_id}")


class SdaServerService(SdaService):
    """ACL wrapper: the in-process implementation of the service seam."""

    def __init__(self, server: SdaServer):
        self.server = server

    def ping(self):
        return self.server.ping()

    # -- agents (ACL: caller must be the subject on writes) -------------------

    def create_agent(self, caller, agent) -> None:
        _acl_agent_is(caller, agent.id)
        self.server.create_agent(agent)

    def get_agent(self, caller, agent_id):
        return self.server.get_agent(agent_id)

    def upsert_profile(self, caller, profile) -> None:
        _acl_agent_is(caller, profile.owner)
        self.server.upsert_profile(profile)

    def get_profile(self, caller, owner_id):
        return self.server.get_profile(owner_id)

    def create_encryption_key(self, caller, signed_key) -> None:
        _acl_agent_is(caller, signed_key.signer)
        self.server.create_encryption_key(signed_key)

    def get_encryption_key(self, caller, key_id):
        return self.server.get_encryption_key(key_id)

    # -- aggregations (public reads) ------------------------------------------

    def list_aggregations(self, caller, filter=None, recipient=None):
        return self.server.list_aggregations(filter, recipient)

    def get_aggregation(self, caller, aggregation_id):
        return self.server.get_aggregation(aggregation_id)

    def get_committee(self, caller, aggregation_id):
        return self.server.get_committee(aggregation_id)

    # -- recipient routes (ACL: caller must be the recipient) ------------------

    def _acl_recipient(self, caller, aggregation_id):
        agg = self.server.get_aggregation(aggregation_id)
        if agg is None:
            raise ServerError("No aggregation found")
        _acl_agent_is(caller, agg.recipient)
        return agg

    def create_aggregation(self, caller, aggregation) -> None:
        _acl_agent_is(caller, aggregation.recipient)
        self.server.create_aggregation(aggregation)

    def delete_aggregation(self, caller, aggregation_id) -> None:
        self._acl_recipient(caller, aggregation_id)
        self.server.delete_aggregation(aggregation_id)

    def suggest_committee(self, caller, aggregation_id):
        self._acl_recipient(caller, aggregation_id)
        return self.server.suggest_committee(aggregation_id)

    def create_committee(self, caller, committee) -> None:
        self._acl_recipient(caller, committee.aggregation)
        self.server.create_committee(committee)

    def get_aggregation_status(self, caller, aggregation_id):
        self._acl_recipient(caller, aggregation_id)
        return self.server.get_aggregation_status(aggregation_id)

    def get_tier_status(self, caller, aggregation_id):
        self._acl_recipient(caller, aggregation_id)
        return self.server.get_tier_status(aggregation_id)

    def create_snapshot(self, caller, snapshot) -> None:
        self._acl_recipient(caller, snapshot.aggregation)
        self.server.create_snapshot(snapshot)

    def get_snapshot_result(self, caller, aggregation_id, snapshot_id):
        self._acl_recipient(caller, aggregation_id)
        return self.server.get_snapshot_result(aggregation_id, snapshot_id)

    def get_snapshot_result_masks(self, caller, aggregation_id, snapshot_id, start):
        self._acl_recipient(caller, aggregation_id)
        count = stores.result_chunk_size()
        return self.server.get_snapshot_result_masks(
            aggregation_id, snapshot_id, start, count
        )

    def get_snapshot_result_clerks(self, caller, aggregation_id, snapshot_id, start):
        self._acl_recipient(caller, aggregation_id)
        count = stores.result_chunk_size()
        return self.server.get_snapshot_result_clerks(
            aggregation_id, snapshot_id, start, count
        )

    # -- participation ---------------------------------------------------------

    def create_participation(self, caller, participation) -> None:
        _acl_agent_is(caller, participation.participant)
        self.server.create_participation(participation)

    def create_participations(self, caller, participations) -> None:
        # the same ACL gate as singles, applied to EVERY item before any
        # validation or storage work happens
        participations = list(participations)
        for p in participations:
            _acl_agent_is(caller, p.participant)
        self.server.create_participations(participations)

    # -- clerking --------------------------------------------------------------

    def get_clerking_job(self, caller, clerk_id):
        _acl_agent_is(caller, clerk_id)
        return self.server.poll_clerking_job(clerk_id)

    def get_clerking_job_chunk(self, caller, job_id, start):
        # ownership is implied: the store's chunk lookup is keyed by
        # (clerk, job) and answers None unless the CALLER owns the job —
        # another clerk's job id reads as not-found, never as data
        count = stores.job_chunk_size()
        return self.server.get_clerking_job_chunk(caller.id, job_id, start, count)

    def create_clerking_result(self, caller, result) -> None:
        # double check the job really belongs to the caller (server.rs:351-360)
        job = self.server.get_clerking_job(result.clerk, result.job)
        if job is None:
            raise ServerError("Job not found")
        _acl_agent_is(caller, job.clerk)
        self.server.create_clerking_result(result)

    def complete_clerking_job(self, caller, job_id) -> None:
        # same ownership check as create_clerking_result: the job must
        # exist and belong to the caller before it can be retired
        job = self.server.get_clerking_job(caller.id, job_id)
        if job is None:
            raise ServerError("Job not found")
        _acl_agent_is(caller, job.clerk)
        self.server.complete_clerking_job(job.clerk, job_id)
