"""Hierarchical round driver: provision the derived tree, run it bottom-up
(counterpart of ``sda_tpu/client/tiers.py``).

The client half of tiered aggregation (arXiv 2201.00864 via
protocol/tiers.py): a tiered aggregation is a TREE of ordinary
aggregations, and a round is the flat pipeline run once per node —
leaves first — with each sub-committee's aggregate PROMOTED one tier up
as ordinary participations of the parent. The server never cascades
anything; this module sequences the tree client-side, exactly like the
flat flow sequences begin/participate/end/clerk/reveal.

Two promotion paths (``protocol.tiers.effective_promotion``):

* **Share-promotion** (``reshare`` — the default for Shamir-family
  committee schemes): each sub-committee clerk expands its combined
  share column through the precomputed Lagrange re-share row
  (ops/shamir.reshare_coefficients / reshare_column) and submits the
  result directly to the PARENT as an ordinary tagged participation
  (client/clerk.py). The node's owner only submits a mask-correction
  row — ``(m - sum of the sub-cohort's masks) % m`` — so the child-level
  masks telescope out of the reshared columns; it never sees any
  partial sum (the mask sum is data-independent). No plaintext exists
  anywhere between the participants and the root recipient.

* **Reveal-promotion** (``reveal`` — additive committees, and the A/B
  baseline behind ``tier_promotion="reveal"``): the node's owner acts as
  the sub-aggregation's recipient, reveals the sub-cohort partial, and
  re-submits it to the parent. The owner sees the partial in the clear;
  kept only because additive sharing has no Lagrange structure to
  re-share through, and for benchmarking the old path.

Exactness: every tier sums in the same modular group, so the root reveal
equals the flat reveal byte-for-byte under either path (re-shared
columns are exact share expansions of the sub-cohort sum; revealed
partials are lifted to [0, m) with ``.positive()`` before promotion —
tests/test_tiers.py holds the equality across schemes, stores, and
transports, and tests/test_torch_tiers.py holds the port to it).

Dropout tolerance composes per tier and now ACROSS tiers: within a
sub-committee, Shamir-family sharing survives down to
``reconstruction_threshold`` clerks — under share-promotion the
surviving clerks re-issue their cached columns against the survivor set
(epoch 1) and the parent's prepare stage keeps exactly one consistent
epoch per child (server/snapshot.py). A sub-cohort that falls below
threshold is absent from the parent's cut under ``strict=False``, and
the root reveals the exact sum of the survivors.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .. import telemetry
from ..protocol import SdaError, TierReshare
from ..protocol import tiers as tiers_mod
from ..utils import workpool
from ..utils.faults import Backoff
from .committee import run_committee
from .receive import RecipientOutput

# driver-side critical-path latency of promoting one node into its
# parent, labelled by path — the share-promotion A/B headline. Under
# ``reveal`` a sample covers reveal_aggregation + promote_partial (mask
# fold + clerk-column fetch/decrypt/reconstruct + re-submit); under
# ``reshare`` it covers only the mask-correction row (and any epoch-1
# re-issue), since the column expansion rides the clerk drain off the
# driver's critical path (client/clerk.py, sda_tier_reshare_seconds).
# Samples are observed on SUCCESS only: an aborted promotion (skipped
# under ``strict=False``) must never drag the per-path averages.
_PROMOTE_SERIES = "sda_tier_promote_seconds"
_PROMOTE_HELP = "driver-side per-node tier promotion latency by path"

# wall seconds spent closing+promoting one whole tier level, labelled by
# dispatch mode — the serial-vs-fanout A/B series
_CLOSE_SERIES = "sda_tier_close_seconds"
_CLOSE_HELP = "per-tier-level close+promote wall seconds by dispatch mode"
_FANOUT_SERIES = "sda_tier_fanout_nodes"
_FANOUT_HELP = "sibling-node tasks dispatched concurrently in the last tier level"


def tier_fanout(nodes: int) -> int:
    """Concurrent sibling-node width for one tier level.

    ``SDA_TIER_FANOUT`` in the environment, else ``2 x`` the crypto
    pool's worker count (``SDA_WORKERS`` / cpu count) — sibling closes
    are REST round-trips plus server-side snapshot staging on *other*
    processes, so the driver profitably holds more requests in flight
    than it has cores. Always clamped to the node count;
    ``SDA_TIER_FANOUT=1`` is the kill switch: ``run_tier_round`` takes
    the exact legacy serial loop, bit for bit.
    """
    raw = os.environ.get("SDA_TIER_FANOUT")
    if raw:
        try:
            width = max(1, int(raw))
        except ValueError:
            raise ValueError(
                f"SDA_TIER_FANOUT must be an integer, got {raw!r}"
            ) from None
    else:
        width = 2 * workpool.workers()
    return max(1, min(nodes, width))


def _poll_backoff(poll_interval: float) -> Backoff:
    """Full-jitter schedule for the external-daemon poll loops — the
    REST client's policy: start at the configured interval, double
    toward a ~2 s idle cap, ``reset()`` whenever a poll observes
    progress so an active tier drains at ``poll_interval`` cadence while
    a stalled daemon is probed at most every couple of seconds."""
    return Backoff(base=poll_interval, cap=max(2.0, poll_interval))


@dataclass
class TierRoundNode:
    """One provisioned node: its topology position, the stored
    sub-aggregation record, the client that owns it (root recipient or
    promoter), its committee's clerk clients, and the frontend index the
    pure placement function assigns its traffic (0 on single-frontend
    deployments)."""

    node: tiers_mod.TierNode
    aggregation: object
    owner: object
    clerks: list
    frontend: int = 0


@dataclass
class TierRound:
    """A fully provisioned tiered round: root record, real recipient, and
    every node of the derived tree (breadth-first, root first — the order
    ``protocol.tiers.iter_tier_nodes`` enumerates)."""

    root: object
    recipient: object
    nodes: list

    def node(self, aggregation_id) -> Optional[TierRoundNode]:
        for tn in self.nodes:
            if tn.aggregation.id == aggregation_id:
                return tn
        return None

    def leaves(self) -> list:
        return [tn for tn in self.nodes if tn.node.is_leaf_of(self.root)]


@dataclass
class TierRoundResult:
    """Outcome of ``run_tier_round``: the root reveal plus the
    sub-aggregations skipped under ``strict=False`` (vanished sub-cohorts
    or unrevealable sub-committees — the root total is the exact sum over
    everything that did promote)."""

    output: RecipientOutput
    skipped: list = field(default_factory=list)


def setup_tier_round(
    recipient,
    aggregation,
    new_promoter: Callable[[str], object],
    clerk_pool: list,
    *,
    disjoint_committees: bool = False,
    frontends: int = 1,
) -> TierRound:
    """Provision the whole derived tree of a tiered ``aggregation``:
    upload the root, derive + upload every sub-aggregation (parents
    first), register one fresh promoter per non-root node, and elect
    every node's committee from ``clerk_pool``.

    ``new_promoter(name)`` must return a FRESH, unregistered client
    (e.g. tests' ``new_client``); this function uploads its agent and
    sodium key — the key the derived child record pins as its
    recipient key. ``clerk_pool`` entries are registered clerk clients
    that have already uploaded signed encryption keys (i.e. committee
    candidates). Committees are consecutive slices of the pool, wrapping
    — with ``disjoint_committees`` the pool must be large enough that no
    clerk serves two nodes (the deployment shape the paper's per-clerk
    bound assumes; a wrapped pool still COMPUTES correctly, each clerk
    just works more than one node's share).

    ``frontends`` is the frontend-process count of the deployment the
    round runs against: each node is stamped with its deterministic
    frontend index (``protocol.tiers.tier_placement``) so launchers can
    place per-node committee daemons next to the frontend that will
    serve their node's traffic.
    """
    if not aggregation.is_tiered():
        raise ValueError("setup_tier_round requires a tiered aggregation")
    topology = tiers_mod.iter_tier_nodes(aggregation)
    placement = tiers_mod.tier_placement(aggregation, frontends)
    size = aggregation.committee_sharing_scheme.output_size
    if disjoint_committees:
        if len(clerk_pool) < size * len(topology):
            raise ValueError(
                f"disjoint committees need {size * len(topology)} clerks, "
                f"pool has {len(clerk_pool)}"
            )
    elif len(clerk_pool) < size:
        raise ValueError(
            f"clerk pool smaller than one committee ({len(clerk_pool)} < {size})"
        )

    recipient.upload_aggregation(aggregation)
    records = {aggregation.id: aggregation}
    nodes = []
    for position, node in enumerate(topology):
        if node.parent is None:
            agg, owner = aggregation, recipient
        else:
            promoter = new_promoter(f"tier{node.tier}-sub{position}")
            promoter.upload_agent()
            promoter_key = promoter.new_encryption_key()
            promoter.upload_encryption_key(promoter_key)
            agg = tiers_mod.child_aggregation(
                records[node.parent], node.index, promoter.agent.id, promoter_key
            )
            promoter.upload_aggregation(agg)
            records[agg.id] = agg
            owner = promoter
        clerks = [
            clerk_pool[(position * size + j) % len(clerk_pool)] for j in range(size)
        ]
        owner.begin_aggregation(agg.id, chosen_clerks=[c.agent.id for c in clerks])
        nodes.append(
            TierRoundNode(
                node=node,
                aggregation=agg,
                owner=owner,
                clerks=clerks,
                frontend=placement[agg.id],
            )
        )
    return TierRound(root=aggregation, recipient=recipient, nodes=nodes)


def promote_partial(promoter, values, parent_aggregation_id):
    """Submit a revealed sub-cohort partial sum as an ordinary
    participation of the PARENT tier. ``route=False`` is the whole trick:
    a promoter targets its parent node directly instead of being hashed
    down to a leaf like a real participant. Returns the participation id
    (idempotently replayable like any other participation)."""
    parts = promoter.new_participations(
        [values], parent_aggregation_id, route=False
    )
    promoter.upload_participations(parts)
    return parts[0].id


def promote_mask_correction(
    owner, node_aggregation, parent_aggregation_id, snapshot_id=None
):
    """Share-promotion's entire owner-side job: fold the node's snapshot
    mask sum (data-independent — the owner learns nothing about the
    values) and submit ``(m - mask_sum) % m`` to the parent as a tagged
    ordinary participation, cancelling the child-level masks still
    embedded in the clerks' re-shared columns. No-op when the node's
    masking scheme carries no mask. The row's id is deterministic
    (``protocol.tiers.reshare_participation_id``) so replays collide
    idempotently; returns the participation id, or None when skipped.
    ``snapshot_id`` (``end_aggregation``'s return) skips the
    status/record rediscovery round-trips on this critical path."""
    if not node_aggregation.masking_scheme.has_mask():
        return None
    mask = owner.combined_snapshot_mask(
        node_aggregation.id, aggregation=node_aggregation, snapshot_id=snapshot_id
    )
    if mask.size == 0:
        # empty sub-cohort under a sealed-mask scheme: nothing was
        # folded, the correction is exactly zero
        mask = np.zeros(node_aggregation.vector_dimension, dtype=np.int64)
    correction = (node_aggregation.modulus - mask) % node_aggregation.modulus
    tag = TierReshare(child=node_aggregation.id, epoch=0)
    pid = tiers_mod.reshare_participation_id(node_aggregation.id, 0)
    parts = owner.new_participations(
        [correction], parent_aggregation_id, route=False, ids=[pid], tier_reshare=tag
    )
    try:
        owner.upload_participations(parts)
    except Exception as e:
        if "already exists" not in str(e):
            raise
    return pid


def _await_results(entries, poll_interval: float, deadline: float) -> None:
    """External-clerks drain: the committees run as separate ``sdad
    committee`` daemon processes over the wire, so instead of running
    the clerk loop in-process this polls each node's aggregation status
    until its snapshot reports ``result_ready`` (results count reached
    the reconstruction threshold) — the exact condition the reveal
    needs. Raises TimeoutError past ``deadline`` so a dead daemon fails
    the round loudly instead of spinning forever. Polls ride the shared
    full-jitter :class:`Backoff` (reset whenever a node turns ready), so
    a long wait on slow daemons converges to ~2 s probes instead of
    hammering every ``poll_interval``."""
    waiting = list(entries)
    backoff = _poll_backoff(poll_interval)
    while waiting:
        still = []
        for tn in waiting:
            status = tn.owner.service.get_aggregation_status(
                tn.owner.agent, tn.aggregation.id
            )
            ready = status is not None and any(
                s.result_ready for s in status.snapshots
            )
            if not ready:
                still.append(tn)
        if len(still) < len(waiting):
            backoff.reset()  # progress: stay at the base cadence
        waiting = still
        if not waiting:
            return
        if time.monotonic() > deadline:
            ids = [str(tn.aggregation.id) for tn in waiting]
            raise TimeoutError(
                f"external committees did not finish clerking: {ids}"
            )
        backoff.sleep()


def _drain_clerks(entries, max_iterations: int) -> None:
    # one clerk client may serve several nodes' committees (wrapped
    # pool); drain each AGENT once per tier or the same durable queue
    # would be polled by several equivalent client objects
    seen, clerks = set(), []
    for tn in entries:
        for clerk in tn.clerks:
            if clerk.agent.id not in seen:
                seen.add(clerk.agent.id)
                clerks.append(clerk)
    run_committee(clerks, max_iterations)


def _ensure_reshared(tn: TierRoundNode) -> None:
    """In-process survivor check after a share-promotion drain: if every
    committee clerk is still attached to the node, the epoch-0 columns
    (full committee, exact by construction) already landed in the parent
    and nothing remains. Otherwise the survivors — who each cached their
    combined column while processing their clerking job — re-issue
    against the surviving position set as epoch 1; the parent's prepare
    stage keeps the highest complete epoch and discards the rest. Raises
    SdaError when the survivors cannot reconstruct (below threshold):
    the caller skips or aborts per ``strict``."""
    scheme = tn.aggregation.committee_sharing_scheme
    if len(tn.clerks) == scheme.output_size:
        # full committee still attached (setup elected exactly these
        # clerks): the epoch-0 columns already landed during the drain,
        # so skip the committee fetch on the no-death fast path
        return
    committee = tn.owner.service.get_committee(tn.owner.agent, tn.aggregation.id)
    if committee is None:
        raise SdaError(f"no committee for tier node {tn.aggregation.id}")
    positions = {
        clerk_id: ix for ix, (clerk_id, _) in enumerate(committee.clerks_and_keys)
    }
    survivors = sorted(
        positions[c.agent.id] for c in tn.clerks if c.agent.id in positions
    )
    if len(survivors) == scheme.output_size:
        return
    if len(survivors) < scheme.reconstruction_threshold:
        raise SdaError(
            f"tier node {tn.aggregation.id}: {len(survivors)} surviving "
            f"clerks cannot re-share (threshold "
            f"{scheme.reconstruction_threshold})"
        )
    for clerk in tn.clerks:
        if clerk.agent.id in positions:
            clerk.reshare_tier_child(tn.aggregation, survivors, epoch=1)


def _await_promotions(
    round: TierRound,
    entries,
    poll_interval: float,
    deadline: float,
    strict: bool,
    skipped: list,
) -> None:
    """External-clerks wait for share-promotion: the committees run as
    separate daemons, so the driver polls each PARENT's participation
    count until every live child's promotion rows have landed —
    ``share_count`` tagged columns per child plus one mask-correction
    row when the scheme masks. Children never turn ``result_ready``
    under share-promotion (their clerks submit upward instead of sealing
    clerking results), which is why this polls the parent instead of
    ``_await_results``. On timeout, ``strict`` raises; otherwise the
    round proceeds and the parent's prepare stage drops whichever
    children stayed incomplete — which child stalled cannot be
    attributed from out here (the count is per parent), so every child
    of a stalled parent is recorded in ``skipped`` conservatively; the
    root total remains the exact sum over the complete children."""
    per_child = round.root.committee_sharing_scheme.output_size
    if round.root.masking_scheme.has_mask():
        per_child += 1
    by_parent: dict = {}
    for tn in entries:
        by_parent.setdefault(tn.node.parent, []).append(tn)
    waiting = {parent: len(children) * per_child for parent, children in by_parent.items()}
    backoff = _poll_backoff(poll_interval)
    while waiting:
        done = []
        for parent_id, expected in waiting.items():
            owner = round.node(parent_id).owner
            status = owner.service.get_aggregation_status(owner.agent, parent_id)
            if status is not None and status.number_of_participations >= expected:
                done.append(parent_id)
        for parent_id in done:
            del waiting[parent_id]
        if done:
            backoff.reset()  # progress: stay at the base cadence
        if not waiting:
            return
        if time.monotonic() > deadline:
            ids = [str(p) for p in waiting]
            if strict:
                raise TimeoutError(
                    f"tier promotions did not land in parents: {ids}"
                )
            for parent_id in waiting:
                for tn in by_parent[parent_id]:
                    skipped.append(tn.aggregation.id)
            return
        backoff.sleep()


def _gather(entries, outcomes, strict: bool, skipped: list) -> list:
    """Fold fanned-out per-node outcomes back into the serial loop's
    exact semantics, in NODE-INDEX order regardless of completion order:
    under ``strict`` the lowest-index failure re-raises (its outstanding
    siblings were cancelled by the pool); otherwise failed nodes land in
    ``skipped`` and the survivors come back in order."""
    if strict:
        for out in outcomes:
            if out.error is not None:
                raise out.error
    live = []
    for tn, out in zip(entries, outcomes):
        if out.error is not None or out.cancelled:
            skipped.append(tn.aggregation.id)
        else:
            live.append(tn)
    return live


def _note_overlap(span_record, outcomes, wall: float, width: int) -> None:
    """Per-tier overlap efficiency onto the enclosing span's attrs —
    busy task seconds over ``wall x width``, 1.0 meaning the fanned-out
    siblings kept every lane busy the whole time."""
    if span_record is None or wall <= 0 or width <= 0:  # telemetry off
        return
    busy = sum(o.seconds for o in outcomes if not o.cancelled)
    span_record["attrs"]["overlap_efficiency"] = round(
        min(1.0, busy / (wall * width)), 4
    )


def run_tier_round(
    round: TierRound,
    *,
    max_iterations: int = -1,
    strict: bool = True,
    external_clerks: bool = False,
    poll_interval: float = 0.1,
    poll_timeout: float = 120.0,
) -> TierRoundResult:
    """Run a provisioned tiered round bottom-up and reveal the root.

    Per tier, deepest first: close every node (freezing its sub-cohort's
    participations into a snapshot), then promote it into the parent
    along the round's path (``protocol.tiers.effective_promotion``):

    * ``reshare`` (default for Shamir-family schemes): the node's owner
      submits only the mask-correction row; the tier's clerks — drained
      next — expand their combined columns through the Lagrange re-share
      row straight into the parent (client/clerk.py). After the drain,
      ``_ensure_reshared`` re-issues from the survivors (epoch 1) when
      clerks died, so the round survives any sub-committee down to its
      reconstruction threshold without anyone revealing a partial.

    * ``reveal`` (additive committees / A/B baseline): drain the tier's
      clerks, then each owner reveals its partial sum — lifted to
      ``[0, modulus)`` — and re-submits it to the parent.

    The root closes last, over exactly its children's promotions, and
    the real recipient reveals the total. Per-node promotion latency is
    observed into ``sda_tier_promote_seconds{path=...}`` either way.

    ``strict=False`` tolerates failed sub-aggregations (vanished
    sub-cohort, sub-committee below threshold): they are recorded in
    ``TierRoundResult.skipped`` and the root reveals the exact sum of
    the survivors. Under ``strict=True`` any sub-tier failure raises.

    ``external_clerks=True`` is the process-spanning mode: committees
    run as separate ``sdad committee`` daemons over the wire, so the
    driver never runs a clerk loop in-process — per tier it waits (up to
    ``poll_timeout`` seconds) for the daemons to finish: under reveal,
    for each closed node's snapshot to report ``result_ready``; under
    share-promotion, for each parent's participation count to reach its
    children's expected promotion rows (children never turn
    ``result_ready`` on this path — their clerks submit upward instead
    of sealing clerking results).

    Fanout contract: sibling nodes within one tier level are independent
    (different sub-cohorts, different frontends under the placement
    function), so their closes — and the reveal path's promotions — are
    dispatched :func:`tier_fanout`-wide through ``workpool.scatter``.
    Observable behaviour is unchanged from the serial loop: ``skipped``
    and the live set are ordered by node index regardless of completion
    order, a ``strict`` failure cancels outstanding siblings and
    re-raises the lowest-index error, and ``SDA_TIER_FANOUT=1`` takes
    the exact legacy serial loop. Each level's wall lands in
    ``sda_tier_close_seconds{mode=serial|fanout}`` and the effective
    width in ``sda_tier_fanout_nodes``; the ``tier.close`` span carries
    the per-level ``overlap_efficiency``.
    """
    depth = tiers_mod.tier_depth(round.root)
    reshare = (
        tiers_mod.effective_promotion(round.root) == tiers_mod.PROMOTION_RESHARE
    )
    skipped = []
    promote_hist = telemetry.histogram(
        _PROMOTE_SERIES,
        _PROMOTE_HELP,
        path=tiers_mod.PROMOTION_RESHARE if reshare else tiers_mod.PROMOTION_REVEAL,
    )

    def _drain(entries):
        if external_clerks:
            _await_results(
                entries, poll_interval, time.monotonic() + poll_timeout
            )
        else:
            _drain_clerks(entries, max_iterations)

    path_label = (
        tiers_mod.PROMOTION_RESHARE if reshare else tiers_mod.PROMOTION_REVEAL
    )

    def _close_node(tn: TierRoundNode) -> None:
        # closing the node (snapshot pipeline) is common to both paths
        # and untimed; only the promotion work itself is observed, so
        # the per-path samples compare like for like — and only on
        # success, so an aborted promotion (skipped under strict=False)
        # never leaves a sample
        snapshot_id = tn.owner.end_aggregation(tn.aggregation.id)
        if reshare:
            t0 = time.perf_counter()
            promote_mask_correction(
                tn.owner,
                tn.aggregation,
                tn.node.parent,
                snapshot_id=snapshot_id,
            )
            promote_hist.observe(time.perf_counter() - t0)

    def _reveal_promote_node(tn: TierRoundNode) -> None:
        t0 = time.perf_counter()
        partial = tn.owner.reveal_aggregation(tn.aggregation.id).positive()
        promote_partial(tn.owner, partial.values, tn.node.parent)
        promote_hist.observe(time.perf_counter() - t0)

    for tier in range(depth - 1, 0, -1):
        entries = [tn for tn in round.nodes if tn.node.tier == tier]
        width = tier_fanout(len(entries))
        mode = "serial" if width <= 1 else "fanout"
        close_hist = telemetry.histogram(_CLOSE_SERIES, _CLOSE_HELP, mode=mode)
        telemetry.gauge(_FANOUT_SERIES, _FANOUT_HELP).set(width)
        live = []
        t_level = time.perf_counter()
        with telemetry.span(
            "tier.close", tier=tier, nodes=len(entries), path=path_label,
            mode=mode, width=width,
        ) as close_span:
            if width <= 1:
                # SDA_TIER_FANOUT=1 kill switch: the legacy serial loop
                for tn in entries:
                    try:
                        _close_node(tn)
                    except Exception:
                        if strict:
                            raise
                        skipped.append(tn.aggregation.id)
                        continue
                    live.append(tn)
            else:
                # one close task per sibling node through a bounded
                # pool: the round-trips and the server-side snapshot
                # staging on different frontends overlap; a strict
                # failure cancels the outstanding siblings before
                # _gather re-raises it
                t0 = time.perf_counter()
                outcomes = workpool.scatter(
                    "tier_close",
                    [functools.partial(_close_node, tn) for tn in entries],
                    width,
                    cancel_on_error=strict,
                )
                _note_overlap(
                    close_span, outcomes, time.perf_counter() - t0, width
                )
                live = _gather(entries, outcomes, strict, skipped)
        with telemetry.span(
            "tier.promote", tier=tier, nodes=len(live), path=path_label,
            mode=mode, width=width,
        ) as promote_span:
            if not reshare:
                _drain(live)
                if width <= 1:
                    for tn in live:
                        try:
                            _reveal_promote_node(tn)
                        except Exception:
                            if strict:
                                raise
                            skipped.append(tn.aggregation.id)
                            continue
                else:
                    t0 = time.perf_counter()
                    outcomes = workpool.scatter(
                        "tier_promote",
                        [
                            functools.partial(_reveal_promote_node, tn)
                            for tn in live
                        ],
                        width,
                        cancel_on_error=strict,
                    )
                    _note_overlap(
                        promote_span, outcomes, time.perf_counter() - t0, width
                    )
                    _gather(live, outcomes, strict, skipped)
            elif external_clerks:
                _await_promotions(
                    round,
                    live,
                    poll_interval,
                    time.monotonic() + poll_timeout,
                    strict,
                    skipped,
                )
            else:
                _drain_clerks(live, max_iterations)
                # the survivor re-issue check stays serial under fanout
                # on purpose: the no-death fast path is a local length
                # check, and the rare epoch-1 re-issue walks clerk
                # clients a wrapped pool may share between siblings —
                # concurrent re-issue through one clerk object is the
                # only unsafe interleaving the fan-out could introduce
                for tn in live:
                    t0 = time.perf_counter()
                    try:
                        _ensure_reshared(tn)
                    except Exception:
                        if strict:
                            raise
                        skipped.append(tn.aggregation.id)
                        continue
                    promote_hist.observe(time.perf_counter() - t0)
        close_hist.observe(time.perf_counter() - t_level)
    with telemetry.span("tier.root_close", path=path_label):
        round.recipient.end_aggregation(round.root.id)
        _drain([round.nodes[0]])
    with telemetry.span("tier.root_reveal", path=path_label):
        output = round.recipient.reveal_aggregation(round.root.id)
    return TierRoundResult(output=output, skipped=skipped)
