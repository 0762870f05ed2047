"""``sda`` — the agent command line (counterpart of ``sda_tpu/cli/sda.py``).

Subcommand parity with the SDA CLI's main.rs:29-81: ``ping``,
``agent create/show``, ``agent keys create/show``, ``clerk [--once]``,
``aggregations create/begin/end/reveal``, ``participate``. Identity lives in
a directory (default ``.sda``; keys under ``keys/``), the server defaults to
``http://localhost:8888``.

As in ``sda_tpu``, ``--sharing shamir`` works (the SDA CLI panics
``unimplemented!()`` at main.rs:226): packed Shamir parameters are
generated on the fly from ``--secret-count`` / ``--privacy-threshold`` and
the requested modulus size.

``--device`` (default ``cuda``) is where the recipient's large ChaCha mask
combine runs; without a GPU every command raises unless ``--device cpu``
is given, as every entry point of the port does.

Run as ``python -m sda_tpu_torch.cli.sda``.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

from ..client import SdaClient
from ..device import resolve_device
from ..crypto import Keystore, Filebased
from ..protocol import (
    Aggregation,
    AggregationId,
    Agent,
    AgentId,
    ChaChaMasking,
    EncryptionKeyId,
    FullMasking,
    NoMasking,
    AdditiveSharing,
    BasicShamirSharing,
    PackedShamirSharing,
    SdaError,
    SodiumEncryptionScheme,
)
from ..rest import SdaHttpClient, TokenStore

log = logging.getLogger("sda.cli")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="sda", description="SDA agent CLI")
    parser.add_argument("-s", "--server", default="http://localhost:8888", help="Server root")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    parser.add_argument(
        "--device", default="cuda",
        help="where the recipient's ChaCha mask combine runs (cuda or cpu)",
    )
    parser.add_argument(
        "-i", "--identity", default=".sda", help="Storage directory for identity and keys"
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("ping", help="check service availability")

    agent = sub.add_parser("agent", help="identity management")
    agent_sub = agent.add_subparsers(dest="agent_command", required=True)
    agent_sub.add_parser("show")
    create = agent_sub.add_parser("create")
    create.add_argument("-f", "--force", action="store_true", help="Overwrite any existing identity")
    keys = agent_sub.add_parser("keys")
    keys_sub = keys.add_subparsers(dest="keys_command", required=True)
    keys_sub.add_parser("create")
    keys_sub.add_parser("show")
    prof = agent_sub.add_parser(
        "profile", help="public profile (link external identities)"
    )
    prof_sub = prof.add_subparsers(dest="profile_command", required=True)
    pset = prof_sub.add_parser("set")
    pset.add_argument("--name")
    pset.add_argument("--twitter")
    pset.add_argument("--keybase")
    pset.add_argument("--website")
    pset.add_argument(
        "--clear", action="store_true",
        help="drop fields not given instead of keeping their current values",
    )
    pshow = prof_sub.add_parser("show")
    pshow.add_argument(
        "owner", nargs="?", help="agent id (default: own profile)"
    )

    clerk = sub.add_parser("clerk", help="run a clerk in a loop")
    clerk.add_argument("-o", "--once", action="store_true", help="Run just once and leave")
    clerk.add_argument(
        "--poll-seconds",
        type=float,
        default=2.0,
        help="Max sleep between queue polls (jittered backoff ramps up "
        "to this after an idle pass; the pre-backoff fixed sleep was 300)",
    )

    aggs = sub.add_parser(
        "aggregations", aliases=["agg", "aggs", "aggregation"], help="manage aggregations"
    )
    aggs_sub = aggs.add_subparsers(dest="agg_command", required=True)
    create = aggs_sub.add_parser("create")
    create.add_argument("title")
    create.add_argument("dimension", type=int)
    create.add_argument("modulus", type=int)
    create.add_argument("key", help="key to use for recipient encryption")
    create.add_argument("share_count", type=int)
    create.add_argument("--id")
    create.add_argument("--mask", choices=["none", "full", "chacha"], default="none")
    create.add_argument(
        "--sharing", choices=["add", "shamir", "basic"], default="add",
        help="add = n-of-n additive; shamir = packed Shamir (generated field); "
        "basic = classic Shamir (any prime modulus, any committee size)",
    )
    create.add_argument("--secret-count", type=int, help="shamir: secrets packed per batch")
    create.add_argument("--privacy-threshold", type=int, help="shamir: collusion tolerance")
    for name in ("begin", "end", "reveal"):
        p = aggs_sub.add_parser(name)
        p.add_argument("aggregation_id")
        if name == "begin":
            p.add_argument(
                "--clerk",
                action="append",
                dest="clerks",
                metavar="AGENT_ID",
                help="choose this agent as a committee clerk (repeat once "
                "per clerk, in committee order); default: first suggested "
                "candidates",
            )

    part = sub.add_parser("participate", help="contribute a vector to an aggregation")
    part.add_argument("id", help="aggregation id")
    part.add_argument("values", nargs="+", type=int)

    return parser


def make_client(args):
    identity = Path(args.identity)
    service = SdaHttpClient(args.server, TokenStore(identity))
    identitystore = Filebased(identity)
    keystore = Keystore(identity / "keys")
    agent = identitystore.get_aliased("agent", Agent.from_json)
    return service, identitystore, keystore, agent


def require_agent(agent):
    if agent is None:
        raise SystemExit('Agent is needed. Maybe run "sda agent create" ?')
    return agent


def _verify_sharing(scheme) -> None:
    """Rank-based privacy/reconstruction check (ops.verify_scheme) on every
    CLI-constructed Shamir scheme — committee-sized, so it is cheap."""
    from ..ops import verify_scheme

    verify_scheme(scheme)


def cmd_aggregations_create(client, args) -> None:
    modulus = args.modulus
    if args.sharing == "add":
        sharing = AdditiveSharing(share_count=args.share_count, modulus=modulus)
    elif args.sharing == "basic":
        from ..ops.params import is_prime

        if not is_prime(modulus):
            raise SystemExit(f"basic Shamir needs a prime modulus, got {modulus}")
        t = (args.share_count - 1) if args.privacy_threshold is None else args.privacy_threshold
        if not 0 < t < args.share_count:
            raise SystemExit(f"privacy threshold {t} must be in (0, share_count)")
        sharing = BasicShamirSharing(
            share_count=args.share_count, privacy_threshold=t, prime_modulus=modulus
        )
        _verify_sharing(sharing)
    else:
        from ..ops import find_packed_parameters

        k = 3 if args.secret_count is None else args.secret_count
        t = (args.share_count - k - 1) if args.privacy_threshold is None else args.privacy_threshold
        p, w2, w3 = find_packed_parameters(
            k, t, args.share_count, min_modulus_bits=min(30, max(8, modulus.bit_length()))
        )
        if p != modulus:
            log.warning("modulus %d unsuitable for packed Shamir; using prime %d", modulus, p)
            modulus = p
        sharing = PackedShamirSharing(k, args.share_count, t, p, w2, w3)
        _verify_sharing(sharing)
    mask = {
        "none": NoMasking(),
        "full": FullMasking(modulus=modulus),
        "chacha": ChaChaMasking(modulus=modulus, dimension=args.dimension, seed_bitsize=128),
    }[args.mask]
    agg = Aggregation(
        id=AggregationId(args.id) if args.id else AggregationId.random(),
        title=args.title,
        vector_dimension=args.dimension,
        modulus=modulus,
        recipient=client.agent.id,
        recipient_key=EncryptionKeyId(args.key),
        masking_scheme=mask,
        committee_sharing_scheme=sharing,
        recipient_encryption_scheme=SodiumEncryptionScheme(),
        committee_encryption_scheme=SodiumEncryptionScheme(),
    )
    client.upload_aggregation(agg)
    print(f"aggregation created. id: {agg.id}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    level = [logging.WARNING, logging.INFO, logging.DEBUG][min(args.verbose, 2)]
    logging.basicConfig(level=level, stream=sys.stderr, format="%(asctime)s %(name)s %(message)s")

    device = resolve_device(args.device)
    service, identitystore, keystore, agent = make_client(args)

    def sda_client(agent):
        return SdaClient(agent, keystore, service, device=device)

    if args.command == "ping":
        pong = service.ping()
        if not pong.running:
            raise SystemExit("Service may not be running")
        log.info("Service appears to be running")
        return 0

    if args.command == "agent":
        if args.agent_command == "show":
            if agent is None:
                log.warning("No local agent found")
            else:
                print(f"Local agent is {agent.id}")
            return 0
        if args.agent_command == "create":
            if agent is not None and not args.force:
                log.warning("Using existing agent; use --force to create new")
            else:
                agent = SdaClient.new_agent(keystore)
                identitystore.put_aliased("agent", agent)
                log.info("Created new agent with id %s", agent.id)
            sda_client(agent).upload_agent()
            return 0
        if args.agent_command == "keys":
            client = sda_client(require_agent(agent))
            if args.keys_command == "create":
                key = client.new_encryption_key()
                client.upload_encryption_key(key)
                print(f"Created and uploaded key: {key}")
                return 0
            if args.keys_command == "show":
                for key_id in keystore.list_ids():
                    print(key_id)
                return 0
        if args.agent_command == "profile":
            client = sda_client(require_agent(agent))
            if args.profile_command == "set":
                # read-merge-write: flags imply field-level update, so
                # untouched fields keep their current values (pass
                # --clear to drop everything not given)
                existing = (
                    None if args.clear else client.get_profile(client.agent.id)
                )

                def merged(flag, field):
                    if flag is not None:
                        return flag
                    return getattr(existing, field) if existing else None

                profile = client.update_profile(
                    name=merged(args.name, "name"),
                    twitter_id=merged(args.twitter, "twitter_id"),
                    keybase_id=merged(args.keybase, "keybase_id"),
                    website=merged(args.website, "website"),
                )
                print(f"Profile updated for {profile.owner}")
                return 0
            if args.profile_command == "show":
                owner = AgentId(args.owner) if args.owner else client.agent.id
                profile = client.get_profile(owner)
                if profile is None:
                    log.warning("No profile for %s", owner)
                    return 1
                for field in ("name", "twitter_id", "keybase_id", "website"):
                    value = getattr(profile, field)
                    if value is not None:
                        print(f"{field}: {value}")
                return 0

    if args.command == "clerk":
        from ..utils.faults import Backoff

        client = sda_client(require_agent(agent))
        service.ping()
        # bounded jittered backoff between polls: a busy queue is
        # re-polled almost immediately after draining, an idle or
        # stalled server at most every poll_seconds — so neither a hot
        # committee nor a wedged deployment makes the clerk spin
        backoff = Backoff(cap=max(args.poll_seconds, 0.001))
        while True:
            log.debug("Polling for clerking job")
            try:
                n = client.run_chores(-1)
            except SdaError as e:
                # a transient transport stall (REST timeout, connection
                # reset) must not kill a long-running clerk daemon; the
                # next poll retries. --once runs propagate: the caller
                # asked for exactly one attempt and needs the failure.
                if args.once:
                    raise
                log.warning("clerking pass failed (%s); retrying next poll", e)
            else:
                if n:
                    backoff.reset()
            if args.once:
                return 0
            time.sleep(backoff.next_delay())

    if args.command in ("aggregations", "agg", "aggs", "aggregation"):
        client = sda_client(require_agent(agent))
        service.ping()
        if args.agg_command == "create":
            cmd_aggregations_create(client, args)
            return 0
        agg_id = AggregationId(args.aggregation_id)
        if args.agg_command == "begin":
            chosen = (
                [AgentId(c) for c in args.clerks] if args.clerks else None
            )
            client.begin_aggregation(agg_id, chosen_clerks=chosen)
            return 0
        if args.agg_command == "end":
            client.end_aggregation(agg_id)
            return 0
        if args.agg_command == "reveal":
            output = client.reveal_aggregation(agg_id).positive()
            print("result:", " ".join(str(v) for v in output.values))
            return 0

    if args.command == "participate":
        client = sda_client(require_agent(agent))
        client.participate(args.values, AggregationId(args.id))
        return 0

    raise SystemExit(f"Unknown command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
