"""Participant / clerk / recipient role logic (counterpart of
``sda_tpu/client``).

``SdaClient`` works against any ``SdaService`` with a keystore-backed
``CryptoModule``, as the SDA client crate's lib.rs:39-56 does. ``device`` is
where the recipient's large ChaCha mask combine runs (CUDA unless the caller
asks for the CPU). ``tiers`` provisions and runs a tiered round (share or
reveal promotion). ``ingest_cohort`` drives a cohort through the
arrival-driven plan/build/upload pipeline (``ingest``), and paged jobs and
results are read through the bounded prefetch pipeline (``prefetch``).
"""

from __future__ import annotations

from ..crypto import CryptoModule, Keystore
from ..protocol import Agent, AgentId, SdaService
from .clerk import Clerking
from .committee import run_committee
from .ingest import IngestReport, ingest_cohort, plan_arrivals
from .participate import Participating
from .profile import Maintenance
from .receive import Receiving, RecipientOutput
from .tiers import (
    TierRound,
    TierRoundNode,
    TierRoundResult,
    promote_mask_correction,
    promote_partial,
    run_tier_round,
    setup_tier_round,
    tier_fanout,
)


class SdaClient(Participating, Clerking, Receiving, Maintenance):
    """Primary object for interacting with an SDA service."""

    def __init__(self, agent: Agent, keystore: Keystore, service: SdaService, device=None):
        self.agent = agent
        self.crypto = CryptoModule(keystore, device)
        self.service = service

    @staticmethod
    def new_agent(keystore: Keystore) -> Agent:
        """Create a fresh agent identity with a signature keypair (the SDA
        client's profile.rs:10-18)."""
        crypto = CryptoModule(keystore, device="cpu")  # key generation is host work
        return Agent(id=AgentId.random(), verification_key=crypto.new_signature_key())


__all__ = [
    "SdaClient",
    "IngestReport",
    "ingest_cohort",
    "plan_arrivals",
    "Participating",
    "Clerking",
    "Receiving",
    "Maintenance",
    "RecipientOutput",
    "run_committee",
    "TierRound",
    "TierRoundNode",
    "TierRoundResult",
    "setup_tier_round",
    "run_tier_round",
    "promote_partial",
    "promote_mask_correction",
    "tier_fanout",
]
