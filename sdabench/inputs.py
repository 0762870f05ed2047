"""What every loop derives from the seed and the configuration."""

from __future__ import annotations

import numpy as np


def seeds(seed: int, count: int) -> list:
    """``count`` independent 63-bit seeds from one ``--seed`` of any size."""
    return [int(s.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for s in np.random.SeedSequence(seed).spawn(count)]


def scheme_of(config: dict):
    """The port's packed-Shamir scheme with the configuration's numbers."""
    from sda_tpu_torch.protocol import PackedShamirSharing

    s = config["scheme"]
    return PackedShamirSharing(secret_count=s["secret_count"], share_count=s["share_count"],
                               privacy_threshold=s["privacy_threshold"], prime_modulus=s["prime_modulus"],
                               omega_secrets=s["omega_secrets"], omega_shares=s["omega_shares"])


def clerks_of(config: dict, dropped) -> list:
    """The first ``t + k`` clerks that remain once ``dropped`` leave: the
    ones a reveal reconstructs from."""
    s = config["scheme"]
    kept = [c for c in range(s["share_count"]) if c not in dropped]
    return kept[: s["secret_count"] + s["privacy_threshold"]]
