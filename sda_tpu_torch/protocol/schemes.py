"""Secret-sharing scheme descriptors (copy of ``sda_tpu/protocol/schemes.py``
lines 253-410 without the JSON wire codecs).

Derived properties mirror the reference protocol's crypto.rs:117-155; in
particular the packed-Shamir dropout tolerance
``reconstruction_threshold = privacy_threshold + secret_count``.
"""

from __future__ import annotations

from dataclasses import dataclass


class LinearSecretSharingScheme:
    """Sharing scheme across the clerk committee.

    ``input_size`` (secrets per batch), ``output_size`` (shares produced =
    committee size), ``privacy_threshold`` (max colluding clerks tolerated)
    and ``reconstruction_threshold`` (min clerk results needed).
    """


@dataclass(frozen=True)
class AdditiveSharing(LinearSecretSharingScheme):
    """n-of-n additive sharing in Z_modulus."""

    share_count: int
    modulus: int

    @property
    def input_size(self) -> int:
        return 1

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def privacy_threshold(self) -> int:
        return self.share_count - 1

    @property
    def reconstruction_threshold(self) -> int:
        return self.share_count


@dataclass(frozen=True)
class BasicShamirSharing(LinearSecretSharingScheme):
    """Classic (non-packed) Shamir over F_p: one degree-t polynomial per
    secret, shares at points 1..n, reconstruction from any t+1 shares."""

    share_count: int
    privacy_threshold: int
    prime_modulus: int

    def __post_init__(self):
        if not 0 < self.privacy_threshold < self.share_count:
            raise ValueError("need 0 < privacy_threshold < share_count")
        if self.share_count >= self.prime_modulus:
            # evaluation points 1..n must be distinct and nonzero mod p
            raise ValueError("share_count must be below the prime modulus")

    @property
    def input_size(self) -> int:
        return 1

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def reconstruction_threshold(self) -> int:
        return self.privacy_threshold + 1


@dataclass(frozen=True)
class PackedShamirSharing(LinearSecretSharingScheme):
    """Packed Shamir over F_p: one polynomial hides k secrets.

    Valid parameter sets satisfy ``order(omega_secrets) ==
    secret_count + privacy_threshold + 1`` (a power of 2) and
    ``order(omega_shares) == share_count + 1`` (a power of 3), with
    ``p = 1 (mod 2^a * 3^b)`` (``ops.params.find_packed_parameters``).
    """

    secret_count: int
    share_count: int
    privacy_threshold: int
    prime_modulus: int
    omega_secrets: int
    omega_shares: int

    @property
    def input_size(self) -> int:
        return self.secret_count

    @property
    def output_size(self) -> int:
        return self.share_count

    @property
    def reconstruction_threshold(self) -> int:
        return self.privacy_threshold + self.secret_count
