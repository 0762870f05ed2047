"""Cryptographic scheme descriptors, their derived properties and their JSON
codecs (copy of ``sda_tpu/protocol/schemes.py``, the Packed Paillier
extension included: ``PaillierEncryptionKey``, the ``Paillier`` variant of
``Encryption`` and ``PackedPaillierEncryptionScheme``).

Wire parity with the SDA protocol's crypto.rs (serde externally tagged
enums):
- newtype variants: ``{"Sodium": "<base64>"}`` (Encryption, keys, Signature)
- unit variants: ``"None"`` / ``"Sodium"`` (LinearMaskingScheme::None,
  AdditiveEncryptionScheme::Sodium)
- struct variants: ``{"Full": {"modulus": 433}}`` etc.

Derived properties (input/output size, privacy/reconstruction thresholds)
mirror crypto.rs:117-155; in particular the packed-Shamir dropout-tolerance
formula ``reconstruction_threshold = privacy_threshold + secret_count``
(crypto.rs:151).
"""

from __future__ import annotations

from dataclasses import dataclass

from .helpers import B32, B64, Binary


def _tagged(tag, payload):
    return {tag: payload}


def _untag(obj, expected_tags):
    """Decode an externally tagged enum value; returns (tag, payload)."""
    if isinstance(obj, str):
        if obj not in expected_tags:
            raise ValueError(f"unknown enum variant {obj!r}, expected one of {expected_tags}")
        return obj, None
    if isinstance(obj, dict) and len(obj) == 1:
        tag, payload = next(iter(obj.items()))
        if tag not in expected_tags:
            raise ValueError(f"unknown enum variant {tag!r}, expected one of {expected_tags}")
        return tag, payload
    raise ValueError(f"malformed enum value {obj!r}")


class _SodiumNewtype:
    """Base for single-variant ``Sodium(bytes)`` enums."""

    INNER = None  # B32 / B64 / Binary
    __slots__ = ("inner",)

    def __init__(self, inner):
        if isinstance(inner, (bytes, bytearray)):
            inner = self.INNER(bytes(inner))
        if not isinstance(inner, self.INNER):
            raise TypeError(f"{type(self).__name__} expects {self.INNER.__name__}")
        self.inner = inner

    @property
    def data(self) -> bytes:
        return self.inner.data

    def to_json(self):
        return _tagged("Sodium", self.inner.to_json())

    @classmethod
    def from_json(cls, obj):
        _, payload = _untag(obj, ("Sodium",))
        return cls(cls.INNER.from_json(payload))

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other.inner == self.inner

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.inner))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.inner!r})"


class Encryption(_SodiumNewtype):
    """A ciphertext. The SDA protocol's enum has one variant, ``Sodium``
    (sealed box, crypto.rs:8-14); ``Paillier`` is the wire-compatible
    extension carrying packed-Paillier blocks, tagged so external consumers
    never misread one payload kind as the other. ``VARIANTS`` is in
    ``sda_tpu``'s order (the binary wire's tag byte)."""

    INNER = Binary
    VARIANTS = ("Sodium", "Paillier")
    __slots__ = ("variant",)

    def __init__(self, inner, variant: str = "Sodium"):
        super().__init__(inner)
        if variant not in self.VARIANTS:
            raise ValueError(f"unknown Encryption variant {variant!r}")
        self.variant = variant

    def to_json(self):
        return _tagged(self.variant, self.inner.to_json())

    @classmethod
    def from_json(cls, obj):
        tag, payload = _untag(obj, cls.VARIANTS)
        return cls(Binary.from_json(payload), variant=tag)

    @classmethod
    def _from_wire(cls, data: bytes, variant: str):
        """Trusted bulk-decode path: wrap ciphertext bytes sliced out of a
        validated binary frame, bypassing the isinstance-dispatching
        constructors (hot at thousands of ciphertexts per frame).
        Callers must pass ``bytes`` and a tag from ``VARIANTS``."""
        inner = object.__new__(Binary)
        inner.data = data
        self = object.__new__(cls)
        self.inner = inner
        self.variant = variant
        return self

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and other.inner == self.inner
            and other.variant == self.variant
        )

    def __hash__(self) -> int:
        return hash((type(self).__name__, self.variant, self.inner))


class EncryptionKey(_SodiumNewtype):
    """Sodium box public key (32 bytes)."""

    INNER = B32

    @classmethod
    def from_json(cls, obj):
        # polymorphic: sodium keys are {"Sodium": b64}; Paillier public
        # keys (the sketched PackedPaillier extension) are
        # {"Paillier": {"n": decimal}} — both usable wherever a key goes
        tag, payload = _untag(obj, ("Sodium", "Paillier"))
        if tag == "Paillier":
            return PaillierEncryptionKey(int(payload["n"]))
        return cls(B32.from_json(payload))


@dataclass(frozen=True)
class PaillierEncryptionKey:
    """Paillier public key: the modulus n (g is fixed to n+1)."""

    n: int

    def to_json(self):
        return {"Paillier": {"n": str(self.n)}}

    @classmethod
    def from_json(cls, obj):
        _, payload = _untag(obj, ("Paillier",))
        return cls(int(payload["n"]))


class Signature(_SodiumNewtype):
    """Ed25519 detached signature (64 bytes)."""

    INNER = B64


class SigningKey(_SodiumNewtype):
    """Ed25519 signing key (64 bytes: seed || public)."""

    INNER = B64


class VerificationKey(_SodiumNewtype):
    """Ed25519 verification key (32 bytes)."""

    INNER = B32


# ---------------------------------------------------------------------------
# Masking schemes
# ---------------------------------------------------------------------------


class LinearMaskingScheme:
    """Masking scheme between recipient and committee (crypto.rs:43-74)."""

    def has_mask(self) -> bool:
        raise NotImplementedError

    @staticmethod
    def from_json(obj):
        tag, payload = _untag(obj, ("None", "Full", "ChaCha"))
        if tag == "None":
            return NoMasking()
        if tag == "Full":
            return FullMasking(modulus=int(payload["modulus"]))
        return ChaChaMasking(
            modulus=int(payload["modulus"]),
            dimension=int(payload["dimension"]),
            seed_bitsize=int(payload["seed_bitsize"]),
        )


@dataclass(frozen=True)
class NoMasking(LinearMaskingScheme):
    """No masking: secrets are shared directly to the clerks."""

    def has_mask(self) -> bool:
        return False

    def to_json(self):
        return "None"


@dataclass(frozen=True)
class FullMasking(LinearMaskingScheme):
    """Per-element uniform masking with fresh OS randomness."""

    modulus: int

    def has_mask(self) -> bool:
        return True

    def to_json(self):
        return _tagged("Full", {"modulus": self.modulus})


@dataclass(frozen=True)
class ChaChaMasking(LinearMaskingScheme):
    """Seed-compressed masking: upload a small seed, expand via ChaCha20.

    Trades upload/download size for expansion compute on both sides
    (crypto.rs:53-62).
    """

    modulus: int
    dimension: int
    seed_bitsize: int

    def has_mask(self) -> bool:
        return True

    def to_json(self):
        return _tagged(
            "ChaCha",
            {
                "modulus": self.modulus,
                "dimension": self.dimension,
                "seed_bitsize": self.seed_bitsize,
            },
        )


# ---------------------------------------------------------------------------
# Secret sharing schemes
# ---------------------------------------------------------------------------


class LinearSecretSharingScheme:
    """Sharing scheme across the clerk committee (crypto.rs:79-155).

    Derived properties are plain attributes/properties: ``input_size``
    (secrets per batch), ``output_size`` (shares produced = committee size),
    ``privacy_threshold`` (max colluding clerks tolerated), and
    ``reconstruction_threshold`` (min clerk results needed).
    """

    @staticmethod
    def from_json(obj):
        tag, payload = _untag(obj, ("Additive", "BasicShamir", "PackedShamir"))
        if tag == "Additive":
            return AdditiveSharing(
                share_count=int(payload["share_count"]), modulus=int(payload["modulus"])
            )
        if tag == "BasicShamir":
            return BasicShamirSharing(
                share_count=int(payload["share_count"]),
                privacy_threshold=int(payload["privacy_threshold"]),
                prime_modulus=int(payload["prime_modulus"]),
            )
        return PackedShamirSharing(
            secret_count=int(payload["secret_count"]),
            share_count=int(payload["share_count"]),
            privacy_threshold=int(payload["privacy_threshold"]),
            prime_modulus=int(payload["prime_modulus"]),
            omega_secrets=int(payload["omega_secrets"]),
            omega_shares=int(payload["omega_shares"]),
        )


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

    def to_json(self):
        return _tagged(
            "Additive", {"share_count": self.share_count, "modulus": self.modulus}
        )


@dataclass(frozen=True)
class BasicShamirSharing(LinearSecretSharingScheme):
    """Classic (non-packed) Shamir over F_p: one degree-t polynomial per
    secret, shares at points 1..n, reconstruction from any t+1 shares.

    The SDA protocol sketches this variant but leaves it commented out
    (crypto.rs:89-96, same field names); here it is implemented — unlike
    packed Shamir it imposes NO radix structure on the field or committee
    (any prime, any share_count), at the cost of one polynomial per
    element instead of per k-batch.
    """

    share_count: int
    privacy_threshold: int
    prime_modulus: int

    def __post_init__(self):
        if not 0 < self.privacy_threshold < self.share_count:
            raise ValueError("need 0 < privacy_threshold < share_count")
        if self.share_count >= self.prime_modulus:
            # evaluation points 1..n must be distinct and nonzero mod p: a
            # point ≡ 0 would hand a clerk the raw secret, colliding points
            # make reveal impossible — reject at construction (incl. wire)
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

    def to_json(self):
        return _tagged(
            "BasicShamir",
            {
                "share_count": self.share_count,
                "privacy_threshold": self.privacy_threshold,
                "prime_modulus": self.prime_modulus,
            },
        )


@dataclass(frozen=True)
class PackedShamirSharing(LinearSecretSharingScheme):
    """Packed Shamir over F_p: one degree-(t+k) polynomial hides k secrets.

    Valid parameter sets satisfy ``order(omega_secrets) ==
    secret_count + privacy_threshold + 1`` (a power of 2) and
    ``order(omega_shares) == share_count + 1`` (a power of 3), with
    ``p = 1 (mod 2^a * 3^b)``; see the verified p=433 test vector in
    the SDA integration tests' full_loop.rs:56-64.
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

    def to_json(self):
        return _tagged(
            "PackedShamir",
            {
                "secret_count": self.secret_count,
                "share_count": self.share_count,
                "privacy_threshold": self.privacy_threshold,
                "prime_modulus": self.prime_modulus,
                "omega_secrets": self.omega_secrets,
                "omega_shares": self.omega_shares,
            },
        )


# ---------------------------------------------------------------------------
# Additive encryption schemes
# ---------------------------------------------------------------------------


class AdditiveEncryptionScheme:
    """Transport encryption scheme for shares/masks (crypto.rs:159-188)."""

    def batch_size(self) -> int:
        raise NotImplementedError

    @staticmethod
    def from_json(obj):
        tag, payload = _untag(obj, ("Sodium", "PackedPaillier"))
        if tag == "PackedPaillier":
            return PackedPaillierEncryptionScheme(
                component_count=int(payload["component_count"]),
                component_bitsize=int(payload["component_bitsize"]),
                max_value_bitsize=int(payload["max_value_bitsize"]),
                min_modulus_bitsize=int(payload["min_modulus_bitsize"]),
            )
        return SodiumEncryptionScheme()


@dataclass(frozen=True)
class SodiumEncryptionScheme(AdditiveEncryptionScheme):
    """Sodium sealed-box transport encryption."""

    def batch_size(self) -> int:
        return 1

    def to_json(self):
        return "Sodium"


@dataclass(frozen=True)
class PackedPaillierEncryptionScheme(AdditiveEncryptionScheme):
    """Packed Paillier transport encryption — additively homomorphic.

    The SDA protocol sketches exactly these fields (crypto.rs:164-174) and
    names Paillier as its scale-up path; here it is implemented. Masks
    encrypted under this scheme can be combined BY THE SERVER (ciphertext
    multiplication), so the recipient decrypts one ciphertext per
    component block regardless of participant count. Up to
    ``2^(component_bitsize - max_value_bitsize)`` ciphertexts may be
    combined before a component could carry into its neighbor.
    """

    component_count: int
    component_bitsize: int
    max_value_bitsize: int
    min_modulus_bitsize: int

    def __post_init__(self):
        if self.max_value_bitsize > self.component_bitsize:
            raise ValueError("component values larger than their slots")
        if self.component_bitsize > 62:
            # decrypted component sums must fit the i64 share plane
            raise ValueError("component_bitsize must be <= 62")
        if self.component_count * self.component_bitsize >= self.min_modulus_bitsize:
            raise ValueError("components do not fit the plaintext space")

    def batch_size(self) -> int:
        return self.component_count

    def to_json(self):
        return _tagged(
            "PackedPaillier",
            {
                "component_count": self.component_count,
                "component_bitsize": self.component_bitsize,
                "max_value_bitsize": self.max_value_bitsize,
                "min_modulus_bitsize": self.min_modulus_bitsize,
            },
        )
