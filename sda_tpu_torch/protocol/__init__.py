from .schemes import (
    AdditiveSharing,
    BasicShamirSharing,
    LinearSecretSharingScheme,
    PackedShamirSharing,
)

__all__ = [
    "AdditiveSharing",
    "BasicShamirSharing",
    "LinearSecretSharingScheme",
    "PackedShamirSharing",
]
