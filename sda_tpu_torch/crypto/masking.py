"""Masking schemes: None / Full / ChaCha (counterpart of
``sda_tpu/crypto/masking.py``).

The participant produces ``(recipient_mask, masked_secrets)``; the recipient
later combines all participants' masks and subtracts. Vectors are numpy int64
on the host, as in the reference.

A participant expands its ChaCha seed with the native layer's
``chacha_expand`` (C), as the reference does. The recipient's ChaCha
combine keeps the reference's size routing: a cohort of at least
``DEVICE_COMBINE_THRESHOLD`` seed x dimension elements is expanded and
folded by ``combine_masks_device`` (the ChaCha20 kernel) on the masker's
device; a smaller one, and a modulus of 2^62 or more, which the device
fold's int64 sums cannot hold exactly, take the native layer's
``chacha_combine``, one C call for the cohort. The reference wraps its
device call in a ``try`` that falls back to the host; here there is none: a
masker made for CUDA launches the kernel or raises, and a masker made with
``device="cpu"`` runs the kernel's plain version.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..native import chacha_combine, chacha_expand
from ..ops.chacha_cuda import combine_masks_device
from ..ops.modular import WIDE_MAX_MODULUS, mod_sum_wide_np, rust_rem_np
from ..ops.rng import uniform_mod_host
from ..protocol import ChaChaMasking, FullMasking, NoMasking


class SecretMasker:
    def mask(self, secrets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """secrets -> (mask-for-recipient, masked-secrets-for-committee)."""
        raise NotImplementedError


class MaskCombiner:
    def combine(self, masks: list) -> np.ndarray:
        """Combine all participants' uploaded masks into one."""
        raise NotImplementedError

    def accumulator(self) -> "MaskAccumulator":
        """Streaming equivalent of ``combine``: fold the cohort's masks
        chunk by chunk; ``finish()`` equals the monolithic ``combine`` over
        the concatenated chunks (see MaskAccumulator)."""
        return MaskAccumulator(self)


class MaskAccumulator:
    """Chunk-by-chunk mask folding. Every per-chunk partial (``combine``)
    and every pairwise fold below is a canonical residue in ``[0, m)``, and
    modular addition of canonical representatives is associative, so the
    folded result equals the monolithic combine regardless of chunk
    boundaries. The pairwise fold adds in uint64 (two canonical values each
    < m sum below 2**64 for any m <= 2**63)."""

    def __init__(self, combiner: MaskCombiner):
        self._combiner = combiner
        self._acc: np.ndarray | None = None

    def fold(self, masks: list) -> None:
        if not masks:
            return
        partial = self._combiner.combine(masks)
        if self._acc is None or self._acc.size == 0:
            self._acc = partial
        elif partial.size:
            total = self._acc.astype(np.uint64) + partial.astype(np.uint64)
            self._acc = (total % np.uint64(self._combiner.modulus)).astype(np.int64)

    def finish(self) -> np.ndarray:
        if self._acc is None:
            # no chunks at all: each scheme's own empty-cohort shape
            # (NoMasking/Full: empty vector; ChaCha: zeros(dimension))
            return self._combiner.combine([])
        return self._acc


class SecretUnmasker:
    def unmask(self, mask: np.ndarray, masked: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class NoMasker(SecretMasker, MaskCombiner, SecretUnmasker):
    """Zero masking: empty mask, secrets pass through (masking/none.rs)."""

    def mask(self, secrets):
        return np.empty(0, dtype=np.int64), np.asarray(secrets, dtype=np.int64).copy()

    def combine(self, masks):
        assert all(len(m) == 0 for m in masks)
        return np.empty(0, dtype=np.int64)

    def unmask(self, mask, masked):
        assert len(mask) == 0
        return np.asarray(masked, dtype=np.int64).copy()


class FullMasker(SecretMasker, MaskCombiner, SecretUnmasker):
    """Per-element uniform masks from OS entropy (masking/full.rs)."""

    def __init__(self, modulus: int):
        self.modulus = modulus

    def mask(self, secrets):
        secrets = np.asarray(secrets, dtype=np.int64)
        masks = uniform_mod_host(secrets.shape, self.modulus)
        masked = rust_rem_np(secrets + masks, self.modulus)
        return masks, masked

    def combine(self, masks):
        if not masks:
            return np.empty(0, dtype=np.int64)
        stack = np.stack([np.asarray(m, dtype=np.int64) for m in masks])
        return mod_sum_wide_np(stack, self.modulus, axis=0)

    def unmask(self, mask, masked):
        return rust_rem_np(np.asarray(masked, np.int64) - np.asarray(mask, np.int64), self.modulus)


class ChaChaMasker(SecretMasker, MaskCombiner, SecretUnmasker):
    """Seed-compressed masks (masking/chacha.rs): upload only the seed.

    The uploaded "mask" is the seed's u32 words as i64s, and the expansion
    is bit-exact to the rand-0.3 ``ChaChaRng`` expansion of the SDA client
    and of ``sda_tpu`` (``ops/chacha.py``), so a mixed deployment unmasks
    correctly. ``device`` is where ``combine`` expands a cohort at or
    above ``DEVICE_COMBINE_THRESHOLD`` elements (CUDA unless the caller
    asks for the CPU)."""

    #: below this many expanded elements the host loop beats device dispatch
    DEVICE_COMBINE_THRESHOLD = 1 << 22

    def __init__(self, modulus: int, dimension: int, seed_bitsize: int, device=None):
        self.modulus = modulus
        self.dimension = dimension
        self.seed_words = (seed_bitsize + 31) // 32
        self.device = resolve_device(device)

    def mask(self, secrets):
        secrets = np.asarray(secrets, dtype=np.int64)
        if len(secrets) != self.dimension:
            raise ValueError("dimension mismatch")
        seed = uniform_mod_host((self.seed_words,), 1 << 32).astype(np.uint32)
        mask = chacha_expand(seed, self.dimension, self.modulus)
        masked = rust_rem_np(secrets + mask, self.modulus)
        return seed.astype(np.int64), masked

    def combine(self, seeds):
        seed_rows = [np.asarray(s, dtype=np.int64).astype(np.uint32) for s in seeds]
        if (len(seed_rows) * self.dimension >= self.DEVICE_COMBINE_THRESHOLD
                and self.modulus < WIDE_MAX_MODULUS):
            # the reveal hot loop (receive.rs:102-118): expand + fold on the
            # device, the ChaCha20 kernel on CUDA
            total = combine_masks_device(
                np.stack(seed_rows), self.dimension, self.modulus, device=self.device
            )
            return total.cpu().numpy()
        if not seed_rows:
            return np.zeros(self.dimension, dtype=np.int64)
        # one C call expands and folds the whole cohort; its uint64 sums hold
        # moduli above 2^62 exactly
        return chacha_combine(np.stack(seed_rows), self.dimension, self.modulus)

    def unmask(self, mask, masked):
        return rust_rem_np(np.asarray(masked, np.int64) - np.asarray(mask, np.int64), self.modulus)


def new_secret_masker(scheme, device=None) -> SecretMasker:
    return _dispatch(scheme, device)


def new_mask_combiner(scheme, device=None) -> MaskCombiner:
    return _dispatch(scheme, device)


def new_secret_unmasker(scheme, device=None) -> SecretUnmasker:
    return _dispatch(scheme, device)


def _dispatch(scheme, device):
    if isinstance(scheme, NoMasking):
        return NoMasker()
    if isinstance(scheme, FullMasking):
        return FullMasker(scheme.modulus)
    if isinstance(scheme, ChaChaMasking):
        return ChaChaMasker(scheme.modulus, scheme.dimension, scheme.seed_bitsize, device)
    raise TypeError(f"unknown masking scheme {scheme!r}")
