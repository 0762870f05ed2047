"""Federated averaging's model plane: pytrees <-> field vectors.

Counterpart of the pure half of ``sda_tpu/models/federated.py``:

1. **Pytree <-> flat vector**: ``flatten_pytree`` / ``unflatten_pytree``
   walk a tree in JAX's leaf order, so every participant quantizes the same
   coordinate layout as the reference. A ``dict`` flattens in sorted key
   order, an ``OrderedDict`` in insertion order, a namedtuple in field
   order, a ``list`` or ``tuple`` in order; ``None``, ``{}`` and ``[]`` are
   empty subtrees with no leaf; anything else (a Python scalar, a numpy
   array, a tensor, a subclass of ``dict``) is a leaf. ``torch.utils._pytree``
   is not used: it keeps dict insertion order and makes ``None`` a leaf, and
   either moves quantized coordinates.
2. **Fixed-point field encoding**: ``QuantizationSpec`` maps float64 values
   to the prime field symmetrically, ``q = round(x * 2^frac_bits) mod p``,
   negatives as high residues, and refuses a field that cannot hold the sum
   of ``n_participants`` clipped values without wrapping.

3. **Round drivers, their pure half**: ``FederatedAveraging`` and
   ``WeightedFederatedAveraging`` hold a template's layout and give what a
   participant submits (``wire``: the quantized update, or the weighted
   ``(w·x, w)`` vector) and what the recipient makes of the revealed field
   sum (``finish_round``: the mean pytree, or the weighted mean and the
   total weight). Opening, sealing, clerking and revealing the round are
   the protocol plane's client roles, which the port does not hold; a
   caller carries the wire vectors through an engine round instead.

The float64 operations run in the reference's order, so results are
bit-equal to it.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.modular import positive


@dataclass(frozen=True)
class TreeDef:
    """The structure of a pytree: a node's ``kind`` (its type; ``None`` for a
    leaf), its ``keys`` (dict keys in leaf order) and its ``children``.
    Equal structures compare equal, as JAX's treedefs do."""

    kind: type | None
    keys: tuple = ()
    children: tuple = ()

    @property
    def num_leaves(self) -> int:
        return 1 if self.kind is None else sum(c.num_leaves for c in self.children)


_LEAF = TreeDef(None)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _walk(node, leaves: list) -> TreeDef:
    """Append ``node``'s leaves to ``leaves`` in JAX's order; return its
    structure."""
    kind = type(node)
    if node is None:
        return TreeDef(kind)
    if kind is dict or kind is OrderedDict:
        keys = tuple(sorted(node) if kind is dict else node)
        return TreeDef(kind, keys, tuple(_walk(node[k], leaves) for k in keys))
    if kind in (list, tuple) or _is_namedtuple(node):
        return TreeDef(kind, (), tuple(_walk(child, leaves) for child in node))
    leaves.append(node)
    return _LEAF


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """``tree -> (leaves, treedef)`` in JAX's leaf order."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef: TreeDef, leaves) -> object:
    """Inverse of ``tree_flatten``: a dict comes back with its keys in sorted
    order, as JAX rebuilds it."""
    leaves = list(leaves)
    if len(leaves) != treedef.num_leaves:
        raise ValueError(f"{len(leaves)} leaves for a treedef of {treedef.num_leaves}")
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind is None:
            return next(it)
        if td.kind is type(None):
            return None
        children = [build(c) for c in td.children]
        if td.kind is dict or td.kind is OrderedDict:
            return td.kind(zip(td.keys, children))
        if td.kind in (list, tuple):
            return td.kind(children)
        return td.kind(*children)  # namedtuple

    return build(treedef)


def _as_tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor moved to ``device`` (its own device when None) as ``dtype``;
    anything else read through numpy onto ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=x.device if device is None else device, dtype=dtype)
    np_dtype = np.float64 if dtype == torch.float64 else np.int64
    return torch.as_tensor(np.asarray(x, dtype=np_dtype), device=resolve_device(device))


def flatten_pytree(tree, device=None):
    """pytree of arrays -> ``((dim,) float64 tensor, treedef, shapes)`` on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    leaves, treedef = tree_flatten(tree)
    arrs = [_as_tensor(leaf, torch.float64, device) for leaf in leaves]
    shapes = [tuple(a.shape) for a in arrs]
    flat = (
        torch.cat([a.reshape(-1) for a in arrs])
        if arrs
        else torch.empty(0, dtype=torch.float64, device=device)
    )
    return flat, treedef, shapes


def tree_layout(tree):
    """(treedef, shapes, total size) without materializing a flat copy."""
    leaves, treedef = tree_flatten(tree)
    shapes = [tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else np.shape(leaf)
              for leaf in leaves]
    return treedef, shapes, sum(math.prod(s) for s in shapes)


def unflatten_pytree(flat, treedef: TreeDef, shapes):
    """Inverse of ``flatten_pytree``: leaves are views of ``flat`` (a tensor
    stays on its device; anything else goes to CUDA)."""
    flat = flat if isinstance(flat, torch.Tensor) else _as_tensor(flat, torch.float64, None)
    leaves = []
    offset = 0
    for shape in shapes:
        size = math.prod(shape)
        leaves.append(flat[offset : offset + size].reshape(shape))
        offset += size
    return tree_unflatten(treedef, leaves)


@dataclass(frozen=True)
class QuantizationSpec:
    """Symmetric fixed-point encoding of floats into the prime field.

    ``frac_bits`` fractional bits; ``clip`` bounds each coordinate's
    magnitude (values are clamped); ``n_participants`` is the maximum number
    of summed updates the field must hold without wraparound.
    ``quantize`` and ``dequantize_sum`` keep a tensor on its device; other
    input goes to ``device`` (CUDA unless the caller asks for the CPU).
    """

    modulus: int
    frac_bits: int
    clip: float
    n_participants: int

    def __post_init__(self):
        bound = self.n_participants * self.scale * self.clip
        if not bound < (self.modulus - 1) // 2:
            raise ValueError(
                f"field too small: {self.n_participants} participants x "
                f"2^{self.frac_bits} x clip={self.clip} needs modulus > "
                f"{int(2 * bound) + 1}, have {self.modulus}"
            )

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @classmethod
    def fitted(
        cls,
        frac_bits: int,
        clip: float,
        n_participants: int,
        *,
        secret_count: int = 5,
        privacy_threshold: int = 2,
        share_count: int = 8,
    ):
        """A field just large enough plus its sharing scheme: returns
        ``(spec, PackedShamirSharing)`` with the prime from
        ``find_packed_parameters`` at the least bit width that holds
        ``n_participants`` summed updates, and the scheme checked by
        ``verify_scheme``."""
        from ..ops import find_packed_parameters, verify_scheme
        from ..protocol import PackedShamirSharing

        need = 2.0 * n_participants * (1 << frac_bits) * clip
        bits = max(16, math.ceil(math.log2(need)) + 1)
        if bits > 61:
            raise ValueError(f"required field width {bits} bits exceeds 61")
        p, w2, w3 = find_packed_parameters(
            secret_count, privacy_threshold, share_count, min_modulus_bits=bits
        )
        scheme = PackedShamirSharing(
            secret_count=secret_count,
            share_count=share_count,
            privacy_threshold=privacy_threshold,
            prime_modulus=p,
            omega_secrets=w2,
            omega_shares=w3,
        )
        verify_scheme(scheme)
        return cls(p, frac_bits, clip, n_participants), scheme

    def quantize(self, flat, device=None) -> torch.Tensor:
        """float values -> int64 field elements in [0, p): clamp to the clip,
        round half to even (``torch.round``, as ``np.rint``), negatives as
        high residues. Non-finite values raise (they would encode as garbage
        residues and corrupt every aggregate sharing the coordinate)."""
        flat = _as_tensor(flat, torch.float64, device)
        if not bool(torch.isfinite(flat).all()):
            raise ValueError("update contains non-finite values (NaN/inf)")
        clipped = torch.clamp(flat, -self.clip, self.clip)
        q = torch.round(clipped * self.scale).to(torch.int64)
        return positive(q, self.modulus)

    def dequantize_sum(self, field_sum, device=None) -> torch.Tensor:
        """Revealed field sum -> float64 sum of the updates. Centered lift:
        residues above p // 2 are the negative range, valid because the
        field holds |sum| < p / 2."""
        v = _as_tensor(field_sum, torch.int64, device)
        half = self.modulus // 2
        centered = torch.where(v > half, v - self.modulus, v)
        return centered.to(torch.float64) / self.scale


def quantize_update(tree, spec: QuantizationSpec, device=None):
    """Model pytree -> (field vector, treedef, shapes) for participation."""
    flat, treedef, shapes = flatten_pytree(tree, device)
    return spec.quantize(flat), treedef, shapes


def dequantize_mean(field_sum, n: int, spec: QuantizationSpec, treedef, shapes, device=None):
    """Revealed field sum of n updates -> mean-update pytree. The division
    is by a tensor on the sum's device: PyTorch's CUDA kernel turns a
    division by a host scalar into a product with its reciprocal, which can
    round differently from the reference's division."""
    total = spec.dequantize_sum(field_sum, device)
    count = torch.tensor(float(n), dtype=torch.float64, device=total.device)
    return unflatten_pytree(total / count, treedef, shapes)


class FederatedAveraging:
    """The pure half of the reference's FedAvg round driver over a
    template's layout. ``spec.n_participants`` is the field's capacity
    (wraparound safety); fewer may submit, and the mean divides by the real
    count. Wire vectors and means live on ``device`` (CUDA unless the
    caller asks for the CPU)."""

    def __init__(self, spec: QuantizationSpec, template_tree, device=None):
        # layout only: no flat copy of a possibly large template model
        treedef, shapes, dim = tree_layout(template_tree)
        self.spec = spec
        self.treedef = treedef
        self.shapes = shapes
        self.dim = dim
        self.device = resolve_device(device)

    @property
    def wire_dimension(self) -> int:
        """Length of the aggregated vector; subclasses that append channels
        (a weight coordinate) override this."""
        return self.dim

    def _validated_flat(self, update_tree) -> torch.Tensor:
        """Flatten an update and verify it has the template's layout."""
        flat, treedef, shapes = flatten_pytree(update_tree, self.device)
        if treedef != self.treedef:
            raise ValueError("update pytree structure differs from template")
        if shapes != self.shapes:
            # the same treedef and size can still misalign coordinates
            # (a transposed weight matrix): reject, don't corrupt
            raise ValueError(
                f"update leaf shapes {shapes} differ from template {self.shapes}"
            )
        return flat

    def wire(self, update_tree) -> torch.Tensor:
        """Participant: the ``(wire_dimension,)`` int64 field vector that
        ``submit_update`` hands to participation."""
        return self.spec.quantize(self._validated_flat(update_tree))

    def reveal_field_sum(self, field_sum, n_submitted: int) -> torch.Tensor:
        """Recipient: the revealed ``(wire_dimension,)`` field sum as a
        canonical int64 tensor, refused, as the reference refuses it, when
        nothing was submitted or when more updates were summed than the
        field holds without wrapping (the sum would be unrecoverable)."""
        if n_submitted <= 0:
            raise ValueError("no updates were submitted; nothing to reveal")
        if n_submitted > self.spec.n_participants:
            raise ValueError(
                f"{n_submitted} updates summed but the field only "
                f"holds {self.spec.n_participants} without wraparound; re-run "
                f"the round with a spec fitted for the larger cohort"
            )
        return positive(_as_tensor(field_sum, torch.int64, self.device), self.spec.modulus)

    def finish_round(self, field_sum, n_submitted: int):
        """Recipient: the mean-update pytree of ``n_submitted`` updates."""
        field_sum = self.reveal_field_sum(field_sum, n_submitted)
        return dequantize_mean(field_sum, n_submitted, self.spec, self.treedef, self.shapes)


class WeightedFederatedAveraging(FederatedAveraging):
    """FedAvg weighted by each participant's sample count, as one round:
    each participant submits ``(w·update, w)`` as one field vector, and the
    revealed sums give ``Σw·x / Σw`` without revealing any weight or update.

    ``clip`` bounds each |update coordinate| and ``max_weight`` the weight,
    so the product channel needs ``clip·max_weight`` of per-coordinate
    headroom; ``fitted`` sizes the field for exactly that.
    """

    def __init__(self, spec: QuantizationSpec, template_tree, clip: float,
                 max_weight: float, device=None):
        super().__init__(spec, template_tree, device)
        if clip <= 0 or max_weight <= 0:
            raise ValueError("clip and max_weight must be positive")
        if clip * max_weight > spec.clip or max_weight > spec.clip:
            raise ValueError(
                f"field bound {spec.clip} below the w*x channel "
                f"({clip}*{max_weight}); build with .fitted"
            )
        self.clip = float(clip)
        self.max_weight = float(max_weight)

    @classmethod
    def fitted(cls, frac_bits: int, clip: float, max_weight: float,
               n_participants: int, template_tree, *, device=None, **shamir_kw):
        """(driver, sharing) with the field sized for the w·x channel."""
        bound = max(clip * max_weight, max_weight)
        spec, sharing = QuantizationSpec.fitted(
            frac_bits, bound, n_participants, **shamir_kw
        )
        return cls(spec, template_tree, clip, max_weight, device), sharing

    @property
    def wire_dimension(self) -> int:
        return self.dim + 1  # update coordinates + the weight

    def wire(self, update_tree, weight: float) -> torch.Tensor:
        """Participant: the quantized ``(w·x, w)`` vector of an update and
        its weight, both checked against their bounds."""
        if not 0 < weight <= self.max_weight:
            raise ValueError(
                f"weight {weight} outside (0, {self.max_weight}]"
            )
        flat = self._validated_flat(update_tree)
        if flat.numel() and float(flat.abs().max()) > self.clip:
            raise ValueError(
                f"update coordinates exceed the clip bound {self.clip}"
            )
        w = torch.tensor([float(weight)], dtype=torch.float64, device=flat.device)
        return self.spec.quantize(torch.cat([flat * weight, w]))

    def finish_round(self, field_sum, n_submitted: int):
        """-> (weighted-mean pytree, total weight)."""
        sums = self.spec.dequantize_sum(self.reveal_field_sum(field_sum, n_submitted))
        total_weight = float(sums[-1])
        mean = unflatten_pytree(
            self._weighted_flat(sums, total_weight), self.treedef, self.shapes
        )
        return mean, total_weight

    def _weighted_flat(self, sums: torch.Tensor, total_weight: float) -> torch.Tensor:
        """The flat mean from the revealed sums. Noise-free weights sum
        positive submissions, so a non-positive total means something is
        deeply wrong; the DP subclass overrides this (a noisy total can dip
        to 0 or below). The division is by a tensor on the sums' device
        (``dequantize_mean`` says why)."""
        if total_weight <= 0:
            raise ValueError("revealed total weight is not positive")
        return sums[: self.dim] / torch.tensor(total_weight, dtype=torch.float64, device=sums.device)
