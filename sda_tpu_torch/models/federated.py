"""Federated averaging over secure aggregation: pytrees <-> field vectors,
and the round drivers.

Counterpart of ``sda_tpu/models/federated.py``:

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

3. **Round drivers**: ``FederatedAveraging`` and
   ``WeightedFederatedAveraging`` run one FedAvg round over any
   ``SdaService``, as the reference's do: the recipient opens an
   aggregation sized to the wire (``open_round``), each participant
   uploads its quantized update through the full pipeline of mask, share
   and seal (``submit_update``), the recipient freezes the round
   (``close_round``) and, once the clerks have run their chores, reveals
   the field sum (``reveal_field_sum``) and its mean (``finish_round``:
   the mean pytree, or the weighted mean and the total weight). The pure
   steps are their own methods, for callers that carry the wire vectors
   through an engine round instead: ``wire`` (what a participant
   submits), ``check_field_sum`` (the reveal's refusals on a revealed
   sum) and ``mean_from_field_sum`` (what ``finish_round`` makes of it).

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
from ..telemetry.device import device_span, sync


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

    def __str__(self) -> str:
        """JAX's ``PyTreeDef`` text for the same structure, which the
        reference's checkpoints record: ``PyTreeDef({'b': *, 'w': *})``."""
        return f"PyTreeDef({self._text()})"

    def _text(self) -> str:
        if self.kind is None:
            return "*"
        if self.kind is type(None):
            return "None"
        children = [c._text() for c in self.children]
        if self.kind is dict:
            return "{" + ", ".join(f"{k!r}: {c}" for k, c in zip(self.keys, children)) + "}"
        if self.kind is list:
            return "[" + ", ".join(children) + "]"
        if self.kind is tuple:
            return "(" + ", ".join(children) + ("," if len(children) == 1 else "") + ")"
        node = (f"OrderedDict[{self.keys!r}]" if self.kind is OrderedDict
                else f"namedtuple[{self.kind.__name__}]")
        return f"CustomNode({node}, [{', '.join(children)}])"


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
        with device_span("fl.quantize"):
            flat = _as_tensor(flat, torch.float64, device)
            with sync("quantize_finite"):
                finite = bool(torch.isfinite(flat).all())
            if not finite:
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
    with device_span("fl.dequantize_mean"):
        total = spec.dequantize_sum(field_sum, device)
        count = torch.tensor(float(n), dtype=torch.float64, device=total.device)
        return unflatten_pytree(total / count, treedef, shapes)


class FederatedAveraging:
    """One secure FedAvg round over any ``SdaService``, on a template's
    layout.

    The recipient side (``open_round``, ``close_round``, ``finish_round``)
    and the participant side (``submit_update``) are separate methods: in a
    deployment they run on different machines, and the only shared state
    is the aggregation id. ``spec.n_participants`` is the field's capacity
    (wraparound safety); fewer may submit, and the mean divides by the real
    count. Wire vectors and means live on ``device`` (CUDA unless the
    caller asks for the CPU); a participant uploads its wire as host int64.
    """

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

    def open_round(self, recipient, recipient_key, committee_sharing_scheme, *,
                   title: str = "federated-round", masking_scheme=None):
        """Recipient: create and begin an aggregation sized to the wire;
        returns its id. A sharing scheme over another field than the
        spec's is refused; the default masking is ChaCha (seed-compressed,
        128-bit seeds)."""
        from ..protocol import Aggregation, AggregationId, ChaChaMasking, SodiumEncryptionScheme

        scheme_mod = getattr(
            committee_sharing_scheme, "prime_modulus", None
        ) or getattr(committee_sharing_scheme, "modulus", None)
        if scheme_mod != self.spec.modulus:
            raise ValueError(
                f"sharing scheme field {scheme_mod} != quantization field "
                f"{self.spec.modulus}"
            )
        if masking_scheme is None:
            masking_scheme = ChaChaMasking(
                modulus=self.spec.modulus, dimension=self.wire_dimension, seed_bitsize=128
            )
        agg = Aggregation(
            id=AggregationId.random(),
            title=title,
            vector_dimension=self.wire_dimension,
            modulus=self.spec.modulus,
            recipient=recipient.agent.id,
            recipient_key=recipient_key,
            masking_scheme=masking_scheme,
            committee_sharing_scheme=committee_sharing_scheme,
            recipient_encryption_scheme=SodiumEncryptionScheme(),
            committee_encryption_scheme=SodiumEncryptionScheme(),
        )
        recipient.upload_aggregation(agg)
        recipient.begin_aggregation(agg.id)
        return agg.id

    def submit_update(self, participant, aggregation_id, update_tree) -> None:
        """Participant: quantize a local update and run full participation."""
        participant.participate(self.wire(update_tree).cpu().numpy(), aggregation_id)

    def close_round(self, recipient, aggregation_id) -> None:
        """Recipient: freeze participations and enqueue the clerking jobs."""
        recipient.end_aggregation(aggregation_id)

    def reveal_field_sum(self, recipient, aggregation_id, n_submitted: int) -> torch.Tensor:
        """Recipient: reveal and return the ``(wire_dimension,)`` field sum
        as a canonical int64 tensor on ``self.device``. Call after
        ``close_round`` and the clerks' chores. Refused when nothing was
        submitted, and when more updates were summed than the field holds
        without wrapping, by the caller's count or the server's (the sum
        would be unrecoverable)."""
        summed = n_submitted
        if n_submitted > 0:
            status = recipient.service.get_aggregation_status(recipient.agent, aggregation_id)
            if status is not None:
                summed = max(n_submitted, status.number_of_participations)
        self._check_count(n_submitted, summed)
        output = recipient.reveal_aggregation(aggregation_id)
        return self.check_field_sum(np.asarray(output.positive().values, dtype=np.int64), n_submitted)

    def finish_round(self, recipient, aggregation_id, n_submitted: int):
        """Recipient: reveal (after clerking) and return the mean pytree."""
        field_sum = self.reveal_field_sum(recipient, aggregation_id, n_submitted)
        return self.mean_from_field_sum(field_sum, n_submitted)

    def _check_count(self, n_submitted: int, summed: int) -> None:
        """Refuse a reveal of nothing, or of more summed updates than the
        field holds without wraparound."""
        if n_submitted <= 0:
            raise ValueError("no updates were submitted; nothing to reveal")
        if summed > self.spec.n_participants:
            raise ValueError(
                f"{summed} updates summed but the field only "
                f"holds {self.spec.n_participants} without wraparound; re-run "
                f"the round with a spec fitted for the larger cohort"
            )

    def check_field_sum(self, field_sum, n_submitted: int) -> torch.Tensor:
        """A revealed ``(wire_dimension,)`` field sum as a canonical int64
        tensor, refused, as ``reveal_field_sum`` refuses it, when nothing
        was submitted or when more updates were summed than the field
        holds without wrapping."""
        self._check_count(n_submitted, n_submitted)
        return positive(_as_tensor(field_sum, torch.int64, self.device), self.spec.modulus)

    def mean_from_field_sum(self, field_sum, n_submitted: int):
        """The mean-update pytree of ``n_submitted`` updates from their
        revealed field sum (``finish_round``'s step after the reveal)."""
        field_sum = self.check_field_sum(field_sum, n_submitted)
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

    def open_round(self, recipient, recipient_key, committee_sharing_scheme, *,
                   title: str = "weighted-federated-round", masking_scheme=None):
        return super().open_round(
            recipient, recipient_key, committee_sharing_scheme,
            title=title, masking_scheme=masking_scheme,
        )

    def submit_update(self, participant, aggregation_id, update_tree, weight: float) -> None:
        # the wire is validated and built before ``participant`` is touched
        wire = self.wire(update_tree, weight).cpu().numpy()
        participant.participate(wire, aggregation_id)

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

    def mean_from_field_sum(self, field_sum, n_submitted: int):
        """-> (weighted-mean pytree, total weight)."""
        sums = self.spec.dequantize_sum(self.check_field_sum(field_sum, n_submitted))
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
