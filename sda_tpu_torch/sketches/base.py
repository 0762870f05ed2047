"""The linear-sketch workload plane: encode locally, sum securely, decode
globally (counterpart of ``sda_tpu/sketches/base.py``).

Every sketch in this package is linear: the sketch of a union of datasets
is the coordinate-wise sum of the per-dataset sketches, so secure
aggregation is the merge. Each participant encodes its private values into
an integer vector, the pipeline (mask, share, seal, clerk, reveal) sums
the vectors, and the recipient decodes only the cohort's sketch.

Two contracts hold the plane together:

- **Determinism.** ``encode`` is a pure function of ``(seed, row, item)``:
  BLAKE2b over a type-tagged canonical encoding of the item
  (``canonical_item_bytes``) with the seed, the row and a per-use tag in
  the message, exactly as the reference hashes, so every participant of
  either package lands an item in the same cell.
- **Exact integer sums.** ``SketchQuery`` rides ``FederatedAveraging`` with
  ``frac_bits=0`` and a field fitted to ``n_participants x cell_bound``:
  the revealed sum is the exact integer sum of the local sketches.

Encoding and decoding are host work (hashing, point queries); the summed
sketch comes back as an int64 tensor on the query's device (CUDA unless
the caller asks for the CPU).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import telemetry
from ..models.federated import FederatedAveraging, QuantizationSpec
from ..models.statistics import canonical_item_bytes


def sketch_hash(seed: int, row: int, item, tag: bytes = b"") -> int:
    """64-bit hash of one item, pure in ``(seed, row, item, tag)``. ``tag``
    separates hash uses that share a seed and row (the count-sketch bucket
    hash and its sign hash); seed and row are fixed-width, so no two
    (seed, row) pairs collide by concatenation."""
    h = hashlib.blake2b(
        tag
        + b"\x00"
        + int(seed).to_bytes(8, "big", signed=False)
        + int(row).to_bytes(4, "big", signed=False)
        + canonical_item_bytes(item),
        digest_size=8,
    )
    return int.from_bytes(h.digest(), "big")


class LinearSketch:
    """Interface every sketch family implements.

    - ``kind``: the family's short name (``"countmin"``, ...), the
      ``workload`` telemetry label.
    - ``dim``: the wire vector length.
    - ``encode(values) -> (dim,) int64``: this participant's local sketch,
      pure in ``(seed, values)``.
    - ``decode(summed, n) -> dict``: the family's estimates off the summed
      sketch of ``n`` participants, each beside its analytic error bound.
    - ``cell_bound(max_values) -> int``: the largest magnitude one
      participant holding ``max_values`` values can put in one coordinate;
      ``SketchQuery`` fits the field to ``n_participants x cell_bound``.
    """

    kind: str = "sketch"
    dim: int = 0

    def encode(self, values) -> np.ndarray:
        raise NotImplementedError

    def decode(self, summed, n: int) -> dict:
        raise NotImplementedError

    def cell_bound(self, max_values: int) -> int:
        """Default: all of one participant's values can land in one cell
        (true for every counting sketch in this package)."""
        return int(max_values)

    def _check_summed(self, summed) -> np.ndarray:
        """The summed sketch (a tensor on any device, or array-like) as a
        host int64 array of this sketch's length."""
        if isinstance(summed, torch.Tensor):
            summed = summed.cpu().numpy()
        summed = np.asarray(summed, dtype=np.int64).reshape(-1)
        if summed.shape != (self.dim,):
            raise ValueError(
                f"summed sketch has shape {summed.shape}, expected ({self.dim},)"
            )
        return summed


class SketchQuery:
    """One secure round of any ``LinearSketch`` over any ``SdaService``, in
    ``SecureHistogram``'s shape: open, submit, close, finish, with
    ``frac_bits=0``. ``finish`` returns the summed sketch (centered int64:
    count-sketch cells are signed) and ticks
    ``sda_workload_rounds_total{workload=<kind>}``; ``finish_decoded`` also
    decodes it. ``max_values_per_participant`` bounds one participant's
    value count and, through ``sketch.cell_bound``, sizes the field;
    ``submit`` refuses an encode above the fitted cell bound.
    """

    def __init__(self, sketch: LinearSketch, n_participants: int,
                 max_values_per_participant: int = 1 << 20, *, device=None, **shamir_kw):
        if sketch.dim < 1:
            raise ValueError("sketch dimension must be >= 1")
        self.sketch = sketch
        self.max_values = int(max_values_per_participant)
        self._cell_bound = int(sketch.cell_bound(self.max_values))
        self.spec, self.sharing = QuantizationSpec.fitted(
            0, float(self._cell_bound), n_participants, **shamir_kw
        )
        self.fed = FederatedAveraging(self.spec, {"sketch": np.zeros(sketch.dim)}, device)

    def open_round(self, recipient, recipient_key, sharing=None, *, title=None):
        """Recipient: open the aggregation. ``sharing`` defaults to the
        fitted packed-Shamir scheme; any scheme over the same field works."""
        return self.fed.open_round(
            recipient,
            recipient_key,
            self.sharing if sharing is None else sharing,
            title=title or f"sketch-{self.sketch.kind}",
        )

    def local_sketch(self, values) -> np.ndarray:
        """Validate and encode one participant's values (the submit path's
        own step, so drivers can sum exactly what is sent)."""
        values = list(values)
        if len(values) > self.max_values:
            raise ValueError(f"more than {self.max_values} values")
        enc = np.asarray(self.sketch.encode(values), dtype=np.int64).reshape(-1)
        if enc.shape != (self.sketch.dim,):
            raise ValueError(
                f"encode returned shape {enc.shape}, expected ({self.sketch.dim},)"
            )
        if enc.size and int(np.abs(enc).max()) > self._cell_bound:
            raise ValueError(
                f"encoded cell magnitude {int(np.abs(enc).max())} exceeds the "
                f"fitted bound {self._cell_bound}"
            )
        return enc

    def submit(self, participant, aggregation_id, values) -> None:
        self.fed.submit_update(
            participant, aggregation_id, {"sketch": self.local_sketch(values).astype(np.float64)}
        )

    def close_round(self, recipient, aggregation_id) -> None:
        self.fed.close_round(recipient, aggregation_id)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> torch.Tensor:
        """-> (dim,) int64 exact summed sketch: the centered lift of the
        field sum (``frac_bits=0`` and the fitted field keep |sum| < p/2,
        so the lifted residues are the integer sums)."""
        raw = self.fed.reveal_field_sum(recipient, aggregation_id, n_submitted)
        summed = torch.round(self.spec.dequantize_sum(raw)).to(torch.int64)
        if telemetry.enabled():
            telemetry.counter(
                "sda_workload_rounds_total",
                "completed secure workload rounds by workload family",
                workload=self.sketch.kind,
            ).inc()
        return summed

    def finish_decoded(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """-> {"summed": (dim,) int64, **sketch.decode(summed, n)}."""
        summed = self.finish(recipient, aggregation_id, n_submitted)
        out = {"summed": summed}
        out.update(self.sketch.decode(summed, n_submitted))
        return out
