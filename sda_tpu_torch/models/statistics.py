"""Secure statistics over the aggregation protocol: mean, variance,
covariance, histograms, quantiles, frequencies and distinct counts,
computed across participants without revealing any individual's data
(counterpart of ``sda_tpu/models/statistics.py``).

Each query is a FedAvg round over a derived "model" (``FederatedAveraging``:
open, submit, close, finish), so it inherits masking, packed-Shamir
sharing, sealed transport and dropout tolerance:

- **mean / variance**: each participant submits ``[x, x**2]`` per
  coordinate; the revealed sums give ``E[x]`` and ``E[x**2]``.
- **covariance**: ``[x, vech(x xᵀ)]``; the revealed sums give
  ``E[x xᵀ] − E[x]E[x]ᵀ``, and federated PCA is its eigendecomposition.
- **histogram, frequency, distinct counts**: local bin counts at
  ``frac_bits=0``, so the revealed sum is the exact cohort count.

Integer results (counts, frequencies, distinct-count bins) are exact int64
tensors; float results are float64 tensors on the query's device (CUDA
unless the caller asks for the CPU), computed elementwise in the
reference's order. Hashing and the quantile search are host work, as in
the reference.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..device import resolve_device
from .federated import FederatedAveraging, QuantizationSpec, _as_tensor, unflatten_pytree


def canonical_item_bytes(item) -> bytes:
    """Type-tagged canonical encoding of one hashable item, shared by every
    workload that hashes participant items (``SecureCountDistinct``, the
    sketches): equal logical items must hash identically on every
    participant, which ``repr`` does not give. str, bytes, int/bool and
    float (and numpy scalars of them); anything else raises. Integral
    floats and bools encode as their int, as Python sets equate them."""
    if isinstance(item, bytes):
        return b"b" + item
    if isinstance(item, str):
        return b"s" + item.encode("utf-8")
    if isinstance(item, (bool, np.bool_, int, np.integer)):
        return b"i" + str(int(item)).encode("ascii")
    if isinstance(item, (float, np.floating)):
        f = float(item)
        if f.is_integer():
            return b"i" + str(int(f)).encode("ascii")
        return b"f" + repr(f).encode("ascii")
    raise TypeError(
        f"hashed items must be str, bytes, int, or float "
        f"(got {type(item).__name__}); hash-stable canonical encoding "
        "is required for the cross-participant union"
    )


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _validate_vector(values, dim: int, clip: float, device) -> torch.Tensor:
    """Shared submission check: shape ``(dim,)``, |coordinate| ≤ clip."""
    values = _as_tensor(values, torch.float64, device)
    if tuple(values.shape) != (dim,):
        raise ValueError(f"expected ({dim},) values, got {tuple(values.shape)}")
    if values.numel() and float(values.abs().max()) > clip:
        raise ValueError(f"values exceed clip bound {clip}")
    return values


class SecureStatistics:
    """Cohort mean and variance of ``(dim,)`` float vectors, privately.

    ``clip`` bounds each |coordinate|; squares are bounded by ``clip**2``,
    so the field is fitted to ``max(clip, clip**2)``.
    """

    def __init__(self, dim: int, clip: float, n_participants: int, frac_bits: int = 16,
                 device=None):
        self.dim = dim
        self.clip = clip
        bound = max(clip, clip * clip)
        self.spec, self.sharing = QuantizationSpec.fitted(frac_bits, bound, n_participants)
        template = {"sum": np.zeros(dim), "sumsq": np.zeros(dim)}
        self.fed = FederatedAveraging(self.spec, template, device)

    def open_round(self, recipient, recipient_key):
        return self.fed.open_round(recipient, recipient_key, self.sharing, title="secure-statistics")

    def _checked_tree(self, values) -> dict:
        """Validate one submission and build its ``[x, x²]`` channel."""
        values = _validate_vector(values, self.dim, self.clip, self.fed.device)
        return {"sum": values, "sumsq": values * values}

    def submit(self, participant, aggregation_id, values) -> None:
        self.fed.submit_update(participant, aggregation_id, self._checked_tree(values))

    def close_round(self, recipient, aggregation_id) -> None:
        self.fed.close_round(recipient, aggregation_id)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """-> {"count", "mean", "variance"} (population variance)."""
        means = self.fed.finish_round(recipient, aggregation_id, n_submitted)
        mean = means["sum"]
        variance = torch.clamp(means["sumsq"] - mean * mean, min=0.0)
        return {"count": n_submitted, "mean": mean, "variance": variance}


class SecureCovariance:
    """Cohort covariance (and correlation) of ``(dim,)`` vectors, privately.

    Each participant submits ``[x, vech(x xᵀ)]``, its vector and the upper
    triangle of its outer product; the revealed sums give the population
    covariance ``E[x xᵀ] − E[x]E[x]ᵀ``, exact in the field up to
    quantization. ``clip`` bounds each |coordinate|, so the field is fitted
    to ``max(clip, clip²)``.
    """

    def __init__(self, dim: int, clip: float, n_participants: int, frac_bits: int = 16,
                 device=None):
        if dim < 1:
            raise ValueError("dim must be >= 1")
        self.dim = dim
        self.clip = float(clip)
        bound = max(clip, clip * clip)
        self.spec, self.sharing = QuantizationSpec.fitted(frac_bits, bound, n_participants)
        template = {"sum": np.zeros(dim), "outer": np.zeros(dim * (dim + 1) // 2)}
        self.fed = FederatedAveraging(self.spec, template, device)
        # numpy's triu_indices order: row-major upper triangle
        self._triu = tuple(torch.triu_indices(dim, dim, device=self.fed.device))

    def open_round(self, recipient, recipient_key):
        return self.fed.open_round(recipient, recipient_key, self.sharing, title="secure-covariance")

    def _checked_tree(self, values) -> dict:
        """Validate one submission and build its ``[x, vech(x xᵀ)]`` channel."""
        values = _validate_vector(values, self.dim, self.clip, self.fed.device)
        return {"sum": values, "outer": torch.outer(values, values)[self._triu]}

    def submit(self, participant, aggregation_id, values) -> None:
        self.fed.submit_update(participant, aggregation_id, self._checked_tree(values))

    def close_round(self, recipient, aggregation_id) -> None:
        self.fed.close_round(recipient, aggregation_id)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """-> {"count", "mean", "covariance"} (population covariance, PSD up
        to quantization error)."""
        means = self.fed.finish_round(recipient, aggregation_id, n_submitted)
        mean = means["sum"]
        m2 = torch.zeros((self.dim, self.dim), dtype=torch.float64, device=mean.device)
        m2[self._triu] = means["outer"]
        m2 = m2 + m2.T - torch.diag(torch.diag(m2))  # mirror the upper triangle
        cov = m2 - torch.outer(mean, mean)
        # quantization can push a near-constant coordinate's variance a hair
        # negative; clamp so sqrt(diag) downstream stays finite
        cov.diagonal().clamp_(min=0.0)
        return {"count": n_submitted, "mean": mean, "covariance": cov}

    @staticmethod
    def correlation_from_covariance(cov) -> torch.Tensor:
        """Correlation matrix; zero-variance coordinates yield zero
        off-diagonals and a unit diagonal."""
        cov = _as_tensor(cov, torch.float64, None)
        std = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
        denom = torch.outer(std, std)
        corr = torch.where(denom > 0, cov / denom, torch.zeros_like(cov))
        corr.fill_diagonal_(1.0)
        return torch.clamp(corr, -1.0, 1.0)

    def finish_correlation(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """Like ``finish`` plus the correlation matrix."""
        result = self.finish(recipient, aggregation_id, n_submitted)
        result["correlation"] = self.correlation_from_covariance(result["covariance"])
        return result

    @staticmethod
    def principal_components(cov, k: int):
        """Top-``k`` eigenpairs of a revealed covariance matrix (federated
        PCA: the only cross-party computation was the secure covariance).

        Returns ``(eigenvalues, components)``: eigenvalues descending,
        clamped at 0; components as ``(k, dim)`` rows, each signed so its
        largest-|coordinate| entry is positive.
        """
        cov = _as_tensor(cov, torch.float64, None)
        if cov.ndim != 2 or cov.shape[0] != cov.shape[1]:
            raise ValueError("covariance must be square")
        if not 1 <= k <= cov.shape[0]:
            raise ValueError(f"k must be in [1, {cov.shape[0]}]")
        eigvals, eigvecs = torch.linalg.eigh((cov + cov.T) / 2.0)
        # numpy's argsort reversed: ties in the reference's order
        order = torch.flip(torch.argsort(eigvals, stable=True), [0])[:k]
        values = torch.clamp(eigvals[order], min=0.0)
        components = eigvecs[:, order].T
        pivots = components.abs().argmax(dim=1, keepdim=True)
        signs = torch.where(components.gather(1, pivots) < 0, -1.0, 1.0)
        return values, components * signs


class SecureHistogram:
    """Cohort histogram over ``bins`` equal-width bins of ``[lo, hi)``.

    Each participant submits its local bin counts (integers,
    ``frac_bits=0``: exact), at most ``max_values_per_participant`` values.
    Out-of-range values clamp to the edge bins.
    """

    def __init__(self, bins: int, lo: float, hi: float, n_participants: int,
                 max_values_per_participant: int = 1 << 20, device=None):
        self._init_geometry(bins, lo, hi, max_values_per_participant)
        self.spec, self.sharing = QuantizationSpec.fitted(
            0, float(max_values_per_participant), n_participants
        )
        self.fed = FederatedAveraging(self.spec, {"counts": np.zeros(bins)}, device)

    def _init_geometry(self, bins, lo, hi, max_values):
        """Bin geometry shared with subclasses that build their own field."""
        if not (bins > 0 and hi > lo):
            raise ValueError("need bins > 0 and hi > lo")
        self.bins = bins
        self.lo, self.hi = float(lo), float(hi)
        self.max_values = max_values

    def local_counts(self, values) -> torch.Tensor:
        values = _as_tensor(values, torch.float64, self.fed.device).reshape(-1)
        if values.numel() > self.max_values:
            raise ValueError(f"more than {self.max_values} values")
        if not bool(torch.isfinite(values).all()):
            raise ValueError("values contain non-finite entries (NaN/inf)")
        # the divisor is a device tensor: CUDA divides by a host scalar as a
        # product with its reciprocal, which can round a bin edge differently
        span = torch.tensor(self.hi - self.lo, dtype=torch.float64, device=values.device)
        ixf = torch.floor((values - self.lo) / span * self.bins)
        # clamp before the int cast: a huge float would overflow int64 and
        # land a value above hi in the lowest bin
        ix = torch.clamp(ixf, 0, self.bins - 1).to(torch.int64)
        return torch.bincount(ix, minlength=self.bins).to(torch.float64)

    def open_round(self, recipient, recipient_key):
        return self.fed.open_round(recipient, recipient_key, self.sharing, title="secure-histogram")

    def submit(self, participant, aggregation_id, values) -> None:
        self.fed.submit_update(participant, aggregation_id, {"counts": self.local_counts(values)})

    def close_round(self, recipient, aggregation_id) -> None:
        self.fed.close_round(recipient, aggregation_id)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> torch.Tensor:
        """-> (bins,) int64 exact cohort counts, read straight off the
        integer field sum (``frac_bits=0`` and wraparound-guarded, so the
        residues are the counts)."""
        return self.fed.reveal_field_sum(recipient, aggregation_id, n_submitted)


class SecureGroupedMean:
    """Per-category cohort means ("mean latency by region"), privately.

    Each participant holds observations ``(category, value-vector)`` with
    categories in ``{0, …, groups-1}`` and ``|value coordinate| ≤ clip``,
    and submits a scatter: a ``(groups, dim)`` matrix of its per-category
    sums and a ``(groups,)`` count vector, zeros where it has no data, so
    the round does not reveal which categories anyone contributed to. The
    field holds ``n · max_values · clip`` per coordinate.
    """

    def __init__(self, groups: int, dim: int, clip: float, n_participants: int, *,
                 frac_bits: int = 16, max_values_per_participant: int = 1 << 10, device=None):
        if groups < 1 or dim < 1:
            raise ValueError("groups and dim must be >= 1")
        if clip <= 0:
            raise ValueError("clip must be positive")
        self.groups = groups
        self.dim = dim
        self.clip = float(clip)
        self.max_values = max_values_per_participant
        bound = max(clip, 1.0) * max_values_per_participant
        self.spec, self.sharing = QuantizationSpec.fitted(frac_bits, bound, n_participants)
        template = {"sums": np.zeros((groups, dim)), "counts": np.zeros(groups)}
        self.fed = FederatedAveraging(self.spec, template, device)

    def local_scatter(self, observations) -> dict:
        """``[(category, value-vector), …]`` -> this participant's
        {"sums", "counts"} contribution."""
        device = self.fed.device
        sums = torch.zeros((self.groups, self.dim), dtype=torch.float64, device=device)
        counts = torch.zeros(self.groups, dtype=torch.float64, device=device)
        observations = list(observations)
        if len(observations) > self.max_values:
            raise ValueError(f"more than {self.max_values} observations")
        for cat, vec in observations:
            cat = int(cat)
            if not 0 <= cat < self.groups:
                raise ValueError(f"category {cat} outside [0, {self.groups})")
            sums[cat] += _validate_vector(vec, self.dim, self.clip, device)
            counts[cat] += 1
        return {"sums": sums, "counts": counts}

    def open_round(self, recipient, recipient_key):
        return self.fed.open_round(recipient, recipient_key, self.sharing, title="secure-grouped-mean")

    def submit(self, participant, aggregation_id, observations) -> None:
        self.fed.submit_update(participant, aggregation_id, self.local_scatter(observations))

    def close_round(self, recipient, aggregation_id) -> None:
        self.fed.close_round(recipient, aggregation_id)

    def _revealed_tree(self, recipient, aggregation_id, n_submitted: int) -> dict:
        raw = self.fed.reveal_field_sum(recipient, aggregation_id, n_submitted)
        # decoded by name through the stored layout
        return unflatten_pytree(self.spec.dequantize_sum(raw), self.fed.treedef, self.fed.shapes)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """-> {"counts": (groups,) int64, "means": (groups, dim) float64,
        NaN rows for categories nobody contributed to}."""
        tree = self._revealed_tree(recipient, aggregation_id, n_submitted)
        counts = torch.round(tree["counts"]).to(torch.int64)
        totals = tree["sums"]
        means = torch.full((self.groups, self.dim), float("nan"), dtype=torch.float64,
                           device=totals.device)
        nonzero = counts > 0
        means[nonzero] = totals[nonzero] / counts[nonzero].unsqueeze(1)
        return {"counts": counts, "means": means}


def quantiles_from_histogram(counts, lo: float, hi: float, qs, device=None) -> torch.Tensor:
    """Quantile estimates from equal-width bin ``counts`` over ``[lo, hi)``:
    the exact cohort histogram fixes each quantile to within one bin width,
    and linear interpolation inside the containing bin gives the point
    estimate. ``qs`` in [0, 1]; returns one float64 estimate per q, on the
    counts' device (a tensor's own; else ``device``, CUDA unless the caller
    asks for the CPU). Empty cohorts raise. The search is host work."""
    out_device = counts.device if isinstance(counts, torch.Tensor) else resolve_device(device)
    counts = _host(counts).astype(np.float64).reshape(-1)
    if counts.sum() <= 0:
        raise ValueError("empty histogram: no quantiles")
    qs = np.asarray(list(qs), dtype=np.float64)  # materialize: qs may be an iterator
    bins = len(counts)
    width = (hi - lo) / bins
    cum = np.cumsum(counts)
    total = cum[-1]
    out = np.empty(len(qs), dtype=np.float64)
    for i, q in enumerate(qs):
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        target = q * total
        b = int(np.searchsorted(cum, target, side="left"))
        b = min(b, bins - 1)
        # searchsorted lands on the leading cum == 0 plateau for q = 0 (and
        # on any empty-bin boundary): advance to the bin that holds the
        # target's mass so the one-bin-width bound holds
        while counts[b] == 0 and b < bins - 1 and cum[b] < total:
            b += 1
        prev = cum[b - 1] if b > 0 else 0.0
        inbin = counts[b]
        frac = 0.0 if inbin == 0 else (target - prev) / inbin
        out[i] = lo + (b + min(max(frac, 0.0), 1.0)) * width
    return torch.as_tensor(out, device=out_device)


class SecureQuantiles(SecureHistogram):
    """Cohort quantiles through the exact secure histogram; estimates are
    within one bin width ``(hi - lo) / bins``."""

    def finish_quantiles(self, recipient, aggregation_id, n_submitted, qs) -> torch.Tensor:
        counts = self.finish(recipient, aggregation_id, n_submitted)
        return quantiles_from_histogram(counts, self.lo, self.hi, qs)


class SecureFrequency(SecureHistogram):
    """Exact cohort frequency counts over a categorical domain
    ``{0, …, domain_size−1}``: a category is its bin. ``finish_top_k``
    returns the k most frequent categories with their counts."""

    def __init__(self, domain_size: int, n_participants: int, **kw):
        super().__init__(bins=domain_size, lo=0.0, hi=float(domain_size),
                         n_participants=n_participants, **kw)

    def local_counts(self, values) -> torch.Tensor:
        values = _host(values).reshape(-1)
        if values.size and (
            not np.issubdtype(values.dtype, np.integer)
            or values.min() < 0
            or values.max() >= self.bins
        ):
            raise ValueError(f"categories must be integers in [0, {self.bins})")
        if values.size > self.max_values:
            raise ValueError(f"more than {self.max_values} values")
        # bincount of the validated integers: the parent's float bin formula
        # can round below v (v = 1, D = 49) and credit the wrong category
        ix = torch.as_tensor(values.astype(np.int64), device=self.fed.device)
        return torch.bincount(ix, minlength=self.bins).to(torch.float64)

    def finish_top_k(self, recipient, aggregation_id, n_submitted, k):
        """-> list of (category, count), k most frequent, count-descending
        (ties broken by category id)."""
        counts = _host(self.finish(recipient, aggregation_id, n_submitted))
        order = np.lexsort((np.arange(len(counts)), -counts))[:k]
        return [(int(c), int(counts[c])) for c in order]


class SecureCountDistinct(SecureHistogram):
    """Cohort count-distinct over an unknown or huge item domain.

    Each participant hashes its locally distinct items into an ``m``-bin
    0/1 sketch (BLAKE2b keyed by a round salt all participants share), the
    protocol sums the sketches, and linear counting (Whang–Vander-Zanden–
    Taylor 1990) estimates the union's size from the untouched bins:
    ``n̂ = -m·ln(z/m)``, under ~1 % error for ``m ≥ 2n``.
    """

    def __init__(self, m: int, n_participants: int, *, salt: str = "",
                 max_values_per_participant: int = 1 << 20, device=None):
        self._init_geometry(m, 0.0, float(m), max_values_per_participant)
        # 0/1 cells per participant: the per-bin sum is at most n_participants
        self.spec, self.sharing = QuantizationSpec.fitted(0, 1.0, n_participants)
        self.fed = FederatedAveraging(self.spec, {"counts": np.zeros(m)}, device)
        self.salt = salt

    _canonical_bytes = staticmethod(canonical_item_bytes)

    def _bin_of(self, item) -> int:
        # the salt is mixed into the message (blake2b's salt parameter
        # truncates at 16 bytes and would alias long salts)
        h = hashlib.blake2b(
            self.salt.encode() + b"\x00" + self._canonical_bytes(item), digest_size=8
        )
        return int.from_bytes(h.digest(), "big") % self.bins

    def local_counts(self, items) -> torch.Tensor:
        """Locally deduped 0/1 sketch of this participant's items."""
        distinct = set(items)
        if len(distinct) > self.max_values:
            raise ValueError(f"more than {self.max_values} values")
        out = torch.zeros(self.bins, dtype=torch.float64, device=self.fed.device)
        touched = torch.as_tensor(sorted({self._bin_of(x) for x in distinct}), dtype=torch.int64)
        out[touched.to(out.device)] = 1.0
        return out

    @staticmethod
    def estimate_from_counts(counts) -> float:
        """Linear-counting estimate off the revealed summed sketch."""
        counts = _host(counts)
        m = len(counts)
        zeros = int(np.count_nonzero(counts == 0))
        if zeros == 0:
            raise ValueError(
                f"sketch saturated (0 of {m} bins empty): raise m beyond "
                "~2x the expected distinct count and re-run"
            )
        return float(-m * np.log(zeros / m))

    def finish_estimate(self, recipient, aggregation_id, n_submitted) -> float:
        """-> estimated number of distinct items across the cohort."""
        return self.estimate_from_counts(self.finish(recipient, aggregation_id, n_submitted))
