"""Distributed differential privacy for the FedAvg and statistics drivers
(counterpart of ``sda_tpu/models/dp.py``: the discrete-Gaussian noise, the
zCDP accountant, the DP FedAvg drivers and the DP statistics drivers).

Every participant adds a small amount of integer noise to its quantized
contribution before sharing, so the revealed aggregate carries
central-DP-calibrated noise that no single party can subtract:

- **Discrete Gaussian** noise (Canonne–Kamath–Steinke 2020): integer-valued,
  exactly (Δ₂²/2σ²)-zCDP, drawn by their rejection scheme from a discrete
  Laplace proposal. Each of n participants adds noise with
  σ_party = σ_total/√n, and the aggregate is accounted as a discrete
  Gaussian of σ_total (the distributed-DP approximation of Kairouz–Liu–
  Steinke 2021, accurate when σ_party ≳ 1, which ``min_party_sigma``
  enforces).
- **Skellam** noise (Agarwal–Kairouz–Liu 2021), Poisson(μ/2)−Poisson(μ/2),
  as an alternative sampler without formal accounting.

The samplers draw on the device of a ``torch.Generator`` (the port's rule
for randomness), so their draws are not the reference's numpy draws; the
distribution and the acceptance rule are the same. The accountant is host
scalar arithmetic in the reference's own numpy operations, bit-equal to
it. Noise is added in integer field space after quantization, the
sensitivity includes the √d/2 rounding slack, and the field keeps
``NOISE_TAIL_SIGMAS``·σ_total of headroom, as in the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .federated import (
    FederatedAveraging,
    QuantizationSpec,
    WeightedFederatedAveraging,
    _as_tensor,
    tree_layout,
)
from .statistics import SecureCovariance, SecureGroupedMean, SecureHistogram, SecureStatistics

# Field headroom reserved for aggregate noise, in units of sigma_total.
# Sub-Gaussian tail: P(|noise| > k*sigma) <= 2*exp(-k^2/2) ~ 5e-32 at 12.
NOISE_TAIL_SIGMAS = 12.0


# ---------------------------------------------------------------------------
# Samplers (integer-valued, torch.Generator based)
# ---------------------------------------------------------------------------


def _shape(size) -> tuple:
    return (int(size),) if np.isscalar(size) else tuple(size)


def fresh_generator(device=None) -> torch.Generator:
    """A generator on ``device`` (CUDA unless the caller asks for the CPU)
    seeded from the OS, as the reference's ``np.random.default_rng()``."""
    generator = torch.Generator(device=resolve_device(device))
    generator.seed()
    return generator


def sample_discrete_laplace(t: float, size, generator: torch.Generator) -> torch.Tensor:
    """Discrete Laplace with scale ``t``: P(x) ∝ exp(-|x|/t) on Z, as int64
    on the generator's device. Difference of two iid geometrics on
    {0, 1, ...} with q = exp(-1/t)."""
    if t <= 0:
        raise ValueError("scale t must be positive")
    p = -math.expm1(-1.0 / t)  # 1 - exp(-1/t), accurately for large t
    g = torch.empty((2,) + _shape(size), dtype=torch.float64, device=generator.device)
    g.geometric_(p, generator=generator)
    return (g[0] - g[1]).to(torch.int64)


def sample_discrete_gaussian(sigma: float, size, generator: torch.Generator) -> torch.Tensor:
    """Discrete Gaussian N_Z(0, σ²): P(x) ∝ exp(-x²/2σ²) on Z, as int64 on
    the generator's device. Canonne–Kamath–Steinke rejection sampler:
    propose from discrete Laplace with t = ⌊σ⌋+1, accept with
    exp(-(|y| - σ²/t)²/(2σ²)) in float64, over-drawing 2.5x per pass as the
    reference does."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    shape = _shape(size)
    n = math.prod(shape)
    t = math.floor(sigma) + 1
    two_var = 2.0 * sigma * sigma
    shift = sigma * sigma / t
    parts, filled = [], 0
    while filled < n:
        m = max(int((n - filled) * 2.5) + 16, 32)
        y = sample_discrete_laplace(t, m, generator)
        dev = y.abs().to(torch.float64) - shift
        u = torch.rand(m, generator=generator, dtype=torch.float64, device=generator.device)
        got = y[u < torch.exp(-(dev * dev) / two_var)][: n - filled]
        parts.append(got)
        filled += got.numel()
    if not parts:
        return torch.empty(shape, dtype=torch.int64, device=generator.device)
    return torch.cat(parts).reshape(shape)


def sample_skellam(mu: float, size, generator: torch.Generator) -> torch.Tensor:
    """Skellam(μ/2, μ/2): Poisson(μ/2) − Poisson(μ/2); variance μ. Closed
    under addition: n parties each adding Skellam(μ/n) give Skellam(μ)."""
    if mu <= 0:
        raise ValueError("mu must be positive")
    rates = torch.full((2,) + _shape(size), mu / 2.0, dtype=torch.float64,
                       device=generator.device)
    draws = torch.poisson(rates, generator=generator).to(torch.int64)
    return draws[0] - draws[1]


# ---------------------------------------------------------------------------
# Accounting: zCDP for the (distributed) discrete Gaussian
# ---------------------------------------------------------------------------


def zcdp_rho(l2_sensitivity: float, sigma_total: float) -> float:
    """ρ of ρ-zCDP for discrete Gaussian noise N_Z(0, σ²) per coordinate
    against integer shifts of L2 norm ≤ Δ₂ (CKS 2020, Thm 14)."""
    if sigma_total <= 0:
        raise ValueError("sigma must be positive")
    return (l2_sensitivity * l2_sensitivity) / (2.0 * sigma_total * sigma_total)


def delta_from_zcdp(rho: float, eps: float) -> float:
    """Tight δ(ε) for a ρ-zCDP mechanism (RDP curve ε(α) = ρα):
    δ = min_{α>1} exp((α−1)(ρα − ε)) · (1 − 1/α)^α / (α − 1)
    (CKS 2020, Prop. 12), over a grid around α* = (ε + ρ)/(2ρ)."""
    if rho <= 0:
        return 0.0 if eps >= 0 else 1.0
    a_star = max((eps + rho) / (2.0 * rho), 1.0 + 1e-9)
    grid = np.concatenate(
        [
            np.linspace(1.0 + 1e-6, 2.0, 64),
            a_star * np.geomspace(0.25, 4.0, 129),
        ]
    )
    g = grid[grid > 1.0]
    dlog = (g - 1.0) * (rho * g - eps) + g * np.log1p(-1.0 / g) - np.log(g - 1.0)
    return float(min(1.0, math.exp(dlog.min())))


def eps_from_zcdp(rho: float, delta: float) -> float:
    """Tight ε for ρ-zCDP at a target δ (bisection on ``delta_from_zcdp``),
    never above the classic ρ + 2·sqrt(ρ·ln(1/δ)) closed form."""
    if not 0.0 < delta < 1.0:
        raise ValueError("delta must be in (0, 1)")
    if rho <= 0:
        return 0.0
    classic = rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))
    lo, hi = 0.0, classic
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if delta_from_zcdp(rho, mid) > delta:
            lo = mid
        else:
            hi = mid
    return hi


def noise_multiplier_for(eps: float, delta: float) -> float:
    """Smallest z = σ_total/Δ₂ achieving (ε, δ)-DP (bisection)."""
    if eps <= 0:
        raise ValueError("eps must be positive")
    lo, hi = 1e-4, 1.0
    while eps_from_zcdp(zcdp_rho(1.0, hi), delta) > eps:
        hi *= 2.0
        if hi > 1e8:
            raise ValueError("unreachable privacy target")
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if eps_from_zcdp(zcdp_rho(1.0, mid), delta) > eps:
            lo = mid
        else:
            hi = mid
    return hi


@dataclass(frozen=True)
class PrivacyAccount:
    """Realized guarantee of one revealed aggregate."""

    epsilon: float
    delta: float
    rho: float
    sigma_total: float  # field units
    l2_sensitivity: float  # field units
    n_parties: int


@dataclass(frozen=True)
class ComposedPrivacy:
    """Cumulative guarantee over a sequence of releases (zCDP ledger)."""

    epsilon: float
    delta: float
    rho: float
    rounds: int


def compose_rhos(rhos, delta: float) -> ComposedPrivacy:
    """zCDP composition: ρ adds across releases; one tight (ε, δ)
    conversion at the end."""
    rhos = [float(r) for r in rhos]
    rho = sum(rhos)
    if math.isinf(rho):
        # a release without accounting (Skellam) enters as rho=inf: the
        # composed guarantee is "unbounded", never understated
        return ComposedPrivacy(epsilon=math.inf, delta=delta, rho=rho,
                               rounds=len(rhos))
    return ComposedPrivacy(
        epsilon=eps_from_zcdp(rho, delta), delta=delta, rho=rho,
        rounds=len(rhos),
    )


def compose_accounts(accounts, delta: float | None = None) -> ComposedPrivacy:
    """Compose per-release ``PrivacyAccount``s; δ defaults to the loosest
    (largest) per-release δ."""
    accounts = list(accounts)
    if not accounts:
        raise ValueError("nothing to compose")
    if delta is None:
        delta = max(a.delta for a in accounts)
    return compose_rhos([a.rho for a in accounts], delta)


# ---------------------------------------------------------------------------
# Mechanism configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DPConfig:
    """Distributed-noise configuration.

    ``l2_clip`` bounds each participant's update L2 norm (real units);
    ``noise_multiplier`` z sets σ_total = z · Δ₂ (field units, Δ₂ the
    quantized sensitivity); ``expected_participants`` n splits the noise:
    each party adds σ_party = σ_total/√n. ``min_party_sigma`` guards the
    distributed≈central approximation.
    """

    l2_clip: float
    noise_multiplier: float
    expected_participants: int
    delta: float = 1e-6
    mechanism: str = "dgauss"  # "dgauss" | "skellam"
    min_party_sigma: float = 1.0

    def __post_init__(self):
        if self.l2_clip <= 0:
            raise ValueError("l2_clip must be positive")
        if self.noise_multiplier <= 0:
            raise ValueError("noise_multiplier must be positive")
        if self.expected_participants < 1:
            raise ValueError("need at least one participant")
        if self.mechanism not in ("dgauss", "skellam"):
            raise ValueError(f"unknown mechanism {self.mechanism!r}")

    def sensitivity_field(self, scale: int, dim: int) -> float:
        """Quantized L2 sensitivity: C·2^f plus the √d/2 rounding slack."""
        return self.l2_clip * scale + 0.5 * math.sqrt(dim)

    def sigma_total_field(self, scale: int, dim: int) -> float:
        return self.noise_multiplier * self.sensitivity_field(scale, dim)

    def sigma_party_field(self, scale: int, dim: int) -> float:
        return self.sigma_total_field(scale, dim) / math.sqrt(
            self.expected_participants
        )

    def field_need(self, scale: int, dim: int,
                   per_coordinate_bound: float | None = None) -> float:
        """Per-coordinate magnitude the field must hold without wrapping:
        the data sum plus the NOISE_TAIL_SIGMAS aggregate-noise margin.
        ``per_coordinate_bound`` defaults to ``l2_clip``; a channel with a
        tighter known bound (the weighted channel's ``clip·max_weight``)
        passes it."""
        bound = self.l2_clip if per_coordinate_bound is None else per_coordinate_bound
        return (
            self.expected_participants * scale * bound
            + NOISE_TAIL_SIGMAS * self.sigma_total_field(scale, dim)
        )

    def account(self, scale: int, dim: int, n_actual: int | None = None) -> PrivacyAccount:
        """Guarantee realized with ``n_actual`` submitters (dropout shrinks
        the realized σ_total: the noise variance is n_actual·σ_party²)."""
        if self.mechanism != "dgauss":
            raise NotImplementedError(
                "formal accounting is implemented for the discrete-Gaussian "
                "mechanism only (Skellam RDP: Agarwal et al. 2021)"
            )
        n = self.expected_participants if n_actual is None else n_actual
        if n < 1:
            raise ValueError("need at least one submitter")
        sens = self.sensitivity_field(scale, dim)
        sigma = self.sigma_party_field(scale, dim) * math.sqrt(n)
        rho = zcdp_rho(sens, sigma)
        return PrivacyAccount(
            epsilon=eps_from_zcdp(rho, self.delta),
            delta=self.delta,
            rho=rho,
            sigma_total=sigma,
            l2_sensitivity=sens,
            n_parties=n,
        )

    def party_noise(self, scale: int, dim: int, generator=None, device=None) -> torch.Tensor:
        """One participant's ``(dim,)`` int64 noise draw (field units) on the
        generator's device (a fresh generator on ``device`` when None)."""
        generator = fresh_generator(device) if generator is None else generator
        sigma = self.sigma_party_field(scale, dim)
        if sigma < self.min_party_sigma:
            raise ValueError(
                f"per-party sigma {sigma:.3f} < min_party_sigma "
                f"{self.min_party_sigma}: the distributed-noise "
                "approximation needs ~1 field unit of noise per party — "
                "raise noise_multiplier or frac_bits, or lower "
                "expected_participants"
            )
        if self.mechanism == "dgauss":
            return sample_discrete_gaussian(sigma, dim, generator)
        return sample_skellam(sigma * sigma, dim, generator)


def l2_clip_vector(flat, clip: float, device=None) -> torch.Tensor:
    """Scale ``flat`` down to L2 norm ≤ clip (no-op when already inside).
    The norm sums in torch's order, not numpy's, so it can differ from the
    reference's in the last bit."""
    flat = _as_tensor(flat, torch.float64, device)
    norm = float(torch.linalg.vector_norm(flat))
    if norm > clip:
        flat = flat * (clip / norm)
    return flat


# ---------------------------------------------------------------------------
# The DP FedAvg drivers
# ---------------------------------------------------------------------------


class _DPRoundMixin:
    """Shared DP plumbing for drivers over a (possibly widened) field
    vector: the per-party sigma and noise-headroom guards, the revealed
    cohort, and realized-privacy accounting. Hosts set ``self.spec`` and
    ``self.dp`` before calling ``_check_dp_feasible``."""

    def _check_dp_feasible(self, per_coordinate_bound: float | None = None,
                           builder: str = ".fitted_spec") -> None:
        sigma = self.dp.sigma_party_field(self.spec.scale, self.wire_dimension)
        if sigma < self.dp.min_party_sigma:
            raise ValueError(
                f"per-party sigma {sigma:.3f} < min_party_sigma "
                f"{self.dp.min_party_sigma}; raise noise_multiplier or "
                "frac_bits"
            )
        # a data-only field holds the data sum but wraps under the noise
        need = self.dp.field_need(
            self.spec.scale, self.wire_dimension, per_coordinate_bound
        )
        if not need < (self.spec.modulus - 1) // 2:
            raise ValueError(
                f"field {self.spec.modulus} lacks noise headroom: data + "
                f"{NOISE_TAIL_SIGMAS:g}sigma needs > {int(2 * need) + 1}; "
                f"build the spec with {builder}"
            )

    def _noise(self, generator) -> torch.Tensor:
        return self.dp.party_noise(
            self.spec.scale, self.wire_dimension,
            self._generator if generator is None else generator,
        )

    def check_field_sum(self, field_sum, n_submitted: int) -> torch.Tensor:
        out = super().check_field_sum(field_sum, n_submitted)
        # the realized cohort, for every revealed sum (``reveal_field_sum``
        # ends here): privacy() reports the guarantee the revealed
        # aggregate has (dropout shrinks the total noise)
        self._revealed_n = n_submitted
        return out

    def privacy(self, n_actual: int | None = None) -> PrivacyAccount:
        """Realized guarantee: the last reveal's submitter count when there
        was one, else the configured ``expected_participants``."""
        if n_actual is None:
            n_actual = getattr(self, "_revealed_n", None)
        return self.dp.account(self.spec.scale, self.wire_dimension, n_actual)


class DPFederatedAveraging(_DPRoundMixin, FederatedAveraging):
    """FedAvg with distributed-DP noise on every update: participants
    L2-clip to ``dp.l2_clip`` (scaling down, not rejecting), quantize, and
    add per-party integer noise in field space. ``fitted_spec`` builds a
    field with noise headroom. ``generator`` (a ``torch.Generator`` on
    ``device``) draws the noise; by default one seeded from the OS."""

    def __init__(self, spec: QuantizationSpec, template_tree, dp: DPConfig,
                 generator=None, *, per_coordinate_bound: float | None = None,
                 device=None):
        super().__init__(spec, template_tree, device)
        self.dp = dp
        self._generator = fresh_generator(self.device) if generator is None else generator
        self._check_dp_feasible(
            per_coordinate_bound, builder="DPFederatedAveraging.fitted_spec"
        )

    @classmethod
    def fitted_spec(cls, frac_bits: int, dp: DPConfig, dim: int,
                    per_coordinate_bound: float | None = None, **shamir_kw):
        """(spec, sharing) sized for the data sum + NOISE_TAIL_SIGMAS·σ_total:
        ``QuantizationSpec.fitted`` with the per-coordinate bound inflated
        so n·2^f·clip_eff equals ``DPConfig.field_need``."""
        scale = 1 << frac_bits
        n = dp.expected_participants
        clip_eff = dp.field_need(scale, dim, per_coordinate_bound) / (n * scale)
        return QuantizationSpec.fitted(frac_bits, clip_eff, n, **shamir_kw)

    def wire(self, update_tree, *, generator=None) -> torch.Tensor:
        """The clipped, quantized update plus this party's noise, reduced
        to the canonical [0, p)."""
        flat = l2_clip_vector(self._validated_flat(update_tree), self.dp.l2_clip)
        return torch.remainder(self.spec.quantize(flat) + self._noise(generator),
                               self.spec.modulus)

    def submit_update(self, participant, aggregation_id, update_tree, *, generator=None) -> None:
        """Participant: ``wire`` (noise from ``generator``, or from this
        object's own when None) through full participation."""
        wire = self.wire(update_tree, generator=generator).cpu().numpy()
        participant.participate(wire, aggregation_id)


class DPWeightedFederatedAveraging(_DPRoundMixin, WeightedFederatedAveraging):
    """Weighted FedAvg under distributed DP: the noise covers updates and
    weights. The wire ``(w·x, w)`` with ``|x_i| ≤ clip`` and
    ``w ≤ max_weight`` has L2 bound ``max_weight·sqrt(clip²·d + 1)``, the
    DP clip, so in-bounds submissions are never rescaled."""

    def __init__(self, spec: QuantizationSpec, template_tree, clip: float,
                 max_weight: float, dp: DPConfig, generator=None, device=None):
        super().__init__(spec, template_tree, clip, max_weight, device)
        self.dp = dp
        self._generator = fresh_generator(self.device) if generator is None else generator
        # the per-coordinate bound is max(clip*max_weight, max_weight), not
        # the channel's L2 (which would demand a ~sqrt(d)-too-large field)
        self._check_dp_feasible(
            per_coordinate_bound=max(self.clip * self.max_weight,
                                     self.max_weight),
            builder=".fitted_dp",
        )

    @classmethod
    def fitted_dp(cls, frac_bits: int, clip: float, max_weight: float,
                  n_participants: int, template_tree, *,
                  noise_multiplier: float, delta: float = 1e-6,
                  mechanism: str = "dgauss", generator=None, device=None,
                  **shamir_kw):
        """(driver, sharing) with the channel's tight DP clip and a field
        holding data + noise tail."""
        _, _, dim = tree_layout(template_tree)
        l2 = max_weight * math.sqrt(clip * clip * dim + 1.0)
        dp = DPConfig(
            l2_clip=l2, noise_multiplier=noise_multiplier,
            expected_participants=n_participants, delta=delta,
            mechanism=mechanism,
        )
        bound = max(clip * max_weight, max_weight)
        spec, sharing = DPFederatedAveraging.fitted_spec(
            frac_bits, dp, dim + 1, per_coordinate_bound=bound, **shamir_kw
        )
        return cls(spec, template_tree, clip, max_weight, dp, generator, device), sharing

    def wire(self, update_tree, weight: float, *, generator=None) -> torch.Tensor:
        q = super().wire(update_tree, weight)
        return torch.remainder(q + self._noise(generator), self.spec.modulus)

    def submit_update(self, participant, aggregation_id, update_tree, weight: float, *,
                      generator=None) -> None:
        wire = self.wire(update_tree, weight, generator=generator).cpu().numpy()
        participant.participate(wire, aggregation_id)

    def _weighted_flat(self, sums: torch.Tensor, total_weight: float) -> torch.Tensor:
        """A noisy total can dip to 0 or below for small cohorts, and by
        then the privacy budget is spent: NaN means and the noisy total let
        the caller judge, where the noise-free base raises."""
        if total_weight > 0:
            return super()._weighted_flat(sums, total_weight)
        return torch.full((self.dim,), float("nan"), dtype=torch.float64, device=sums.device)


# ---------------------------------------------------------------------------
# The statistics drivers under distributed DP
# ---------------------------------------------------------------------------


class DPSecureStatistics(SecureStatistics):
    """Cohort mean and variance under distributed DP: ``SecureStatistics``
    (``[x, x²]`` per coordinate) over a ``DPFederatedAveraging`` round. For
    per-coordinate ``|x| ≤ c`` the channel's L2 bound
    ``sqrt(d·(c² + c⁴))`` is the DP clip, so in-bounds submissions are
    never scaled. Both revealed sums carry noise of std σ_total/2^f per
    coordinate; the variance inherits it (clamped at 0)."""

    def __init__(self, dim: int, clip: float, n_participants: int, *,
                 noise_multiplier: float, delta: float = 1e-6, frac_bits: int = 16,
                 mechanism: str = "dgauss", generator=None, device=None):
        if clip <= 0:
            raise ValueError("clip must be positive")
        self.dim = dim
        self.clip = float(clip)
        l2 = math.sqrt(dim * (clip * clip + clip ** 4))
        self.dp = DPConfig(
            l2_clip=l2, noise_multiplier=noise_multiplier,
            expected_participants=n_participants, delta=delta, mechanism=mechanism,
        )
        self.spec, self.sharing = DPFederatedAveraging.fitted_spec(frac_bits, self.dp, 2 * dim)
        template = {"sum": np.zeros(dim), "sumsq": np.zeros(dim)}
        self.fed = DPFederatedAveraging(self.spec, template, self.dp, generator, device=device)

    def submit(self, participant, aggregation_id, values, *, generator=None) -> None:
        self.fed.submit_update(participant, aggregation_id, self._checked_tree(values),
                               generator=generator)

    def privacy(self, n_actual: int | None = None) -> PrivacyAccount:
        return self.fed.privacy(n_actual)


class DPSecureGroupedMean(SecureGroupedMean):
    """Per-category cohort means under distributed DP. One participant's
    scatter of at most ``m = max_values`` observations of
    ``|coordinate| ≤ c`` has L2 bound ``m·sqrt(c²·d + 1)`` (all in one
    category is the worst case). Noisy counts come back as floats (they may
    dip negative); means divide by them only where the noisy count is ≥ 1."""

    def __init__(self, groups: int, dim: int, clip: float, n_participants: int, *,
                 noise_multiplier: float, delta: float = 1e-6, frac_bits: int = 16,
                 max_values_per_participant: int = 1 << 10, mechanism: str = "dgauss",
                 generator=None, device=None):
        if groups < 1 or dim < 1:
            raise ValueError("groups and dim must be >= 1")
        if clip <= 0:
            raise ValueError("clip must be positive")
        self.groups = groups
        self.dim = dim
        self.clip = float(clip)
        self.max_values = max_values_per_participant
        m = max_values_per_participant
        l2 = m * math.sqrt(clip * clip * dim + 1.0)
        wire = groups * dim + groups
        self.dp = DPConfig(
            l2_clip=l2, noise_multiplier=noise_multiplier,
            expected_participants=n_participants, delta=delta, mechanism=mechanism,
        )
        bound = max(clip, 1.0) * m  # the true per-coordinate bound
        self.spec, self.sharing = DPFederatedAveraging.fitted_spec(
            frac_bits, self.dp, wire, per_coordinate_bound=bound
        )
        template = {"sums": np.zeros((groups, dim)), "counts": np.zeros(groups)}
        self.fed = DPFederatedAveraging(self.spec, template, self.dp, generator,
                                        per_coordinate_bound=bound, device=device)

    def submit(self, participant, aggregation_id, observations, *, generator=None) -> None:
        self.fed.submit_update(participant, aggregation_id, self.local_scatter(observations),
                               generator=generator)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """-> {"counts": (groups,) float64 noisy counts, "means": (groups,
        dim) float64, NaN where the noisy count is < 1}."""
        tree = self._revealed_tree(recipient, aggregation_id, n_submitted)
        counts = tree["counts"]
        means = torch.full((self.groups, self.dim), float("nan"), dtype=torch.float64,
                           device=counts.device)
        usable = counts >= 1.0
        means[usable] = tree["sums"][usable] / counts[usable].unsqueeze(1)
        return {"counts": counts, "means": means}

    def privacy(self, n_actual: int | None = None) -> PrivacyAccount:
        return self.fed.privacy(n_actual)


class DPSecureCovariance(SecureCovariance):
    """Cohort covariance and correlation under distributed DP. For
    per-coordinate ``|x| ≤ c`` the channel ``[x, vech(x xᵀ)]`` has L2
    bound ``sqrt(d·c² + d(d+1)/2·c⁴)``, tight at x = (c, …, c): the DP
    clip. The noisy covariance is symmetric but only approximately PSD;
    its diagonal still clamps at 0."""

    def __init__(self, dim: int, clip: float, n_participants: int, *,
                 noise_multiplier: float, delta: float = 1e-6, frac_bits: int = 16,
                 mechanism: str = "dgauss", generator=None, device=None):
        if dim < 1:
            raise ValueError("dim must be >= 1")
        if clip <= 0:
            raise ValueError("clip must be positive")
        self.dim = dim
        self.clip = float(clip)
        wire = dim + dim * (dim + 1) // 2
        l2 = math.sqrt(dim * clip * clip + dim * (dim + 1) / 2.0 * clip ** 4)
        self.dp = DPConfig(
            l2_clip=l2, noise_multiplier=noise_multiplier,
            expected_participants=n_participants, delta=delta, mechanism=mechanism,
        )
        self.spec, self.sharing = DPFederatedAveraging.fitted_spec(frac_bits, self.dp, wire)
        template = {"sum": np.zeros(dim), "outer": np.zeros(dim * (dim + 1) // 2)}
        self.fed = DPFederatedAveraging(self.spec, template, self.dp, generator, device=device)
        self._triu = tuple(torch.triu_indices(dim, dim, device=self.fed.device))

    def submit(self, participant, aggregation_id, values, *, generator=None) -> None:
        self.fed.submit_update(participant, aggregation_id, self._checked_tree(values),
                               generator=generator)

    def privacy(self, n_actual: int | None = None) -> PrivacyAccount:
        return self.fed.privacy(n_actual)


class DPSecureHistogram(SecureHistogram):
    """Cohort histogram with distributed-DP noise on the counts. One
    participant's counts have L2 ≤ ``max_values`` (all in one bin), the DP
    clip. Counts are scaled by ``2^frac_bits`` in the field, so a party's
    noise of ≥ 1 field unit costs only ``2^-frac_bits`` of a count; the
    noise is added in integer field space after quantization. ``finish``
    center-lifts and rescales: noisy counts are floats and may dip
    negative."""

    def __init__(self, bins: int, lo: float, hi: float, n_participants: int, *,
                 noise_multiplier: float, delta: float = 1e-6,
                 max_values_per_participant: int = 1, mechanism: str = "dgauss",
                 frac_bits: int = 16, generator=None, device=None):
        self._init_geometry(bins, lo, hi, max_values_per_participant)
        self.dp = DPConfig(
            l2_clip=float(max_values_per_participant), noise_multiplier=noise_multiplier,
            expected_participants=n_participants, delta=delta, mechanism=mechanism,
        )
        self.spec, self.sharing = DPFederatedAveraging.fitted_spec(frac_bits, self.dp, bins)
        self.fed = DPFederatedAveraging(self.spec, {"counts": np.zeros(bins)}, self.dp,
                                        generator, device=device)

    def submit(self, participant, aggregation_id, values, *, generator=None) -> None:
        self.fed.submit_update(participant, aggregation_id, {"counts": self.local_counts(values)},
                               generator=generator)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> torch.Tensor:
        """-> (bins,) float64 noisy counts (noise std σ_total/2^f a bin)."""
        raw = self.fed.reveal_field_sum(recipient, aggregation_id, n_submitted)
        return self.spec.dequantize_sum(raw)

    def privacy(self, n_actual: int | None = None) -> PrivacyAccount:
        return self.fed.privacy(n_actual)
