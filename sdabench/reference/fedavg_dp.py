"""Plain reference of a DP-FedAvg round under secure aggregation with
distributed discrete Gaussian noise (Kairouz, Liu and Steinke, ICML 2021):
what a round must reveal, whatever noise, masks and shares it drew.

Each party's update row is clipped to L2 norm ``l2_clip`` (the norm as the
square root of the sum of squares in float64; a row inside the clip is kept
as it is, the others are scaled by ``l2_clip / norm``), scaled by
``2^frac_bits`` and rounded half to even, a negative value standing as its
residue mod p. No coordinate of a clipped row exceeds ``l2_clip``, so the
field's per-coordinate clamp never bites. Each party adds its own discrete
Gaussian noise of ``sigma_party`` field units; the revealed field sum is the
data sum plus the 100 parties' noise, mod p. A round's data depends only on
its cohort, so ``data_sum`` is computed once a pool cohort; the noise is
what remains of a revealed sum once it is taken away (``centered``), and
its law is held to the mechanism's by ``noise_checks``:

- ``*_var_ratio_err``: |mean square / σ² − 1|, about the mechanism's mean
  0. The discrete Gaussian's variance is σ² to within e^(-2π²σ²) at these
  σ.
- ``noise_mean_sigmas``: the largest of the aggregate's and the party's
  mean, each in standard errors (σ / √N) from 0.
- ``party_excess_kurtosis``: |m4 / m2² − 3|; 0 for a Gaussian, 3 for the
  Laplace proposal unfiltered.
- ``party_noise_corr``: |correlation| of two parties' noise in one chunk.
- ``round_noise_corr``: the largest |correlation| between the aggregate
  noise of two kept rounds; noise drawn afresh each round reads about
  1/√dim a pair, noise that repeats from round to round reads 1.

Masks and share randomness cancel in the sums: ``mask`` (plain ChaCha20) and
``sharing_checks`` (``shamir.py``) see them apart, as in ``fedavg.py``.
``dgauss_pmf`` is the law itself, for the tests. Plain torch and numpy in
float64, in blocks of rows; nothing of the port is imported, and TF32 is
off.

``Float32DPRound`` is the control: this reference put in the program's
place with the clip and quantization in float32, the precision below the
configuration's, and a rounded continuous Gaussian for the noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sdabench.reference import chacha20, fedavg, shamir

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BLOCK_ROWS = 25

mask = chacha20.mask
sharing_checks = shamir.checks
mean_update = fedavg.mean_update

#: each noise number's limit (PERF.md §2 gives the readings): the larger of
#: the first, set for the cell's samples (130M aggregate values, 32M party
#: values, 16M pairs), and the second times the number's standard error at
#: the run's own sample size, which a smaller sample (the CPU tests) needs;
#: ``round_noise_corr`` takes 10 standard errors of one pair's, 1/√dim
NOISE_LIMITS = {"noise_var_ratio_err": (0.005, 20), "party_var_ratio_err": (0.005, 20),
                "noise_mean_sigmas": (6.0, 0), "party_excess_kurtosis": (0.01, 10), "party_noise_corr": (0.003, 10),
                "round_noise_corr": (0.0, 10)}


def sigma_party(config: dict) -> float:
    """σ_party in field units: z·(C·2^f + √d/2)/√n, the L2 sensitivity of
    a clipped, quantized update (its rounding adds at most √d/2) times the
    noise multiplier, split over the expected parties."""
    d, q = config["dp"], config["quantization"]
    sensitivity = d["l2_clip"] * (1 << q["frac_bits"]) + 0.5 * math.sqrt(config["parameters"])
    return d["noise_multiplier"] * sensitivity / math.sqrt(d["expected_participants"])


def clip_rows(updates: torch.Tensor, l2_clip: float) -> torch.Tensor:
    """``(B, dim)`` float rows -> float64 rows of L2 norm at most the clip."""
    x = updates.to(torch.float64)
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    scale = torch.where(norm > l2_clip, l2_clip / norm, torch.ones_like(norm))
    return x * scale


def quantize_rows(updates: torch.Tensor, l2_clip: float, frac_bits: int, p: int) -> torch.Tensor:
    """``(B, dim)`` float rows -> their clipped, quantized ``(B, dim)`` int64
    residues in [0, p)."""
    q = torch.round(clip_rows(updates, l2_clip) * float(1 << frac_bits)).to(torch.int64)
    return torch.remainder(q, p)


def data_sum(updates: torch.Tensor, l2_clip: float, frac_bits: int, p: int) -> torch.Tensor:
    """``(P, dim)`` float updates -> the ``(dim,)`` int64 sum of their
    clipped, quantized residues mod p (exact in int64 for p < 2^31)."""
    if p >= 1 << 31 or updates.shape[0] >= 1 << 32:
        raise ValueError("the int64 residue sum is exact for p < 2^31 and fewer than 2^32 rows")
    total = torch.zeros(updates.shape[1], dtype=torch.int64, device=updates.device)
    for start in range(0, updates.shape[0], BLOCK_ROWS):
        total += torch.sum(quantize_rows(updates[start: start + BLOCK_ROWS], l2_clip, frac_bits, p), dim=0)
    return torch.remainder(total, p)


def centered(residues: torch.Tensor, p: int) -> torch.Tensor:
    """Residues mod p -> the integers in (-p/2, p/2] they stand for."""
    r = torch.remainder(residues, p)
    return torch.where(r > p // 2, r - p, r)


def dgauss_pmf(sigma: float, xs) -> np.ndarray:
    """P(x) of N_Z(0, σ²) at the integers ``xs``, normalised over ±(40σ + 40)."""
    support = np.arange(-int(40 * sigma) - 40, int(40 * sigma) + 41, dtype=np.float64)
    weights = np.exp(-(support ** 2) / (2 * sigma * sigma))
    xs = np.asarray(xs, dtype=np.float64)
    return np.exp(-(xs ** 2) / (2 * sigma * sigma)) / weights.sum()


class Moments:
    """Count and power sums about 0 (the mechanism's mean) of integer
    samples, added a block at a time, in float64."""

    def __init__(self):
        self.n, self.s1, self.s2, self.s4 = 0, 0.0, 0.0, 0.0

    def add(self, values: torch.Tensor) -> None:
        v = values.reshape(-1).to(torch.float64)
        v2 = v * v
        self.n += v.numel()
        self.s1 += float(torch.sum(v))
        self.s2 += float(torch.sum(v2))
        self.s4 += float(torch.sum(v2 * v2))

    def stats(self) -> tuple:
        """-> (mean, second moment, excess kurtosis), about 0; the kurtosis
        is ``None`` for samples that are all 0."""
        m2 = self.s2 / self.n
        return self.s1 / self.n, m2, self.s4 / self.n / (m2 * m2) - 3.0 if m2 else None


def correlation(a: torch.Tensor, b: torch.Tensor):
    """Pearson's correlation; ``None`` where either sample is constant."""
    a, b = a.reshape(-1).to(torch.float64), b.reshape(-1).to(torch.float64)
    a, b = a - a.mean(), b - b.mean()
    norms = float(torch.sum(a * a) * torch.sum(b * b))
    return float(torch.sum(a * b)) / math.sqrt(norms) if norms else None


def round_correlation(noise: torch.Tensor):
    """The largest |correlation| between two rows of ``(k, dim)`` samples;
    ``None`` for fewer than two rows or a constant one."""
    if noise.shape[0] < 2:
        return None
    x = noise.to(torch.float64, copy=True)
    x -= x.mean(dim=1, keepdim=True)
    norms = torch.linalg.vector_norm(x, dim=1, keepdim=True)
    if not bool(torch.all(norms > 0)):
        return None
    x /= norms
    gram = x @ x.T
    gram.fill_diagonal_(0.0)
    return float(torch.max(torch.abs(gram)))


def noise_checks(aggregate: Moments, party: Moments, pairs: list, rounds: torch.Tensor, sigma: float,
                 parties: int) -> dict:
    """The noise's numbers, each beside its limit: ``aggregate`` holds the
    kept rounds' revealed sums less their data sums, ``rounds`` the same
    ``(k, dim)`` noise a row a round, ``party`` the probed rows' wires less
    their noise-free rows, ``pairs`` the two probed rows' noise of each
    probed round. Where a run kept none of either, its numbers are
    ``None``, which fails."""
    if not (aggregate.n and party.n and pairs):
        return {name: (None, floor) for name, (floor, _) in NOISE_LIMITS.items()}
    a_mean, a_var, _ = aggregate.stats()
    p_mean, p_var, p_kurt = party.stats()
    a, b = torch.cat([a for a, _ in pairs]), torch.cat([b for _, b in pairs])
    values = {"noise_var_ratio_err": abs(a_var / (parties * sigma * sigma) - 1.0),
              "party_var_ratio_err": abs(p_var / (sigma * sigma) - 1.0),
              "noise_mean_sigmas": max(abs(a_mean) / (math.sqrt(parties) * sigma / math.sqrt(aggregate.n)),
                                       abs(p_mean) / (sigma / math.sqrt(party.n))),
              "party_excess_kurtosis": None if p_kurt is None else abs(p_kurt),
              "party_noise_corr": None if (corr := correlation(a, b)) is None else abs(corr),
              "round_noise_corr": round_correlation(rounds)}
    errors = {"noise_var_ratio_err": math.sqrt(2.0 / aggregate.n), "party_var_ratio_err": math.sqrt(2.0 / party.n),
              "noise_mean_sigmas": 0.0, "party_excess_kurtosis": math.sqrt(24.0 / party.n),
              "party_noise_corr": 1.0 / math.sqrt(a.numel()), "round_noise_corr": 1.0 / math.sqrt(rounds.shape[1])}
    return {name: (values[name], max(floor, k * errors[name])) for name, (floor, k) in NOISE_LIMITS.items()}


class Float32DPRound:
    """The control: a round computed by the reference with the clip and the
    quantization in float32 and the noise a rounded continuous Gaussian of
    σ_party (as wide as the discrete one to 1e-9 at these σ); the sum exact
    in int64 and the model in float64."""

    def __init__(self, config: dict, device):
        self.l2_clip = config["dp"]["l2_clip"]
        self.frac_bits = config["quantization"]["frac_bits"]
        self.p = config["scheme"]["prime_modulus"]
        self.sigma = sigma_party(config)
        self.generator = torch.Generator(device=device).manual_seed(0)
        layers = config["model"]["layers"]
        self.leaves, offset = [], 0
        for layer in sorted(layers):  # the flat layout: leaves in sorted key order
            for name in sorted(layers[layer]):
                shape = tuple(layers[layer][name])
                self.leaves.append((layer, name, shape, offset))
                offset += math.prod(shape)

    def _quantized(self, rows: torch.Tensor) -> torch.Tensor:
        x = rows.to(torch.float32)
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
        x = x * torch.where(norm > self.l2_clip, self.l2_clip / norm, torch.ones_like(norm))
        return torch.remainder(torch.round(x * float(1 << self.frac_bits)).to(torch.int64), self.p)

    def round(self, cohort, seeds, global_model, chunk, watch=()):
        total = torch.zeros(cohort.shape[1], dtype=torch.int64, device=cohort.device)
        probes = {}
        for start in range(0, cohort.shape[0], chunk):
            q = self._quantized(cohort[start: start + chunk])
            noise = torch.round(self.sigma * torch.randn(q.shape, generator=self.generator, dtype=torch.float64,
                                                         device=q.device)).to(torch.int64)
            wire = torch.remainder(q + noise, self.p)
            total += torch.sum(wire, dim=0)
            for row in watch:
                if start <= row < start + chunk:
                    probes[row] = (q[row - start], wire[row - start])
        field_sum = torch.remainder(total, self.p)
        mean = mean_update(field_sum, cohort.shape[0], self.frac_bits, self.p)
        new_global = {}
        for layer, name, shape, offset in self.leaves:
            g = global_model[layer][name].to(torch.float64)
            new_global.setdefault(layer, {})[name] = g + mean[offset: offset + g.numel()].view(shape)
        return {"field_sum": field_sum, "new_global": new_global, "probes": probes}


def control(config: dict, device) -> Float32DPRound:
    return Float32DPRound(config, device)
