"""Secure federated model evaluation: cohort metrics over private data
(counterpart of ``sda_tpu/models/evaluation.py``).

Per-participant metrics leak (a hospital's local accuracy says how well the
model fits its patients), so evaluation is a weighted secure sum: each
participant submits ``(n_k·m_k, n_k)``, its local example count times its
local metric means, plus the count, and the revealed sums give the
example-weighted cohort metrics ``Σ n_k·m_k / Σ n_k``. It rides
``WeightedFederatedAveraging``: the metrics vector is the update, the
example count the weight. Metrics come back as 0-d float64 tensors on the
evaluation's device (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np

from .federated import WeightedFederatedAveraging


def _checked_metric_layout(metric_names):
    """Validate the metric-name layout; returns (names, template)."""
    names = list(metric_names)
    if not names:
        raise ValueError("need at least one metric")
    if "examples" in names:
        raise ValueError('"examples" is reserved for the total count')
    if len(set(names)) != len(names):
        raise ValueError("duplicate metric names")
    return names, {"metrics": np.zeros(len(names))}


class SecureEvaluation:
    """One evaluation round: example-weighted cohort means of ``metrics``.

    ``metric_names`` fixes the vector layout (``"examples"`` is reserved
    for the revealed total count); ``bound`` is the largest |metric|
    accepted (out-of-bound submissions are refused, not clipped);
    ``max_examples`` bounds one participant's example count.
    """

    def __init__(self, metric_names, n_participants: int, *, bound: float = 100.0,
                 max_examples: int = 1 << 20, frac_bits: int = 16, device=None):
        self.metric_names, template = _checked_metric_layout(metric_names)
        self.fed, self.sharing = WeightedFederatedAveraging.fitted(
            frac_bits, float(bound), float(max_examples), n_participants, template,
            device=device,
        )

    def open_round(self, recipient, recipient_key):
        return self.fed.open_round(recipient, recipient_key, self.sharing, title="secure-evaluation")

    def submit(self, participant, aggregation_id, metrics: dict, n_examples: int) -> None:
        """``metrics``: {name: local mean over this participant's
        ``n_examples`` examples}, every configured name required."""
        missing = [m for m in self.metric_names if m not in metrics]
        if missing:
            raise ValueError(f"missing metrics: {missing}")
        if n_examples < 1:
            raise ValueError("n_examples must be >= 1")
        vec = np.array([float(metrics[m]) for m in self.metric_names])
        self.fed.submit_update(participant, aggregation_id, {"metrics": vec},
                               weight=float(n_examples))

    def close_round(self, recipient, aggregation_id) -> None:
        self.fed.close_round(recipient, aggregation_id)

    def finish(self, recipient, aggregation_id, n_submitted: int) -> dict:
        """-> {name: example-weighted cohort mean} plus ``"examples"``, the
        cohort's total example count."""
        mean, total = self.fed.finish_round(recipient, aggregation_id, n_submitted)
        out = dict(zip(self.metric_names, mean["metrics"]))
        out["examples"] = self._format_examples(total)
        return out

    @staticmethod
    def _format_examples(total: float):
        """The noise-free total is an exact integer count; the DP subclass
        keeps the noisy float."""
        return int(round(total))


class DPSecureEvaluation(SecureEvaluation):
    """Model evaluation under distributed DP: the cohort metrics and the
    total example count carry noise no party can strip (an exact total
    leaks a joining site's dataset size). The weighted channel runs over
    ``DPWeightedFederatedAveraging``; ``generator`` draws the noise."""

    def __init__(self, metric_names, n_participants: int, *, noise_multiplier: float,
                 delta: float = 1e-6, bound: float = 100.0, max_examples: int = 1 << 20,
                 frac_bits: int = 16, mechanism: str = "dgauss", generator=None, device=None):
        from .dp import DPWeightedFederatedAveraging

        self.metric_names, template = _checked_metric_layout(metric_names)
        self.fed, self.sharing = DPWeightedFederatedAveraging.fitted_dp(
            frac_bits, float(bound), float(max_examples), n_participants, template,
            noise_multiplier=noise_multiplier, delta=delta, mechanism=mechanism,
            generator=generator, device=device,
        )

    @staticmethod
    def _format_examples(total: float):
        """The noisy float: for a tiny cohort it can come back <= 0 (the
        metrics are NaN then); the caller judges."""
        return float(total)

    def privacy(self, n_actual: int | None = None):
        return self.fed.privacy(n_actual)
