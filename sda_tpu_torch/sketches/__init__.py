"""Federated-analytics workloads as linear sketches over secure sums
(counterpart of ``sda_tpu/sketches``).

Every sketch here is linear, so the secure sum of the participants'
sketches is the cohort's sketch. ``SketchQuery`` runs any of them as one
secure round (``frac_bits=0``: exact integer sums), and each family decodes
the summed sketch with an explicit analytic error bound:

- ``CountMinSketch``: point queries and heavy hitters, ``+ε·N`` one-sided;
- ``CountSketch``: unbiased point queries, ``3·sqrt(F2/width)`` two-sided;
- ``DyadicQuantiles``: rank and quantile queries, ``U·ε·N`` rank error;
- ``LinearCountingSketch``: cohort cardinality, ``3σ`` linear counting;
- ``TopKSketch``: categorical top-k through count-min heavy hitters.
"""

from .base import LinearSketch, SketchQuery, sketch_hash
from .cardinality import LinearCountingSketch
from .countmin import CountMinSketch
from .countsketch import CountSketch
from .quantiles import DyadicQuantiles
from .topk import TopKSketch

SKETCH_KINDS = {
    "countmin": CountMinSketch,
    "countsketch": CountSketch,
    "quantiles": DyadicQuantiles,
    "cardinality": LinearCountingSketch,
    "topk": TopKSketch,
}

__all__ = [
    "CountMinSketch",
    "CountSketch",
    "DyadicQuantiles",
    "LinearCountingSketch",
    "LinearSketch",
    "SKETCH_KINDS",
    "SketchQuery",
    "TopKSketch",
    "sketch_hash",
]
