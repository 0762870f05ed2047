from .engine import AggregationPlan, TorchAggregator, make_plan

__all__ = ["AggregationPlan", "TorchAggregator", "make_plan"]
