from .engine import AggregationPlan, TorchAggregator, full_training_step, make_plan
from .mesh import make_mesh, shard_participants
from .sumfirst import clerk_sums_sum_first, sharded_value_limb_sums

__all__ = [
    "AggregationPlan",
    "TorchAggregator",
    "clerk_sums_sum_first",
    "full_training_step",
    "make_mesh",
    "make_plan",
    "shard_participants",
    "sharded_value_limb_sums",
]
