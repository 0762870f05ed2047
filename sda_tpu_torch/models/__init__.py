from .federated import (
    QuantizationSpec,
    TreeDef,
    dequantize_mean,
    flatten_pytree,
    quantize_update,
    tree_flatten,
    tree_layout,
    tree_unflatten,
    unflatten_pytree,
)
from .trainer import fedavg_apply

__all__ = [
    "QuantizationSpec",
    "TreeDef",
    "dequantize_mean",
    "fedavg_apply",
    "flatten_pytree",
    "quantize_update",
    "tree_flatten",
    "tree_layout",
    "tree_unflatten",
    "unflatten_pytree",
]
