"""FedAvg's apply step (counterpart of ``FederatedTrainer._fedavg_apply`` in
``sda_tpu/models/trainer.py``). The trainer's round loop and checkpoints
drive the protocol plane's client roles and stay in ``sda_tpu``."""

from __future__ import annotations

import torch

from ..device import resolve_device
from .federated import _as_tensor, tree_flatten, tree_unflatten


def fedavg_apply(global_model, mean_update, device=None):
    """``global (as float64) + update``, leaf by leaf, on ``device`` (CUDA
    unless the caller asks for the CPU). Both trees must have one
    structure."""
    device = resolve_device(device)
    g_leaves, treedef = tree_flatten(global_model)
    u_leaves, u_def = tree_flatten(mean_update)
    if u_def != treedef:
        raise ValueError(f"update structure {u_def} differs from the model's {treedef}")
    return tree_unflatten(treedef, [
        _as_tensor(g, torch.float64, device) + torch.as_tensor(u, device=device)
        for g, u in zip(g_leaves, u_leaves)
    ])
