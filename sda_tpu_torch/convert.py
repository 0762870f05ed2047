"""Carry the engine's state across from the JAX package.

The system has no model weights: its state is the plan (the scheme's
integers, the ``(n, k+t)`` share matrix and the ``(L, L*K, n)`` int8 folded
limb stacks) and the ``(W, nb, n)`` limb accumulators of a streamed round.
Both come in as Python ints and numpy arrays, so this module needs nothing
of the JAX package; the caller reads them off ``sda_tpu``'s objects.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .parallel.engine import AggregationPlan
from .parallel.limbmatmul import fold_const_limbs

_INT_FIELDS = ("modulus", "dim", "input_size", "rand_size", "share_count", "n_batches")


def plan_from_reference(fields: dict, device=None) -> AggregationPlan:
    """The port's plan from a reference plan's fields.

    ``fields`` holds the ints of ``_INT_FIELDS`` and ``share_matrix``
    (numpy ``(n, k+t)`` or ``None`` for additive); ``limb_stacks`` is
    optional and folded from the share matrix when absent. ``device``
    defaults to CUDA (raises without a GPU).
    """
    device = resolve_device(device)
    ints = {name: int(fields[name]) for name in _INT_FIELDS}
    S = fields.get("share_matrix")
    share_matrix = stacks = None
    if S is not None:
        S = np.asarray(S, dtype=np.int64)
        stacks = fields.get("limb_stacks")
        if stacks is None:
            stacks = fold_const_limbs(S.T, ints["modulus"])
        share_matrix = torch.as_tensor(S, device=device)
        stacks = torch.as_tensor(np.asarray(stacks, dtype=np.int8), device=device)
        n, K = S.shape
        if (n, K) != (ints["share_count"], ints["input_size"] + ints["rand_size"]):
            raise ValueError(f"share matrix shape {S.shape} does not match the plan")
        if stacks.shape[1:] != (stacks.shape[0] * K, n):
            raise ValueError(f"limb stacks shape {tuple(stacks.shape)} does not match")
    return AggregationPlan(
        **ints, share_matrix=share_matrix, limb_stacks=stacks, device=device
    )


def accumulator_from_reference(acc: np.ndarray, device=None) -> torch.Tensor:
    """A reference ``(W, nb, n)`` limb accumulator as an int64 tensor."""
    return torch.as_tensor(np.asarray(acc, dtype=np.int64), device=resolve_device(device))
