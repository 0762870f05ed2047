"""Plain reference of a secure FedAvg round: what a round must reveal and
apply, whatever masks and shares it drew.

Each update is clipped to ``[-clip, clip]``, scaled by ``2^frac_bits`` and
rounded half to even, a negative value standing as its residue mod p. The
field sum is the sum of those residues mod p (exact in int64: each residue
is below p < 2^31). Its centered lift over ``2^frac_bits`` and over the
cohort's size is the mean update, which the global model adds in float64.
Masks and share randomness cancel in that sum, so a mask or a draw that is
wrong on both sides alike would not show there: ``mask`` expands a
participant's seed again with plain ChaCha20 (``reference/chacha20.py``),
and ``sharing_checks`` works out the summed share randomness and the
dropped clerk's sum from the clerks' sums (``reference/shamir.py``).
Plain torch and numpy, in blocks of rows; nothing of the port is imported.

``Float32Round`` is the control: this reference put in the program's place
and computed in float32, the precision below the configuration's (exact
field sums, a float64 model).
"""

from __future__ import annotations

import math

import torch

from sdabench.reference import chacha20, shamir

BLOCK_ROWS = 25

mask = chacha20.mask
sharing_checks = shamir.checks


def field_sum(updates: torch.Tensor, clip: float, frac_bits: int, p: int) -> torch.Tensor:
    """``(P, dim)`` float updates -> the ``(dim,)`` int64 field sum mod p."""
    if p >= 1 << 31 or updates.shape[0] >= 1 << 32:
        raise ValueError("the int64 residue sum is exact for p < 2^31 and fewer than 2^32 rows")
    total = torch.zeros(updates.shape[1], dtype=torch.int64, device=updates.device)
    for start in range(0, updates.shape[0], BLOCK_ROWS):
        x = torch.clamp(updates[start: start + BLOCK_ROWS].to(torch.float64), -clip, clip)
        q = torch.round(x * float(1 << frac_bits)).to(torch.int64)
        total += torch.sum(torch.remainder(q, p), dim=0)
    return torch.remainder(total, p)


def mean_update(field_sum: torch.Tensor, n: int, frac_bits: int, p: int) -> torch.Tensor:
    """The float64 mean update of ``n`` participants from their field sum.
    Both divisions are by tensors: a CUDA division by a host scalar is a
    product with its reciprocal, which may round otherwise."""
    centered = torch.where(field_sum > p // 2, field_sum - p, field_sum).to(torch.float64)
    scale = torch.tensor(float(1 << frac_bits), dtype=torch.float64, device=field_sum.device)
    count = torch.tensor(float(n), dtype=torch.float64, device=field_sum.device)
    return centered / scale / count


class Float32Round:
    """The control: a round computed by the reference in float32, its sum
    taken before quantizing and its mean and model in float32."""

    def __init__(self, config: dict):
        self.clip = config["quantization"]["clip"]
        self.frac_bits = config["quantization"]["frac_bits"]
        self.p = config["scheme"]["prime_modulus"]
        layers = config["model"]["layers"]
        self.leaves, offset = [], 0
        for layer in sorted(layers):  # the flat layout: leaves in sorted key order
            for name in sorted(layers[layer]):
                shape = tuple(layers[layer][name])
                self.leaves.append((layer, name, shape, offset))
                offset += math.prod(shape)

    def round(self, cohort, seeds, global_model, chunk, watch=None):
        total = torch.zeros(cohort.shape[1], dtype=torch.float32, device=cohort.device)
        for start in range(0, cohort.shape[0], chunk):
            total += torch.sum(torch.clamp(cohort[start: start + chunk], -self.clip, self.clip), dim=0)
        q = torch.round(total * float(1 << self.frac_bits)).to(torch.int64)
        mean = total / float(cohort.shape[0])
        new_global = {}
        for layer, name, shape, offset in self.leaves:
            g = global_model[layer][name].to(torch.float32)
            part = mean[offset: offset + g.numel()].view(shape)
            new_global.setdefault(layer, {})[name] = (g + part).to(torch.float64)
        return {"field_sum": torch.remainder(q, self.p), "new_global": new_global}


def control(config: dict, device) -> Float32Round:
    return Float32Round(config)
