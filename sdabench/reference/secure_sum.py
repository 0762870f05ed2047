"""Plain reference of a secure sum over handed secrets: the exact sum of the
secrets mod p, which is what a packed-Shamir round reveals whatever
randomness its shares drew.

Secrets come as ``(hi, lo)`` int32 words, the value ``hi * 2^32 + lo`` with
``lo`` read as unsigned. Plain torch sums the words of each pool chunk, and
of an aggregate's chunks weighed by how often it took each, exactly in
int64 (fewer than 2^31 rows in all keep every word sum below 2^63), and
Python integers finish mod p. The share randomness cancels in that sum:
``sharing_checks`` works it out from the clerks' sums
(``reference/shamir.py``). Nothing of the port is imported.

``Float64Sum`` is the control: this reference put in the program's place
and computed in float64, the precision below the exact integer field the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from sdabench.reference import shamir

_MASK32 = (1 << 32) - 1

sharing_checks = shamir.checks


def pool_sums(hi: torch.Tensor, lo: torch.Tensor) -> tuple:
    """``(pool, C, dim)`` words -> ``(his, los, C)``: each chunk's
    ``(pool, dim)`` int64 column sums of the high and of the low words,
    summed one chunk at a time."""
    his = torch.stack([torch.sum(hi[j].to(torch.int64), dim=0) for j in range(hi.shape[0])])
    los = torch.stack([torch.sum(lo[j].to(torch.int64) & _MASK32, dim=0) for j in range(lo.shape[0])])
    return his, los, hi.shape[1]


def aggregate(sums: tuple, order, p: int) -> np.ndarray:
    """The aggregate of the chunks ``order`` (indices into the pool) mod p,
    from ``pool_sums``."""
    his, los, rows = sums
    if len(order) * rows >= 1 << 31:
        raise ValueError("too many rows for the int64 word sums")
    counts = torch.bincount(torch.as_tensor(np.asarray(order), device=his.device), minlength=his.shape[0])
    h = torch.sum(counts[:, None] * his, dim=0).cpu().numpy().astype(object)
    lo = torch.sum(counts[:, None] * los, dim=0).cpu().numpy().astype(object)
    return (h * (1 << 32) + lo) % p


class Float64Sum:
    """The control: the reference in the program's place, its sums carried
    in float64."""

    def __init__(self, p: int, dim: int, device):
        self.p, self.dim, self.device = p, dim, torch.device(device)

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.dim, dtype=torch.float64, device=self.device)

    def chunk(self, acc, hi, lo):
        values = hi.to(torch.float64) * float(1 << 32) + (lo.to(torch.int64) & _MASK32).to(torch.float64)
        return acc + torch.sum(values, dim=0)

    def reveal(self, acc) -> tuple:
        """The aggregate, and no clerk sums: there are no shares."""
        return np.array([int(v) % self.p for v in acc.cpu().tolist()], dtype=np.int64), None


def control(config: dict, device) -> Float64Sum:
    return Float64Sum(config["scheme"]["prime_modulus"], config["dim"], device)
