"""Server-side federated optimizers (counterpart of
``sda_tpu/models/optimizers.py``).

Plain FedAvg applies the revealed mean update directly (``fedavg_apply``).
The standard improvements (Reddi et al. 2021, "Adaptive Federated
Optimization") treat the mean update as a pseudo-gradient and run a server
optimizer over it: momentum (FedAvgM) and Adam (FedAdam). Their state is
flat float64 tensors on the optimizer's device, in the coordinate layout
the wire uses (``flatten_pytree``); ``state()`` hands it out as host numpy
arrays, the reference's checkpoint format, and ``load_state`` takes
either, so a state saved by one package resumes in the other.

The float64 operations run in the reference's order, and every division
is by a tensor on the device (``dequantize_mean`` says why), so a step is
bit-equal to the reference's on the same inputs. FedAdam's square root is
correctly rounded on either device (``_sqrt``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .federated import _as_tensor, flatten_pytree, unflatten_pytree


class ServerOptimizer:
    """Interface: ``apply(global_model, mean_update) -> new model``, as a
    callable, so a plain function (``fedavg_apply``) works wherever a
    ``ServerOptimizer`` is accepted."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def __call__(self, global_model, mean_update):
        raise NotImplementedError

    def state(self) -> dict:
        """numpy-array state for checkpointing (empty when stateless)."""
        return {}

    def load_state(self, state: dict) -> None:
        pass

    def _flat(self, tree):
        return flatten_pytree(tree, self.device)

    def _vector(self, value) -> torch.Tensor:
        return _as_tensor(value, torch.float64, self.device)

    def _scalar(self, value: float) -> torch.Tensor:
        return torch.tensor(value, dtype=torch.float64, device=self.device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root the reference's ``np.sqrt`` takes.
    CUDA's ``sqrt`` is; torch's vectorised CPU ``sqrt`` is 1 ulp off on about
    1 % of float64 inputs, so a CPU tensor goes through numpy's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


class FedAvgM(ServerOptimizer):
    """Server momentum: ``v = momentum·v + Δ̄;  w += lr·v``."""

    def __init__(self, momentum: float = 0.9, lr: float = 1.0, device=None):
        if not 0.0 <= momentum < 1.0:
            raise ValueError("momentum must be in [0, 1)")
        super().__init__(device)
        self.momentum = float(momentum)
        self.lr = float(lr)
        self._v = None

    def __call__(self, global_model, mean_update):
        flat_w, treedef, shapes = self._flat(global_model)
        flat_u, _, _ = self._flat(mean_update)
        if self._v is None:
            self._v = torch.zeros_like(flat_w)
        self._v = self.momentum * self._v + flat_u
        return unflatten_pytree(flat_w + self.lr * self._v, treedef, shapes)

    def state(self) -> dict:
        return {} if self._v is None else {"v": self._v.cpu().numpy()}

    def load_state(self, state: dict) -> None:
        if "v" in state:
            self._v = self._vector(state["v"])


class FedAdam(ServerOptimizer):
    """Server Adam over the pseudo-gradient Δ̄ (Reddi et al. 2021, Alg. 2).

    ``tau`` is the adaptivity floor (their ε): larger values make the
    update closer to plain FedAvg scaled by ``lr``.
    """

    def __init__(self, lr: float = 0.1, beta1: float = 0.9,
                 beta2: float = 0.99, tau: float = 1e-3, device=None):
        if not (0 <= beta1 < 1 and 0 <= beta2 < 1):
            raise ValueError("betas must be in [0, 1)")
        if tau <= 0:
            raise ValueError("tau must be positive")
        super().__init__(device)
        self.lr, self.beta1, self.beta2, self.tau = (
            float(lr), float(beta1), float(beta2), float(tau),
        )
        self._m = None
        self._v = None
        self._t = 0

    def __call__(self, global_model, mean_update):
        flat_w, treedef, shapes = self._flat(global_model)
        g, _, _ = self._flat(mean_update)
        if self._m is None:
            self._m = torch.zeros_like(flat_w)
            self._v = torch.zeros_like(flat_w)
        self._t += 1
        self._m = self.beta1 * self._m + (1 - self.beta1) * g
        self._v = self.beta2 * self._v + (1 - self.beta2) * g * g
        # bias correction keeps early rounds from undershooting
        m_hat = self._m / self._scalar(1 - self.beta1 ** self._t)
        v_hat = self._v / self._scalar(1 - self.beta2 ** self._t)
        step = self.lr * m_hat / (_sqrt(v_hat) + self.tau)
        return unflatten_pytree(flat_w + step, treedef, shapes)

    def state(self) -> dict:
        if self._m is None:
            return {}
        return {"m": self._m.cpu().numpy(), "v": self._v.cpu().numpy(), "t": np.int64(self._t)}

    def load_state(self, state: dict) -> None:
        if "m" in state:
            self._m = self._vector(state["m"])
            self._v = self._vector(state["v"])
            self._t = int(state["t"])
