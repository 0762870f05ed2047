"""Multi-round federated training with durable checkpoints (counterpart of
``sda_tpu/models/trainer.py``).

One ``FederatedAveraging`` round aggregates one cohort of updates; training
iterates: broadcast the global model, collect a secure mean update, apply
it, repeat. ``FederatedTrainer`` owns that loop and its durability: it
persists the global model and the round counter after every apply, so a
crashed coordinator resumes from its last completed round. A rerun opens a
fresh aggregation (ids are minted per round), and a double apply is
impossible because the save comes only after the apply.

Checkpoints are the reference's ``.npz`` files: the flat model as host
float64, the round counter, the leaf shapes, the template's structure as
JAX's ``PyTreeDef`` text (``TreeDef.__str__``), the privacy ledger and a
stateful optimizer's state tagged with its class name. So a checkpoint
written by either package restores in the other. The model lives on the
round driver's device, ``fed.device`` (CUDA unless the caller asks for
the CPU).
"""

from __future__ import annotations

import json
import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device
from ..telemetry.device import device_span
from .federated import _as_tensor, flatten_pytree, tree_flatten, tree_unflatten, unflatten_pytree


def fedavg_apply(global_model, mean_update, device=None):
    """``global (as float64) + update``, leaf by leaf, on ``device`` (CUDA
    unless the caller asks for the CPU). Both trees must have one
    structure."""
    device = resolve_device(device)
    g_leaves, treedef = tree_flatten(global_model)
    u_leaves, u_def = tree_flatten(mean_update)
    if u_def != treedef:
        raise ValueError(f"update structure {u_def} differs from the model's {treedef}")
    with device_span("fl.apply"):
        return tree_unflatten(treedef, [
            _as_tensor(g, torch.float64, device) + torch.as_tensor(u, device=device)
            for g, u in zip(g_leaves, u_leaves)
        ])


def child_generators(parent: torch.Generator, n: int) -> list:
    """``n`` generators on ``parent``'s device, each seeded with a 64-bit
    seed drawn from ``parent`` in order: the same parent state gives the
    same children."""
    words = torch.randint(0, 1 << 32, (n, 2), generator=parent, dtype=torch.int64,
                          device=parent.device).tolist()
    return [torch.Generator(device=parent.device).manual_seed((hi << 32) | lo) for hi, lo in words]


class FederatedTrainer:
    """Iterated secure FedAvg over any ``SdaService``.

    ``apply_update`` defaults to plain FedAvg (``fedavg_apply``); pass a
    ``ServerOptimizer`` (``FedAvgM``, ``FedAdam``) or any callable for
    server learning rates or momentum. A stateful optimizer's state rides
    in the checkpoints (``opt_*`` keys), so a resume continues its
    estimates. ``checkpoint_dir=None`` disables persistence.
    """

    def __init__(self, fed, global_model, *, checkpoint_dir: str | None = None,
                 apply_update=None, keep_checkpoints: int = 3):
        self.fed = fed
        self.global_model = global_model
        self.round_index = 0
        self.checkpoint_dir = checkpoint_dir
        self.apply_update = apply_update or self._fedavg_apply
        self.keep_checkpoints = max(1, keep_checkpoints)
        # privacy ledger: per-round zCDP rho (filled when ``fed`` is a DP
        # driver), persisted so a resumed coordinator keeps its spent budget
        self.round_rhos: list = []
        self.privacy_delta: float = 0.0

    def _fedavg_apply(self, global_model, mean_update):
        return fedavg_apply(global_model, mean_update, self.fed.device)

    # -- persistence -----------------------------------------------------------

    def _ckpt_path(self) -> str:
        return os.path.join(self.checkpoint_dir, f"round_{self.round_index:06d}.npz")

    @staticmethod
    def _ckpt_round(filename: str) -> int:
        return int(filename[len("round_") : -len(".npz")])

    def save(self) -> str:
        """Write the global model and round counter through a temporary
        file and an atomic rename; keep the last ``keep_checkpoints`` files
        and prune older ones. A model whose structure drifted from the
        template is refused."""
        if self.checkpoint_dir is None:
            raise ValueError("trainer has no checkpoint_dir")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        flat, treedef, shapes = flatten_pytree(self.global_model, self.fed.device)
        if treedef != self.fed.treedef:
            # a custom apply_update drifted the model's structure: fail at
            # save time, not as silent cross-mapping at restore time
            raise ValueError(
                f"global model structure {treedef} differs from the "
                f"aggregation template {self.fed.treedef}"
            )
        path = self._ckpt_path()
        fd, tmp = tempfile.mkstemp(dir=self.checkpoint_dir, suffix=".tmp")
        try:
            state_fn = getattr(self.apply_update, "state", None)
            opt_state = (
                {f"opt_{k}": v for k, v in state_fn().items()} if callable(state_fn) else {}
            )
            if opt_state:
                # resuming under another optimizer must fail loudly, not
                # install (say) Adam's second moments as a momentum buffer
                opt_state["opt_type"] = type(self.apply_update).__name__
            with os.fdopen(fd, "wb") as fh:
                np.savez(
                    fh,
                    flat=flat.cpu().numpy(),
                    round_index=self.round_index,
                    shapes=json.dumps([list(s) for s in shapes]),
                    treedef=str(self.fed.treedef),
                    privacy_rhos=np.asarray(self.round_rhos, dtype=np.float64),
                    privacy_delta=self.privacy_delta,
                    **opt_state,
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        for old in self._checkpoints()[: -self.keep_checkpoints]:
            os.unlink(os.path.join(self.checkpoint_dir, old))
        return path

    def _checkpoints(self) -> list:
        """Checkpoint filenames, oldest first, in numeric round order (a
        lexicographic sort misorders once rounds outgrow the padding).
        Foreign files (an operator's ``round_best.npz``) are ignored and
        never pruned."""
        found = []
        for f in os.listdir(self.checkpoint_dir):
            if f.startswith("round_") and f.endswith(".npz"):
                try:
                    found.append((self._ckpt_round(f), f))
                except ValueError:
                    continue
        return [f for _, f in sorted(found)]

    def restore_latest(self) -> bool:
        """Load the newest checkpoint, if any; returns whether one loaded.
        A checkpoint of another structure or shapes, or with another
        optimizer's state, is refused."""
        if self.checkpoint_dir is None or not os.path.isdir(self.checkpoint_dir):
            return False
        ckpts = self._checkpoints()
        if not ckpts:
            return False
        with np.load(os.path.join(self.checkpoint_dir, ckpts[-1])) as data:
            shapes = [tuple(s) for s in json.loads(str(data["shapes"]))]
            # structure and shapes must both match: equal shape lists under
            # different structures would silently cross-map parameters
            if "treedef" in data and str(data["treedef"]) != str(self.fed.treedef):
                raise ValueError("checkpoint layout differs from the template model (treedef)")
            if shapes != [tuple(s) for s in self.fed.shapes]:
                raise ValueError("checkpoint layout differs from the template model")
            self.global_model = unflatten_pytree(
                torch.as_tensor(data["flat"], device=self.fed.device), self.fed.treedef,
                self.fed.shapes,
            )
            self.round_index = int(data["round_index"])
            if "privacy_rhos" in data:  # absent in pre-ledger checkpoints
                self.round_rhos = [float(r) for r in data["privacy_rhos"]]
                self.privacy_delta = float(data["privacy_delta"])
            saved_type = str(data["opt_type"]) if "opt_type" in data.files else None
            if saved_type is not None:
                current = type(self.apply_update).__name__
                if saved_type != current:
                    raise ValueError(
                        f"checkpoint carries {saved_type} optimizer state "
                        f"but the trainer was built with {current}; resume "
                        "with the matching optimizer (or delete the "
                        "checkpoints to restart server optimization cold)"
                    )
                self.apply_update.load_state({
                    k[len("opt_"):]: data[k]
                    for k in data.files
                    if k.startswith("opt_") and k != "opt_type"
                })
        return True

    # -- the round loop ----------------------------------------------------------

    def run_round(self, recipient, recipient_key, sharing_scheme, submitters, workers, *,
                  parallel_submit: int = 0):
        """One full secure round: open, collect, clerk, reveal, apply, save.

        ``submitters``: ``(client, update_fn)`` pairs; ``update_fn`` takes
        the global model and returns an update pytree. ``workers``: the
        clients that drain clerking queues. ``parallel_submit`` > 0 runs
        the participations on that many threads; a DP driver's generator
        is then not shared: each submitter gets a child generator
        (``child_generators``, in submitter order).
        """
        agg_id = self.fed.open_round(
            recipient, recipient_key, sharing_scheme, title=f"federated-round-{self.round_index}"
        )

        def submit_one(client, update_fn, child=None):
            update = update_fn(self.global_model)
            if child is None:
                self.fed.submit_update(client, agg_id, update)
            else:
                self.fed.submit_update(client, agg_id, update, generator=child)

        if parallel_submit > 0:
            shared = getattr(self.fed, "_generator", None)
            children = (
                child_generators(shared, len(submitters))
                if shared is not None
                else [None] * len(submitters)
            )
            with ThreadPoolExecutor(max_workers=parallel_submit) as pool:
                # list() raises the first worker exception
                list(pool.map(lambda args: submit_one(*args[0], args[1]),
                              zip(submitters, children)))
        else:
            for client, update_fn in submitters:
                submit_one(client, update_fn)
        self.fed.close_round(recipient, agg_id)
        for worker in workers:
            worker.run_chores(-1)
        # charge the ledger before the release: the reveal spends privacy
        # irreversibly, so a crash between it and the post-apply checkpoint
        # must not lose the charge. The pre-reveal save rewrites this
        # round's checkpoint with the old model and the new rho.
        privacy = getattr(self.fed, "privacy", None)
        if privacy is not None:
            try:
                acct = privacy(len(submitters))
                rho, delta = acct.rho, acct.delta
            except NotImplementedError:
                # no accounting for this mechanism (Skellam): ledger the
                # release as unbounded rather than crash or omit it
                rho, delta = float("inf"), 0.0
            self.round_rhos.append(rho)
            self.privacy_delta = max(self.privacy_delta, delta)
            if self.checkpoint_dir is not None:
                self.save()
        mean_update = self.fed.finish_round(recipient, agg_id, len(submitters))
        self.global_model = self.apply_update(self.global_model, mean_update)
        self.round_index += 1
        if self.checkpoint_dir is not None:
            self.save()
        return self.global_model

    def cumulative_privacy(self, delta: float | None = None):
        """Total (ε, δ) over the completed DP rounds (zCDP adds; one tight
        conversion); None when no DP round has run."""
        if not self.round_rhos:
            return None
        from .dp import compose_rhos

        return compose_rhos(self.round_rhos, self.privacy_delta if delta is None else delta)
