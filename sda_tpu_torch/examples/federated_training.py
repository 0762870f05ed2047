"""Runnable demo: private federated training of a logistic regression, in
one process (counterpart of ``examples/federated_training.py``).

    python -m sda_tpu_torch.examples.federated_training [--device cpu]

Four hospitals (participants) hold disjoint patient data; they train a
shared model without any party (server, clerks, recipient) seeing one
hospital's update, through the whole protocol: committee election, ChaCha
masking, packed-Shamir sharing, sealed boxes, clerking, reconstruction.
Four rounds under server Adam with checkpoints, then two rounds under
distributed differential privacy with the trainer's zCDP ledger. The data
are the reference's numpy draws; the hospitals' local steps, the model and
the server step run on the device (CUDA unless ``--device cpu``; without a
GPU and without ``--device cpu`` it exits 2). It prints the reference's
lines, and fails if the model does not learn or its checkpoint does not
restore bit for bit.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from ..client import SdaClient
from ..crypto import Keystore
from ..device import resolve_device
from ..models import (
    DPConfig,
    DPFederatedAveraging,
    FedAdam,
    FederatedAveraging,
    FederatedTrainer,
    QuantizationSpec,
)
from ..server import new_mem_server


def make_client(service, path, device):
    keystore = Keystore(path)
    client = SdaClient(SdaClient.new_agent(keystore), keystore, service, device=device)
    client.upload_agent()
    return client


def local_sgd(x, y, lr=0.5, steps=5):
    """Participant-side training: local steps from the global model,
    returning the weight delta."""

    def fn(global_model):
        w0, b0 = (torch.as_tensor(global_model[k], dtype=torch.float64, device=x.device)
                  for k in ("w", "b"))
        w, b = w0, b0
        for _ in range(steps):
            p = 1 / (1 + torch.exp(-(x @ w + b)))
            w = w - lr * (x.T @ (p - y)) / len(y)
            b = b - lr * torch.mean(p - y)
        return {"w": w - w0, "b": b - b0}

    return fn


def run(device) -> None:
    device = resolve_device(device)
    service = new_mem_server()
    tmp = tempfile.mkdtemp()

    recipient = make_client(service, f"{tmp}/recipient", device)
    recipient_key = recipient.new_encryption_key()
    recipient.upload_encryption_key(recipient_key)
    clerks = [make_client(service, f"{tmp}/clerk{i}", device) for i in range(8)]
    for clerk in clerks:
        clerk.upload_encryption_key(clerk.new_encryption_key())

    # synthetic "hospitals": disjoint shards of one linearly separable task
    rng = np.random.default_rng(0)
    w_true = np.array([1.5, -2.0])
    hospitals = []
    for i in range(4):
        x = rng.normal(size=(100, 2))
        y = (x @ w_true + 0.1 * rng.normal(size=100) > 0).astype(np.float64)
        x, y = torch.as_tensor(x, device=device), torch.as_tensor(y, device=device)
        part = make_client(service, f"{tmp}/hospital{i}", device)
        hospitals.append(((part, local_sgd(x, y)), (x, y)))
    submitters = [h[0] for h in hospitals]
    all_x = torch.cat([h[1][0] for h in hospitals])
    all_y = torch.cat([h[1][1] for h in hospitals])

    template = {"w": np.zeros(2), "b": np.zeros(())}
    spec, sharing = QuantizationSpec.fitted(frac_bits=20, clip=8.0, n_participants=8)
    # server-side Adam over the revealed mean update (Reddi et al. 2021);
    # its moment estimates ride inside the checkpoints, type-tagged
    trainer = FederatedTrainer(
        FederatedAveraging(spec, template, device),
        template,
        checkpoint_dir=f"{tmp}/checkpoints",
        apply_update=FedAdam(lr=0.8, device=device),
    )

    def loss(model):
        w = torch.as_tensor(model["w"], dtype=torch.float64, device=device)
        b = torch.as_tensor(model["b"], dtype=torch.float64, device=device)
        p = 1 / (1 + torch.exp(-(all_x @ w + b)))
        eps = 1e-9
        return float(-torch.mean(all_y * torch.log(p + eps) + (1 - all_y) * torch.log(1 - p + eps)))

    initial = loss(trainer.global_model)
    print(f"round 0: loss={initial:.4f} (untrained)")
    for _ in range(4):
        trainer.run_round(recipient, recipient_key, sharing, submitters, [recipient] + clerks)
        print(
            f"round {trainer.round_index}: loss={loss(trainer.global_model):.4f} "
            f"w={np.round(trainer.global_model['w'].cpu().numpy(), 3)}"
        )
    print(f"checkpoints in {tmp}/checkpoints")
    final = loss(trainer.global_model)
    if not final < 0.5 * initial:
        raise AssertionError(f"the model did not learn: loss {initial:.4f} -> {final:.4f}")
    resumed = FederatedTrainer(
        FederatedAveraging(spec, template, device), template,
        checkpoint_dir=f"{tmp}/checkpoints", apply_update=FedAdam(lr=0.8, device=device),
    )
    if not (resumed.restore_latest() and resumed.round_index == 4 and all(
            torch.equal(resumed.global_model[k], trainer.global_model[k]) for k in template)):
        raise AssertionError("the round-4 checkpoint does not restore the trained model")

    # the same loop under distributed differential privacy: every hospital
    # adds discrete-Gaussian field noise, and the trainer keeps a zCDP
    # ledger across rounds inside its checkpoints
    dp = DPConfig(l2_clip=2.0, noise_multiplier=1.0, expected_participants=4)
    dp_spec, dp_sharing = DPFederatedAveraging.fitted_spec(20, dp, dim=3)
    dp_trainer = FederatedTrainer(
        DPFederatedAveraging(dp_spec, template, dp, device=device), template,
        checkpoint_dir=f"{tmp}/dp-checkpoints",
    )
    for _ in range(2):
        dp_trainer.run_round(recipient, recipient_key, dp_sharing, submitters, [recipient] + clerks)
    acct = dp_trainer.cumulative_privacy()
    print(
        f"DP training: {acct.rounds} rounds, cumulative "
        f"eps={acct.epsilon:.2f} delta={acct.delta:g}, "
        f"loss={loss(dp_trainer.global_model):.4f}"
    )
    if acct.rounds != 2:
        raise AssertionError(f"the privacy ledger holds {acct.rounds} rounds, not 2")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sda_tpu_torch.examples.federated_training",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: CUDA; exits 2 without a GPU)")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        print(f"federated_training: {exc}", file=sys.stderr)
        return 2
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
