"""The port's ``FederatedTrainer`` against ``sda_tpu`` on the CPU.

The reference's eleven trainer tests (tests/test_federated_training.py),
mirrored on the port's trainer over the port's memory server: training
learns, checkpoints prune in numeric order and ignore foreign files,
restores refuse another layout, structure or optimizer, optimizer state
resumes, parallel submitters train, and parallel DP submitters draw from
child generators that replay. Then what a port must add: checkpoints
written by either package restore in the other (plain, FedAvgM, FedAdam and
a DP ledger), and another optimizer's tag is refused in both; ``TreeDef``
prints JAX's ``PyTreeDef`` text; a trainer resumed after round 2 equals an
uninterrupted three-round trainer bit for bit; a failure inside
``finish_round`` leaves the new rho and the old model on disk; and two
trainers with one parent seed reveal the same DP sums.
"""

import shutil
from collections import OrderedDict, namedtuple

import jax
import numpy as np
import pytest
import torch

from sda_tpu.models import FedAdam as JFedAdam
from sda_tpu.models import FedAvgM as JFedAvgM
from sda_tpu.models import FederatedAveraging as JFed
from sda_tpu.models import QuantizationSpec as JSpec
from sda_tpu.models.trainer import FederatedTrainer as JTrainer
from sda_tpu_torch.models import (
    DPConfig,
    DPFederatedAveraging,
    FedAdam,
    FedAvgM,
    FederatedAveraging,
    FederatedTrainer,
    QuantizationSpec,
    flatten_pytree,
    tree_flatten,
)
from sda_tpu_torch.models.trainer import child_generators
from test_torch_fedavg_round import Deployment

CPU = "cpu"


def _data(seed, n=80):
    """Linearly separable 2-class data, split per participant."""
    rng = np.random.default_rng(seed)
    w_true = np.array([1.5, -2.0])
    x = rng.normal(size=(n, 2))
    y = (x @ w_true + 0.1 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y


def _loss(model, x, y):
    z = x @ np.asarray(model["w"]) + float(model["b"])
    pz = 1 / (1 + np.exp(-z))
    eps = 1e-9
    return float(-np.mean(y * np.log(pz + eps) + (1 - y) * np.log(1 - pz + eps)))


def _local_update(x, y, lr=0.5, steps=5):
    """update_fn factory: a few local gradient steps on the global model
    (tensor leaves), returning the delta."""

    def fn(global_model):
        w0, b0 = np.asarray(global_model["w"], dtype=np.float64), float(global_model["b"])
        w, b = w0.copy(), b0
        for _ in range(steps):
            pz = 1 / (1 + np.exp(-(x @ w + b)))
            w -= lr * x.T @ (pz - y) / len(y)
            b -= lr * float(np.mean(pz - y))
        return {"w": w - w0, "b": np.array(b - b0)}

    return fn


def _template():
    return {"w": np.zeros(2), "b": np.zeros(())}


def _fed(template=None, frac_bits=20, clip=8.0, n=8):
    spec, sharing = QuantizationSpec.fitted(frac_bits, clip, n)
    return FederatedAveraging(spec, _template() if template is None else template, CPU), sharing


def _submitters(deployment, count):
    return [(deployment.participant(), _local_update(*_data(seed))) for seed in range(count)]


def _workers(deployment):
    return [deployment.recipient] + deployment.clerks


# -- the reference's eleven, on the port ------------------------------------------


def test_training_learns_and_checkpoints(tmp_path):
    fed, sharing = _fed()
    datasets = [_data(seed) for seed in range(4)]
    all_x = np.concatenate([d[0] for d in datasets])
    all_y = np.concatenate([d[1] for d in datasets])
    deployment = Deployment(tmp_path / "round", "port")
    participants = _submitters(deployment, 4)
    trainer = FederatedTrainer(fed, _template(), checkpoint_dir=str(tmp_path / "ckpt"))
    losses = [_loss(trainer.global_model, all_x, all_y)]
    for _ in range(3):
        trainer.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                          _workers(deployment))
        losses.append(_loss(trainer.global_model, all_x, all_y))
    assert losses[-1] < losses[0] * 0.5, f"did not learn: {losses}"
    assert trainer.round_index == 3
    resumed = FederatedTrainer(fed, _template(), checkpoint_dir=str(tmp_path / "ckpt"))
    assert resumed.restore_latest()
    assert resumed.round_index == 3
    for key in ("w", "b"):
        assert torch.equal(resumed.global_model[key], trainer.global_model[key])


def test_restore_rejects_layout_mismatch(tmp_path):
    fed, _ = _fed(frac_bits=8, clip=1.0, n=2)
    FederatedTrainer(fed, _template(), checkpoint_dir=str(tmp_path)).save()
    other = {"w": np.zeros(3), "b": np.zeros(())}
    bad = FederatedTrainer(_fed(other, 8, 1.0, 2)[0], other, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="layout"):
        bad.restore_latest()


def test_restore_without_checkpoints():
    template = {"w": np.zeros(2)}
    trainer = FederatedTrainer(_fed(template, 8, 1.0, 2)[0], template)
    assert not trainer.restore_latest()


def test_checkpoint_pruning_and_numeric_order(tmp_path):
    template = {"w": np.zeros(2)}
    fed, _ = _fed(template, 8, 1.0, 2)
    trainer = FederatedTrainer(fed, template, checkpoint_dir=str(tmp_path), keep_checkpoints=2)
    for i in range(5):
        trainer.global_model = {"w": np.full(2, float(i))}
        trainer.save()
        trainer.round_index += 1
    assert trainer._checkpoints() == ["round_000003.npz", "round_000004.npz"]
    resumed = FederatedTrainer(fed, template, checkpoint_dir=str(tmp_path))
    assert resumed.restore_latest()
    assert resumed.round_index == 4
    np.testing.assert_array_equal(resumed.global_model["w"].numpy(), np.full(2, 4.0))


def test_restore_rejects_treedef_mismatch(tmp_path):
    """Equal shape lists under different structures must not cross-map."""
    a = {"a": np.zeros(3), "b": np.zeros(3)}
    FederatedTrainer(_fed(a, 8, 1.0, 2)[0], a, checkpoint_dir=str(tmp_path)).save()
    x = {"x": np.zeros(3), "y": np.zeros(3)}
    bad = FederatedTrainer(_fed(x, 8, 1.0, 2)[0], x, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="treedef"):
        bad.restore_latest()


def test_checkpoints_ignore_foreign_files(tmp_path):
    template = {"w": np.zeros(2)}
    trainer = FederatedTrainer(_fed(template, 8, 1.0, 2)[0], template, checkpoint_dir=str(tmp_path))
    trainer.save()
    (tmp_path / "round_best.npz").write_bytes(b"not a checkpoint")
    assert trainer._checkpoints() == ["round_000000.npz"]
    trainer.round_index = 1
    trainer.save()  # pruning must not crash on (or delete) the foreign file
    assert (tmp_path / "round_best.npz").exists()


def test_save_rejects_structural_drift(tmp_path):
    template = {"a": np.zeros(2), "b": np.zeros(2)}
    trainer = FederatedTrainer(_fed(template, 8, 1.0, 2)[0], template, checkpoint_dir=str(tmp_path))
    trainer.global_model = {"x": np.zeros(2), "y": np.zeros(2)}  # drifted keys
    with pytest.raises(ValueError, match="structure"):
        trainer.save()


def test_server_optimizer_math():
    """FedAvgM and FedAdam agree with hand-computed updates."""
    model = {"w": np.array([1.0, 2.0])}
    u1 = {"w": np.array([0.5, -0.5])}
    u2 = {"w": np.array([0.1, 0.1])}
    m = FedAvgM(momentum=0.5, lr=1.0, device=CPU)
    step1 = m(model, u1)  # v = u1
    np.testing.assert_allclose(step1["w"].numpy(), [1.5, 1.5])
    step2 = m(step1, u2)  # v = 0.5*u1 + u2
    np.testing.assert_allclose(step2["w"].numpy(), step1["w"].numpy() + [0.35, -0.15])
    a = FedAdam(lr=0.1, beta1=0.9, beta2=0.99, tau=1e-3, device=CPU)
    g = np.array([0.5, -0.5])
    # first step with bias correction: m_hat = g, v_hat = g^2
    np.testing.assert_allclose(a(model, u1)["w"].numpy(), model["w"] + 0.1 * g / (np.abs(g) + 1e-3))
    assert set(a.state()) == {"m", "v", "t"}


def test_trainer_checkpoints_optimizer_state(tmp_path):
    """A resumed coordinator continues with the same server-optimizer
    state; another optimizer (or none) is refused."""
    fed, sharing = _fed()
    deployment = Deployment(tmp_path / "round", "port")
    participants = _submitters(deployment, 2)
    ckpt = str(tmp_path / "ckpt")
    opt = FedAdam(lr=0.5, device=CPU)
    trainer = FederatedTrainer(fed, _template(), checkpoint_dir=ckpt, apply_update=opt)
    for _ in range(2):
        trainer.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                          _workers(deployment))
    fresh_opt = FedAdam(lr=0.5, device=CPU)
    resumed = FederatedTrainer(fed, _template(), checkpoint_dir=ckpt, apply_update=fresh_opt)
    assert resumed.restore_latest()
    assert resumed.round_index == 2
    np.testing.assert_array_equal(fresh_opt.state()["m"], opt.state()["m"])
    np.testing.assert_array_equal(fresh_opt.state()["v"], opt.state()["v"])
    assert int(fresh_opt.state()["t"]) == 2
    for apply_update in (FedAvgM(device=CPU), None):
        mismatched = FederatedTrainer(fed, _template(), checkpoint_dir=ckpt, apply_update=apply_update)
        with pytest.raises(ValueError, match="FedAdam optimizer state"):
            mismatched.restore_latest()
    model3 = resumed.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                               _workers(deployment))
    assert resumed.round_index == 3
    assert bool(torch.isfinite(flatten_pytree(model3, CPU)[0]).all())


def test_parallel_submit_round(tmp_path):
    fed, sharing = _fed()
    deployment = Deployment(tmp_path, "port")
    trainer = FederatedTrainer(fed, _template())
    trainer.run_round(deployment.recipient, deployment.rkey, sharing, _submitters(deployment, 4),
                      _workers(deployment), parallel_submit=4)
    assert trainer.round_index == 1
    w = trainer.global_model["w"]
    # one round on separable data: the weights move in the true direction
    assert w[0] > 0 and w[1] < 0


def _dp_fed(seed, dim=4, n=3):
    dp = DPConfig(l2_clip=1.0, noise_multiplier=0.5, expected_participants=n)
    spec, sharing = DPFederatedAveraging.fitted_spec(14, dp, dim)
    fed = DPFederatedAveraging(spec, {"w": np.zeros(dim)}, dp, torch.Generator().manual_seed(seed),
                               device=CPU)
    return fed, sharing


def _recorded_reveals(fed) -> list:
    """Wrap ``fed.reveal_field_sum`` to record each revealed sum."""
    seen, real = [], fed.reveal_field_sum

    def reveal(*args):
        out = real(*args)
        seen.append(out.numpy().copy())
        return out

    fed.reveal_field_sum = reveal
    return seen


def test_parallel_submit_dp_uses_child_generators(tmp_path):
    """Parallel submission over a DP driver does not share its generator:
    each submitter gets a child seeded from it in submitter order, and the
    round's noise replays from the same children."""
    dim, n = 4, 3
    fed, sharing = _dp_fed(7, dim, n)
    revealed = _recorded_reveals(fed)
    deployment = Deployment(tmp_path, "port")
    participants = [(deployment.participant(), lambda m: {"w": np.full(dim, 0.1)}) for _ in range(n)]
    FederatedTrainer(fed, {"w": np.zeros(dim)}).run_round(
        deployment.recipient, deployment.rkey, sharing, participants, _workers(deployment),
        parallel_submit=3)
    total = torch.zeros(dim, dtype=torch.int64)
    for child in child_generators(torch.Generator().manual_seed(7), n):
        total += fed.spec.quantize(np.full(dim, 0.1), CPU) + fed.dp.party_noise(fed.spec.scale, dim, child)
    np.testing.assert_array_equal(revealed[0], (total % fed.spec.modulus).numpy())


# -- checkpoints across packages ----------------------------------------------------

# a nested layout with a list, keys out of sorted order
CROSS_TEMPLATE = {"fc": [np.zeros((3, 2)), np.zeros(2)], "conv1": {"k": np.zeros((2, 2)), "b": np.zeros(2)}}


def _cross_trainer(package, kind, ckpt):
    """A trainer of ``package`` over CROSS_TEMPLATE with ``kind``'s
    optimizer (``plain`` and ``dp`` apply plain FedAvg)."""
    if package == "port":
        spec, _ = QuantizationSpec.fitted(16, 1.0, 4)
        fed = FederatedAveraging(spec, CROSS_TEMPLATE, CPU)
        opt = {"fedavgm": lambda: FedAvgM(device=CPU), "fedadam": lambda: FedAdam(device=CPU)}
        trainer_cls = FederatedTrainer
    else:
        jspec, _ = JSpec.fitted(16, 1.0, 4)
        fed = JFed(jspec, CROSS_TEMPLATE)
        opt = {"fedavgm": JFedAvgM, "fedadam": JFedAdam}
        trainer_cls = JTrainer
    apply_update = opt[kind]() if kind in opt else None
    return trainer_cls(fed, CROSS_TEMPLATE, checkpoint_dir=str(ckpt), apply_update=apply_update)


def _seeded_tree(rng):
    return {"fc": [rng.standard_normal((3, 2)), rng.standard_normal(2)],
            "conv1": {"k": rng.standard_normal((2, 2)), "b": rng.standard_normal(2)}}


def _host_flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(leaf, dtype=np.float64).reshape(-1)
                           for leaf in jax.tree_util.tree_leaves(tree)])


def _write(package, kind, ckpt):
    """Run ``kind``'s optimizer over two seeded updates in ``package``'s
    trainer, set a round index and (for ``dp``) a privacy ledger, save."""
    rng = np.random.default_rng(21)
    trainer = _cross_trainer(package, kind, ckpt)
    model = _seeded_tree(rng)
    if kind in ("fedavgm", "fedadam"):
        for _ in range(2):
            model = trainer.apply_update(model, _seeded_tree(rng))
    trainer.global_model = model
    trainer.round_index = 5
    if kind == "dp":
        trainer.round_rhos, trainer.privacy_delta = [0.125, float("inf"), 0.5], 1e-6
    trainer.save()
    return trainer


@pytest.mark.parametrize("kind", ["plain", "fedavgm", "fedadam", "dp"])
@pytest.mark.parametrize("direction", ["reference to port", "port to reference"])
def test_checkpoint_restores_across_packages(tmp_path, direction, kind):
    source, target = ("ref", "port") if direction.startswith("reference") else ("port", "ref")
    written = _write(source, kind, tmp_path)
    restored = _cross_trainer(target, kind, tmp_path)
    assert restored.restore_latest()
    assert restored.round_index == 5
    assert restored.round_rhos == written.round_rhos
    assert restored.privacy_delta == written.privacy_delta
    if target == "port":
        flat, treedef, _ = flatten_pytree(restored.global_model, CPU)
        assert str(treedef) == str(jax.tree_util.tree_structure(CROSS_TEMPLATE))
        np.testing.assert_array_equal(flat.numpy(), _host_flat(written.global_model))
    else:
        np.testing.assert_array_equal(_host_flat(restored.global_model),
                                      flatten_pytree(written.global_model, CPU)[0].numpy())
    want = written.apply_update.state() if hasattr(written.apply_update, "state") else {}
    got = restored.apply_update.state() if hasattr(restored.apply_update, "state") else {}
    assert set(got) == set(want) == {"fedavgm": {"v"}, "fedadam": {"m", "v", "t"}}.get(kind, set())
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


@pytest.mark.parametrize("direction", ["reference to port", "port to reference"])
def test_checkpoint_of_another_optimizer_is_refused_in_both(tmp_path, direction):
    source, target = ("ref", "port") if direction.startswith("reference") else ("port", "ref")
    _write(source, "fedadam", tmp_path)
    with pytest.raises(ValueError, match="FedAdam optimizer state"):
        _cross_trainer(target, "fedavgm", tmp_path).restore_latest()


NT = namedtuple("NT", "a b")
TREES = {
    "dict": {"w": 0.0, "b": 0.0},
    "list with a tuple and None": [0.0, (0.0, None)],
    "nested": {"fc": [0.0, 0.0], "conv1": {"k": 0.0, "b": 0.0}},
    "namedtuple": NT(0.0, 0.0),
    "OrderedDict": OrderedDict([("z", 0.0), ("a", 0.0)]),
    "leaf": 0.0,
    "one-tuple and empties": ((0.0,), {}, [], None),
    "int keys": {2: 0.0, 1: {"it's": 0.0}},
    "namedtuple of an OrderedDict": {"x": NT(0.0, OrderedDict([("q", None)]))},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_treedef_prints_jax_text(name):
    tree = TREES[name]
    assert str(tree_flatten(tree)[1]) == str(jax.tree_util.tree_structure(tree))


# -- resume, failure and replay ------------------------------------------------------


def test_resumed_trainer_equals_an_uninterrupted_one(tmp_path):
    """Three rounds straight, against two rounds, a restore of round 2's
    checkpoint by a fresh trainer, and a third round: the models and the
    optimizers' state are equal bit for bit."""
    fed, sharing = _fed()
    deployment = Deployment(tmp_path / "round", "port")
    participants = _submitters(deployment, 2)
    straight = FederatedTrainer(fed, _template(), checkpoint_dir=str(tmp_path / "a"),
                                apply_update=FedAdam(lr=0.5, device=CPU))
    for _ in range(3):
        straight.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                           _workers(deployment))
    # the coordinator "crashed" after round 2: its directory without round 3
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    (tmp_path / "b" / "round_000003.npz").unlink()
    resumed = FederatedTrainer(fed, _template(), checkpoint_dir=str(tmp_path / "b"),
                               apply_update=FedAdam(lr=0.5, device=CPU))
    assert resumed.restore_latest() and resumed.round_index == 2
    resumed.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                      _workers(deployment))
    assert resumed.round_index == straight.round_index == 3
    for key in ("w", "b"):
        assert torch.equal(resumed.global_model[key], straight.global_model[key])
    for key, value in straight.apply_update.state().items():
        np.testing.assert_array_equal(resumed.apply_update.state()[key], value)


def test_failure_in_finish_round_leaves_the_new_rho_and_the_old_model(tmp_path):
    fed, sharing = _dp_fed(3)
    deployment = Deployment(tmp_path / "round", "port")
    participants = [(deployment.participant(), lambda m: {"w": np.full(4, 0.2)}) for _ in range(3)]
    start = {"w": np.array([0.5, -1.0, 2.0, 0.25])}
    trainer = FederatedTrainer(fed, start, checkpoint_dir=str(tmp_path / "ckpt"))

    def broken(*args):
        raise RuntimeError("coordinator lost during the reveal")

    fed.finish_round = broken
    with pytest.raises(RuntimeError, match="coordinator lost"):
        trainer.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                          _workers(deployment))
    with np.load(tmp_path / "ckpt" / "round_000000.npz") as data:
        np.testing.assert_array_equal(data["flat"], start["w"])
        assert int(data["round_index"]) == 0
        np.testing.assert_array_equal(data["privacy_rhos"], [fed.privacy(3).rho])
        assert float(data["privacy_delta"]) == fed.dp.delta
    resumed = FederatedTrainer(fed, start, checkpoint_dir=str(tmp_path / "ckpt"))
    assert resumed.restore_latest() and resumed.round_rhos == [fed.privacy(3).rho]


def test_parallel_dp_submitters_with_one_parent_seed_reveal_the_same_sums(tmp_path):
    sums = []
    for run in range(2):
        fed, sharing = _dp_fed(11)
        revealed = _recorded_reveals(fed)
        deployment = Deployment(tmp_path / str(run), "port")
        participants = [(deployment.participant(), lambda m, i=i: {"w": np.full(4, 0.1 * i)})
                        for i in range(3)]
        trainer = FederatedTrainer(fed, {"w": np.zeros(4)})
        for _ in range(2):
            trainer.run_round(deployment.recipient, deployment.rkey, sharing, participants,
                              _workers(deployment), parallel_submit=3)
        sums.append(revealed)
    assert len(sums[0]) == 2
    for first, second in zip(*sums):
        np.testing.assert_array_equal(first, second)
    assert not np.array_equal(sums[0][0], sums[0][1])  # the parent moved on
