"""The FedAvg drivers' round half in the port against ``sda_tpu`` on the CPU.

The same seeded updates go through a whole sealed round in each package
(``open_round``, one ``submit_update`` per participant, ``close_round``,
the clerks' chores, ``reveal_field_sum``, ``finish_round``) on each
package's memory server with a recipient and 8 clerks: the revealed field
sums must be identical and the means bit-equal in float64, for the plain
and the weighted driver. The DP drivers' noise is drawn from a
``torch.Generator``, not numpy's stream, so their rounds are held to the
noise's law (the revealed sum less the noise-free sum) and to an
accountant equal to the reference's within 1e-12 relative. Then the
round half's refusals, message for message, and mixed deployments through
the wire JSON: the port's participants in the reference's round, and the
reverse.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import sda_tpu.protocol as jp
import sda_tpu_torch.protocol as tp
from sda_fixtures import new_client as j_client
from sda_tpu.models import DPConfig as JDPConfig
from sda_tpu.models import DPFederatedAveraging as JDPFed
from sda_tpu.models import DPWeightedFederatedAveraging as JDPWeighted
from sda_tpu.models import FederatedAveraging as JFed
from sda_tpu.models import QuantizationSpec as JSpec
from sda_tpu.models import WeightedFederatedAveraging as JWeighted
from sda_tpu.models import flatten_pytree as jflatten
from sda_tpu.server import new_mem_server as j_server
from sda_tpu_torch.client import SdaClient as TClient
from sda_tpu_torch.crypto import Keystore as TKeystore
from sda_tpu_torch.models import (
    DPConfig,
    DPFederatedAveraging,
    DPWeightedFederatedAveraging,
    FederatedAveraging,
    QuantizationSpec,
    WeightedFederatedAveraging,
    flatten_pytree,
)
from sda_tpu_torch.server import new_mem_server as t_server
from test_torch_round import WireBridge

CPU = "cpu"
CLERKS = 8
# keys out of sorted order, as a model's layers come
TEMPLATE = {"dense": {"kernel": np.zeros((6, 4)), "bias": np.zeros(4)},
            "conv": {"k": np.zeros((3, 3, 1, 2))}}


def make_client(package: str, root, service):
    """An agent of ``package`` with its own keystore at ``root``, uploaded
    to ``service``; a port client runs on the CPU."""
    if package == "port":
        keystore = TKeystore(root)
        client = TClient(TClient.new_agent(keystore), keystore, service, device=CPU)
    else:
        client = j_client(root, service)
    client.upload_agent()
    return client


class Deployment:
    """One package's memory server with a recipient and ``CLERKS`` keyed
    clerks, each with its own keystore under ``root``."""

    def __init__(self, root, package: str):
        self.package = package
        self.root = Path(root)
        self.service = t_server() if package == "port" else j_server()
        self._count = 0
        self.recipient = self.client("recipient")
        self.rkey = self.recipient.new_encryption_key()
        self.recipient.upload_encryption_key(self.rkey)
        self.clerks = [self.client(f"clerk{i}") for i in range(CLERKS)]
        for clerk in self.clerks:
            clerk.upload_encryption_key(clerk.new_encryption_key())

    def client(self, name: str):
        return make_client(self.package, self.root / name, self.service)

    def participant(self):
        self._count += 1
        return self.client(f"participant{self._count}")

    def chores(self) -> None:
        for worker in [self.recipient] + self.clerks:
            worker.run_chores(-1)

    def round(self, query, inputs, *, open_args=(), submit=None):
        """Open ``query``'s round, submit each input from a fresh
        participant (``submit(participant, agg, x)``, default
        ``query.submit``), close it and run the chores; returns the id."""
        agg = query.open_round(self.recipient, self.rkey, *open_args)
        submit = query.submit if submit is None else submit
        for x in inputs:
            submit(self.participant(), agg, x)
        query.close_round(self.recipient, agg)
        self.chores()
        return agg


def fedavg_submit(fed):
    return lambda part, agg, x: fed.submit_update(part, agg, *x)


def _updates(seed, count, scale=0.3, clip=None, template=TEMPLATE):
    """``count`` trees shaped as ``template`` (nested dicts of arrays),
    ``scale`` x N(0, 1), clipped to ``clip`` when given."""
    rng = np.random.default_rng(seed)

    def like(node):
        if isinstance(node, dict):
            return {k: like(v) for k, v in node.items()}
        x = scale * rng.standard_normal(np.shape(node))
        return x if clip is None else np.clip(x, -clip, clip)

    return [like(template) for _ in range(count)]


def _assert_trees_equal(got, want):
    flat, treedef, shapes = flatten_pytree(got, CPU)
    jflat, jtreedef, jshapes = jflatten(want)
    assert str(treedef) == str(jtreedef) and shapes == jshapes
    assert np.array_equal(flat.numpy(), jflat)


def _drivers(kind):
    """(port driver, reference driver, port scheme, reference scheme, inputs)."""
    if kind == "plain":
        spec, scheme = QuantizationSpec.fitted(16, 1.0, 5)
        jspec, jscheme = JSpec.fitted(16, 1.0, 5)
        inputs = [(u,) for u in _updates(1, 4)]
        return (FederatedAveraging(spec, TEMPLATE, CPU), JFed(jspec, TEMPLATE), scheme, jscheme, inputs)
    fed, scheme = WeightedFederatedAveraging.fitted(15, 1.0, 600, 5, TEMPLATE, device=CPU)
    jfed, jscheme = JWeighted.fitted(15, 1.0, 600, 5, TEMPLATE)
    inputs = list(zip(_updates(2, 4, clip=1.0), [600, 17, 1.5, 333]))
    return fed, jfed, scheme, jscheme, inputs


@pytest.mark.parametrize("kind", ["plain", "weighted"])
def test_round_reveals_the_reference_sum_and_mean(tmp_path, kind):
    fed, jfed, scheme, jscheme, inputs = _drivers(kind)
    assert fed.spec.modulus == jfed.spec.modulus
    ours, theirs = Deployment(tmp_path / "port", "port"), Deployment(tmp_path / "ref", "ref")
    agg = ours.round(fed, inputs, open_args=(scheme,), submit=fedavg_submit(fed))
    jagg = theirs.round(jfed, inputs, open_args=(jscheme,), submit=fedavg_submit(jfed))
    field_sum = fed.reveal_field_sum(ours.recipient, agg, len(inputs))
    assert field_sum.dtype == torch.int64
    np.testing.assert_array_equal(field_sum.numpy(),
                                  jfed.reveal_field_sum(theirs.recipient, jagg, len(inputs)))
    got = fed.finish_round(ours.recipient, agg, len(inputs))
    want = jfed.finish_round(theirs.recipient, jagg, len(inputs))
    if kind == "weighted":
        (got, total), (want, want_total) = got, want
        assert total == want_total == 951.5
    _assert_trees_equal(got, want)


def _dp_drivers(kind, seed):
    template = {"w": np.zeros(300)}
    if kind == "plain":
        dp = DPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=4)
        spec, scheme = DPFederatedAveraging.fitted_spec(12, dp, 300)
        fed = DPFederatedAveraging(spec, template, dp, torch.Generator().manual_seed(seed), device=CPU)
        jdp = JDPConfig(l2_clip=1.0, noise_multiplier=1.0, expected_participants=4)
        jspec, jscheme = JDPFed.fitted_spec(12, jdp, 300)
        jfed = JDPFed(jspec, template, jdp, rng=np.random.default_rng(seed))
        inputs = [(u,) for u in _updates(3, 4, scale=0.1, template=template)]
        return fed, jfed, scheme, jscheme, inputs
    kw = {"noise_multiplier": 1.0}
    fed, scheme = DPWeightedFederatedAveraging.fitted_dp(
        12, 0.05, 50.0, 4, template, generator=torch.Generator().manual_seed(seed), device=CPU, **kw)
    jfed, jscheme = JDPWeighted.fitted_dp(12, 0.05, 50.0, 4, template,
                                          rng=np.random.default_rng(seed), **kw)
    inputs = list(zip(_updates(4, 4, scale=0.02, clip=0.05, template=template), [50, 7, 12.5, 30]))
    return fed, jfed, scheme, jscheme, inputs


def _clean_sum(jfed, inputs) -> np.ndarray:
    """The noise-free field sum of ``inputs``, by the reference's own steps."""
    from sda_tpu.models.dp import l2_clip_vector

    p = jfed.spec.modulus
    if isinstance(jfed, JDPWeighted):
        rows = [jfed._quantized_wire(u, w) for u, w in inputs]
    else:
        rows = [jfed.spec.quantize(l2_clip_vector(jfed._validated_flat(u), jfed.dp.l2_clip))
                for (u,) in inputs]
    return np.sum(rows, axis=0) % p


@pytest.mark.parametrize("kind", ["plain", "weighted"])
def test_dp_round_holds_the_noise_law_and_the_reference_accountant(tmp_path, kind):
    fed, jfed, scheme, jscheme, inputs = _dp_drivers(kind, seed=5)
    n = len(inputs)
    ours = Deployment(tmp_path, "port")
    agg = ours.round(fed, inputs, open_args=(scheme,), submit=fedavg_submit(fed))
    field_sum = fed.reveal_field_sum(ours.recipient, agg, n).numpy()
    p = fed.spec.modulus
    assert p == jfed.spec.modulus
    # the noise the cohort's sum carries: n parties' discrete Gaussians of
    # sigma_party, a total of sigma_total
    noise = (field_sum - _clean_sum(jfed, inputs)) % p
    noise = np.where(noise > p // 2, noise - p, noise).astype(np.float64)
    account = fed.privacy()
    sigma = account.sigma_total
    assert abs(noise.std() / sigma - 1.0) < 5.0 / np.sqrt(2 * noise.size)
    assert abs(noise.mean()) < 5.0 * sigma / np.sqrt(noise.size)
    assert np.abs(noise).max() < 12.0 * sigma
    # the accountant after the reveal: the reference's at the same cohort
    want = jfed.privacy(n)
    assert account.n_parties == want.n_parties == n
    for field in ("epsilon", "delta", "rho", "sigma_total", "l2_sensitivity"):
        assert getattr(account, field) == pytest.approx(getattr(want, field), rel=1e-12)
    # the mean of the revealed sum is the reference's of the same sum
    got = fed.finish_round(ours.recipient, agg, n)
    from sda_tpu.models import dequantize_mean as jdequantize_mean

    if kind == "plain":
        _assert_trees_equal(got, jdequantize_mean(field_sum, n, jfed.spec, jfed.treedef, jfed.shapes))
    else:
        sums = jfed.spec.dequantize_sum(field_sum)
        mean, total = got
        assert total == float(sums[-1])
        np.testing.assert_array_equal(mean["w"].numpy(), jfed._weighted_flat(sums, float(sums[-1])))


def _refusal(exc_info):
    return str(exc_info.value)


def test_open_round_refuses_another_field(tmp_path):
    fed, jfed, _, _, _ = _drivers("plain")
    other = tp.PackedShamirSharing(3, 8, 4, 433, 354, 150)
    jother = jp.PackedShamirSharing(3, 8, 4, 433, 354, 150)
    ours, theirs = Deployment(tmp_path / "port", "port"), Deployment(tmp_path / "ref", "ref")
    with pytest.raises(ValueError) as err:
        fed.open_round(ours.recipient, ours.rkey, other)
    with pytest.raises(ValueError) as jerr:
        jfed.open_round(theirs.recipient, theirs.rkey, jother)
    assert _refusal(err) == _refusal(jerr) == (
        f"sharing scheme field 433 != quantization field {fed.spec.modulus}")


def test_reveal_refuses_zero_submissions_and_more_than_the_field_holds(tmp_path):
    """Three participations where the field holds two: refused before the
    reveal, by the server's count even when the caller claims two; and a
    zero count, refused as the reference refuses it."""
    messages = []
    for package, driver, qspec in (("port", FederatedAveraging, QuantizationSpec),
                                   ("ref", JFed, JSpec)):
        spec, scheme = qspec.fitted(16, 1.0, 2)
        fed = driver(spec, TEMPLATE, CPU) if package == "port" else driver(spec, TEMPLATE)
        deployment = Deployment(tmp_path / package, package)
        agg = fed.open_round(deployment.recipient, deployment.rkey, scheme)
        for (update,) in [(u,) for u in _updates(6, 3)]:
            fed.submit_update(deployment.participant(), agg, update)
        fed.close_round(deployment.recipient, agg)
        got = []
        for n in (0, 2):
            with pytest.raises(ValueError) as err:
                fed.reveal_field_sum(deployment.recipient, agg, n)
            got.append(_refusal(err))
        messages.append(got)
    assert messages[0] == messages[1]
    assert messages[0][0] == "no updates were submitted; nothing to reveal"
    assert messages[0][1].startswith("3 updates summed but the field only holds 2")


def test_submit_refuses_a_shape_mismatch(tmp_path):
    fed, jfed, scheme, jscheme, _ = _drivers("plain")
    transposed = {"dense": {"kernel": np.zeros((4, 6)), "bias": np.zeros(4)},
                  "conv": {"k": np.zeros((3, 3, 1, 2))}}
    ours, theirs = Deployment(tmp_path / "port", "port"), Deployment(tmp_path / "ref", "ref")
    agg = fed.open_round(ours.recipient, ours.rkey, scheme)
    jagg = jfed.open_round(theirs.recipient, theirs.rkey, jscheme)
    with pytest.raises(ValueError) as err:
        fed.submit_update(ours.participant(), agg, transposed)
    with pytest.raises(ValueError) as jerr:
        jfed.submit_update(theirs.participant(), jagg, transposed)
    assert _refusal(err) == _refusal(jerr)
    assert "differ from template" in _refusal(err)


@pytest.mark.parametrize("layout", ["port participants, reference round",
                                    "reference participants, port round"])
def test_mixed_deployment_through_the_wire(tmp_path, layout):
    """One package's participants submit through the other's server, its
    records crossing as wire JSON; the round reveals the field sum and
    mean of a round held wholly in the reference."""
    fed, jfed, scheme, jscheme, inputs = _drivers("weighted")
    alone = Deployment(tmp_path / "alone", "ref")
    jagg = alone.round(jfed, inputs, open_args=(jscheme,), submit=fedavg_submit(jfed))
    want = jfed.finish_round(alone.recipient, jagg, len(inputs))

    if layout.startswith("port"):
        members, member_fed, member_scheme, part_fed, proto_in, proto_out = (
            "ref", jfed, jscheme, fed, jp, tp)
    else:
        members, member_fed, member_scheme, part_fed, proto_in, proto_out = (
            "port", fed, scheme, jfed, tp, jp)
    deployment = Deployment(tmp_path / "members", members)
    bridge = WireBridge(deployment.service, proto_in, proto_out)
    agg = member_fed.open_round(deployment.recipient, deployment.rkey, member_scheme)
    for i, (update, weight) in enumerate(inputs):
        participant = make_client("ref" if members == "port" else "port",
                                  tmp_path / f"participant{i}", bridge)
        part_fed.submit_update(participant, proto_out.AggregationId(str(agg)), update, weight)
    member_fed.close_round(deployment.recipient, agg)
    deployment.chores()
    got = member_fed.finish_round(deployment.recipient, agg, len(inputs))
    (got_mean, total), (want_mean, want_total) = got, want
    assert total == want_total
    if members == "port":
        _assert_trees_equal(got_mean, want_mean)
    else:
        jflat, _, _ = jflatten(got_mean)
        np.testing.assert_array_equal(jflat, jflatten(want_mean)[0])
