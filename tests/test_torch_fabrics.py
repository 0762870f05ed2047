"""The port's sharded fabrics over ``torch.distributed`` against the reference's
fabrics on the CPU.

Each mesh layout runs once in gloo ranks (``multihost.spawn_ranks``, one
process per rank, batched into one spawn per layout by a module fixture):
``p=4 d=2``, ``p=8`` (the all-to-all, n = 8 clerks) and the hybrid ``h=2
p=2 d=2``. Every rank draws the same global inputs and takes its block by
mesh coordinate. The gathered results are held, exactly, against:

- the reference's fabric on the 8 virtual CPU devices of tests/conftest.py
  (revealed aggregates, randomness-independent);
- the reference's single-device functions over all rows, with injected
  randomness: each rank's draw hook returns its block of one host array,
  the reference's ``draw=`` the whole array (clerk sums, limb
  accumulators, sum-first limb sums).

jax is imported only inside test bodies, so the spawned ranks, which import
this module to find their functions, never load it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sda_tpu_torch.parallel.multihost import spawn_ranks

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
P_TOTAL = 32


def _schemes():
    """name -> (port scheme, reference constructor args, dim): p = 433, the
    bench's 31-bit field, a 61-bit field."""
    from sda_tpu_torch.ops import find_packed_parameters

    p31, a31, b31 = find_packed_parameters(5, 2, 8, min_modulus_bits=30, seed=0)
    p61, a61, b61 = find_packed_parameters(3, 4, 8, min_modulus_bits=60, seed=1)
    return {
        "p433": ((3, 8, 4, 433, 354, 150), 24),
        "bench31": ((5, 8, 2, p31, a31, b31), 20),
        "wide61": ((3, 8, 4, p61, a61, b61), 24),
    }


def _inputs():
    """Global secrets and share randomness per scheme, from one seed."""
    rng = np.random.default_rng(17)
    out = {}
    for name, ((k, n, t, p, _, _), dim) in _schemes().items():
        low = p - 5_000 if p > (1 << 31) else 0
        secrets = rng.integers(low, p, size=(P_TOTAL, dim)).astype(np.int64)
        rand = rng.integers(0, p, size=(P_TOTAL, dim // k, t)).astype(np.int64)
        out[name] = (secrets, rand)
    return out


def _port_scheme(name):
    from sda_tpu_torch.protocol import PackedShamirSharing

    args, dim = _schemes()[name]
    return PackedShamirSharing(*args), dim


def _ref_scheme(name):
    from sda_tpu.protocol import PackedShamirSharing

    args, dim = _schemes()[name]
    return PackedShamirSharing(*args), dim


def _block_draw(rand, mesh, row_axes):
    """This rank's block of the global (P, nb, t) randomness as a draw hook."""
    from sda_tpu_torch.parallel.mesh import shard_block

    P, nb, t = rand.shape
    block = shard_block(rand.reshape(P, nb * t), mesh, row_axes)
    block = block.reshape(block.shape[0], -1, t)

    def draw(generator, shape, p):
        assert tuple(shape) == tuple(block.shape), (shape, block.shape)
        return block

    return draw


# -- rank bodies (run in the spawned gloo ranks) ------------------------------


def _rank_mesh42(rank, world, inputs):
    from sda_tpu_torch.parallel import (
        TorchAggregator,
        full_training_step,
        make_mesh,
        make_plan,
        shard_participants,
        sharded_value_limb_sums,
    )
    from sda_tpu_torch.parallel import engine as teng
    from sda_tpu_torch.parallel.mesh import coordinate, gather_over
    from sda_tpu_torch.parallel.sumfirst import MAX_PARTICIPANTS

    mesh = make_mesh(p_size=4, d_size=2, device=CPU)
    out = {"coords": (coordinate(mesh, "p"), coordinate(mesh, "d"))}
    scheme, dim = _port_scheme("p433")
    secrets, rand = inputs["p433"]
    local = shard_participants(secrets, mesh)

    _, step = full_training_step(scheme, dim, mesh)
    agg, plain = step(local, 3)
    out["aggregate"], out["plain"] = agg.numpy(), plain.numpy()

    sums = TorchAggregator(scheme, dim, mesh=mesh).sharded_clerk_sums()(
        local, 0, draw=_block_draw(rand, mesh, ("p",)))
    out["clerk_sums"] = gather_over(sums, mesh, "d", dim=1).numpy()

    for name in ("bench31", "wide61"):
        sch, d = _port_scheme(name)
        sec, rnd = inputs[name]
        fn = TorchAggregator(sch, d, mesh=mesh).sharded_limb_accumulators()
        acc = fn(shard_participants(sec, mesh), 0, draw=_block_draw(rnd, mesh, ("p",)))
        out[f"limb_{name}"] = gather_over(acc, mesh, "d", dim=1).numpy()
        acc = fn(shard_participants(sec, mesh), 5)
        out[f"limb_{name}_own_draws"] = gather_over(acc, mesh, "d", dim=1).numpy()

    plan = make_plan(scheme, dim, CPU)
    sf = sharded_value_limb_sums(plan, mesh)
    acc = sf(local, 0, draw=_block_draw(rand, mesh, ("p",)))
    out["sumfirst"] = gather_over(acc, mesh, "d", dim=1).numpy()
    out["sumfirst_own_draws"] = gather_over(sf(local, 4), mesh, "d", dim=1).numpy()

    # the generator each rank derives, and the randomness the fabric's
    # default draw gave this rank's first participant row
    gen = teng.fold_mesh_axes(0, mesh)
    out["stream"] = torch.randint(0, 1 << 31, (8,), generator=gen).numpy()
    seen = []

    def recording_draw(generator, shape, p):
        seen.append(teng._device_randomness(generator, shape, p))
        return seen[-1]

    TorchAggregator(scheme, dim, mesh=mesh).sharded_clerk_sums()(local, 0, draw=recording_draw)
    out["row0_randomness"] = seen[0][0].numpy()

    guards = {}
    for label, build in (
        ("engine", lambda: TorchAggregator(scheme, 26, mesh=mesh).sharded_clerk_sums()),
        ("limb", lambda: TorchAggregator(scheme, 26, mesh=mesh).sharded_limb_accumulators()),
        ("sumfirst", lambda: sharded_value_limb_sums(make_plan(scheme, 26, CPU), mesh)),
    ):
        try:
            build()
            guards[label] = "no error"
        except ValueError as exc:
            guards[label] = str(exc)

    class FakeShaped:
        shape = (MAX_PARTICIPANTS // 4 + 1, 12)

    try:
        sf(FakeShaped(), 0)
        guards["global"] = "no error"
    except ValueError as exc:
        guards["global"] = str(exc)
    out["guards"] = guards
    out["fabric_calls"] = teng.fabric_calls()
    out["fabric_bytes"] = teng.fabric_bytes()
    return out


def _rank_a2a(rank, world, inputs):
    from sda_tpu_torch.parallel import TorchAggregator, make_mesh, shard_participants
    from sda_tpu_torch.parallel.engine import reconstruct
    from sda_tpu_torch.parallel.mesh import gather_over

    mesh = make_mesh(p_size=8, d_size=1, device=CPU)
    scheme, dim = _port_scheme("p433")
    secrets, rand = inputs["p433"]
    fn = TorchAggregator(scheme, dim, mesh=mesh).sharded_clerk_sums_all_to_all()
    local = shard_participants(secrets, mesh)
    out = {"local_shape": tuple(fn(local, 1).shape)}
    sums = gather_over(fn(local, 0, draw=_block_draw(rand, mesh, ("p",))), mesh, "p", dim=0)
    out["clerk_sums"] = sums.numpy()
    sums = gather_over(fn(local, 11), mesh, "p", dim=0).clone()
    sums[1] = -7  # the dropped clerk's row is never read
    survivors = [0, 2, 3, 4, 5, 6, 7]
    out["dropout_aggregate"] = reconstruct(sums, survivors, scheme, dim).numpy()
    return out


def _rank_hybrid(rank, world, inputs):
    from sda_tpu_torch.parallel.mesh import coordinate, gather_over
    from sda_tpu_torch.parallel.multihost import (
        hierarchical_clerk_sums,
        hierarchical_limb_accumulators,
        hierarchical_secure_sum,
        make_hybrid_mesh,
        shard_participants_hybrid,
    )

    mesh = make_hybrid_mesh(h_size=2, p_size=2, d_size=2, device=CPU)
    out = {"coords": tuple(coordinate(mesh, a) for a in ("h", "p", "d"))}
    scheme, dim = _port_scheme("p433")
    secrets, rand = inputs["p433"]
    local = shard_participants_hybrid(secrets, mesh)
    _, step = hierarchical_secure_sum(scheme, dim, mesh)
    agg, plain = step(local, 2)
    out["aggregate"], out["plain"] = agg.numpy(), plain.numpy()
    _, fn = hierarchical_clerk_sums(scheme, dim, mesh)
    sums = fn(local, 0, draw=_block_draw(rand, mesh, ("h", "p")))
    out["clerk_sums"] = gather_over(sums, mesh, "d", dim=1).numpy()
    sch, d = _port_scheme("wide61")
    sec, rnd = inputs["wide61"]
    _, fn = hierarchical_limb_accumulators(sch, d, mesh)
    acc = fn(shard_participants_hybrid(sec, mesh), 0, draw=_block_draw(rnd, mesh, ("h", "p")))
    out["limb_wide61"] = gather_over(acc, mesh, "d", dim=1).numpy()

    # two nodes of four ranks: h counts nodes, a miscounting h_size raises
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    try:
        out["nodes_mesh"] = dict(zip(("h", "p", "d"), make_hybrid_mesh(device=CPU).mesh.shape))
        try:
            make_hybrid_mesh(h_size=4, device=CPU)
            out["h_check"] = "no error"
        except ValueError as exc:
            out["h_check"] = str(exc)
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return out


def _rank_fails(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


# -- fixtures: one spawn per layout ---------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def mesh42(inputs):
    return spawn_ranks(_rank_mesh42, 8, CPU, args=(inputs,))


@pytest.fixture(scope="module")
def a2a(inputs):
    return spawn_ranks(_rank_a2a, 8, CPU, args=(inputs,))


@pytest.fixture(scope="module")
def hybrid(inputs):
    return spawn_ranks(_rank_hybrid, 8, CPU, args=(inputs,))


# -- the reference, in process ------------------------------------------------------


def _jax():
    import jax
    import jax.numpy as jnp

    from sda_tpu.ops.jaxcfg import ensure_x64

    ensure_x64()
    return jax, jnp


def _positive(x, p):
    x = np.asarray(x)
    return np.where(x < 0, x + p, x)


def _plain(secrets, p):
    return np.array([sum(int(v) for v in secrets[:, j]) % p for j in range(secrets.shape[1])],
                    dtype=np.int64)


def _ref_single(name, inputs, what):
    """The reference's single-device result over all rows with the global
    randomness injected."""
    jax, jnp = _jax()
    from sda_tpu.parallel import engine as jeng
    from sda_tpu.parallel import sumfirst as jsf

    scheme, dim = _ref_scheme(name)
    secrets, rand = inputs[name]
    plan = jeng.make_plan(scheme, dim)
    draw = lambda key, shape, p: jnp.asarray(rand)  # noqa: E731
    key = jax.random.key(0)
    if what == "clerk_sums":
        shares = jeng.share_participants(jnp.asarray(secrets), key, plan, draw=draw)
        return _positive(np.asarray(jeng.clerk_combine(shares)) % plan.modulus, plan.modulus)
    if what == "limb":
        return np.asarray(jeng.share_combine_limb(jnp.asarray(secrets), key, plan, draw=draw))
    return np.asarray(jsf.value_limb_sums_chunk(jnp.asarray(secrets), key, plan, draw=draw))


def _reveal_limb(acc, name):
    from sda_tpu.parallel.engine import reconstruct
    from sda_tpu.parallel.limbmatmul import limb_recombine_host

    _, jnp = _jax()
    scheme, dim = _ref_scheme(name)
    p = scheme.prime_modulus
    out = reconstruct(jnp.asarray(limb_recombine_host(acc, p).T), range(8), scheme, dim)
    return _positive(np.asarray(out), p)


# -- p=4 d=2 --------------------------------------------------------------------


def test_full_training_step_matches_reference(mesh42, inputs):
    jax, jnp = _jax()
    from sda_tpu.parallel import full_training_step, make_mesh, shard_participants

    scheme, dim = _ref_scheme("p433")
    secrets, _ = inputs["p433"]
    jmesh = make_mesh(p_size=4, d_size=2)
    _, step = full_training_step(scheme, dim, jmesh)
    jout, _ = step(shard_participants(jnp.asarray(secrets), jmesh), jax.random.key(3))
    want = _plain(secrets, 433)
    np.testing.assert_array_equal(_positive(np.asarray(jout), 433), want)
    assert sorted(r["coords"] for r in mesh42) == [(p, d) for p in range(4) for d in range(2)]
    for r in mesh42:
        np.testing.assert_array_equal(_positive(r["aggregate"], 433), want)
        np.testing.assert_array_equal(_positive(r["plain"], 433), want)


def test_sharded_clerk_sums_match_single_device(mesh42, inputs):
    want = _ref_single("p433", inputs, "clerk_sums")
    assert want.shape == (8, 8)
    for r in mesh42:
        np.testing.assert_array_equal(_positive(r["clerk_sums"], 433), want)


@pytest.mark.parametrize("name", ["bench31", "wide61"])
def test_sharded_limb_accumulators_match_reference(mesh42, inputs, name):
    """Injected draws: the accumulators equal the reference's single-device
    share_combine_limb over all rows (the bench scheme through K1's plain
    version); own draws: the reveal equals the reference fabric's."""
    jax, jnp = _jax()
    from sda_tpu.parallel import TpuAggregator, make_mesh, shard_participants

    want = _ref_single(name, inputs, "limb")
    for r in mesh42:
        np.testing.assert_array_equal(r[f"limb_{name}"], want)
    scheme, dim = _ref_scheme(name)
    secrets, _ = inputs[name]
    jmesh = make_mesh(p_size=4, d_size=2)
    jacc = TpuAggregator(scheme, dim, mesh=jmesh).sharded_limb_accumulators()(
        shard_participants(jnp.asarray(secrets), jmesh), jax.random.key(5))
    plain = _plain(secrets, scheme.prime_modulus)
    np.testing.assert_array_equal(_reveal_limb(np.asarray(jacc), name), plain)
    np.testing.assert_array_equal(_reveal_limb(mesh42[0][f"limb_{name}_own_draws"], name), plain)


def test_sharded_value_limb_sums_match_reference(mesh42, inputs):
    jax, jnp = _jax()
    from sda_tpu.parallel import make_mesh, make_plan, shard_participants, sharded_value_limb_sums
    from sda_tpu.parallel.sumfirst import clerk_sums_from_limb_acc, reconstruct_from_clerk_sums

    want = _ref_single("p433", inputs, "sumfirst")
    for r in mesh42:
        np.testing.assert_array_equal(r["sumfirst"], want)
    scheme, dim = _ref_scheme("p433")
    secrets, _ = inputs["p433"]
    jmesh = make_mesh(p_size=4, d_size=2)
    plan = make_plan(scheme, dim)
    jacc = sharded_value_limb_sums(plan, jmesh)(shard_participants(jnp.asarray(secrets), jmesh),
                                                jax.random.key(4))
    plain = _plain(secrets, 433)
    for acc in (np.asarray(jacc), mesh42[0]["sumfirst_own_draws"]):
        clerk, vsum = clerk_sums_from_limb_acc(acc, plan)
        out = reconstruct_from_clerk_sums(clerk, range(8), scheme, dim)
        np.testing.assert_array_equal(_positive(out, 433), plain)
        np.testing.assert_array_equal(vsum[:, :3].reshape(-1), plain)


def test_fold_mesh_axes_distinct_streams(mesh42):
    """8 ranks, 8 distinct generators; the two d-shards of one participant
    row draw different share randomness."""
    assert len({tuple(r["stream"]) for r in mesh42}) == 8
    by_coord = {r["coords"]: r["row0_randomness"] for r in mesh42}
    for p in range(4):
        assert not np.array_equal(by_coord[(p, 0)], by_coord[(p, 1)])
        assert by_coord[(p, 0)].shape == (4, 4)  # (nb_local, t)


def test_sharding_guards_raise(mesh42):
    for r in mesh42:
        for label in ("engine", "limb", "sumfirst"):
            assert "divide over input_size" in r["guards"][label], r["guards"]
        assert "exceeds the exact limb-sum bound" in r["guards"]["global"]


def test_fabric_counters(mesh42):
    calls = mesh42[0]["fabric_calls"]
    assert calls["sharded_clerk_sums"] == 3  # the step's, the injected, the recording
    assert calls["sharded_limb_accumulators"] == 4
    assert calls["sharded_value_limb_sums"] == 2
    # (n, nb_local) int64 result x p
    assert mesh42[0]["fabric_bytes"]["sharded_clerk_sums"] == 3 * 8 * 4 * 8 * 4


def test_check_psum_bound_raises():
    from sda_tpu_torch.parallel.engine import _check_psum_bound

    _check_psum_bound(8, 433, "ok")
    _check_psum_bound(4, (1 << 61) - 1, "ok")
    with pytest.raises(ValueError, match="overflows int64"):
        _check_psum_bound(8, (1 << 61) - 1, "wide")


# -- p=8: the all-to-all ------------------------------------------------------------


def test_all_to_all_matches_single_device(a2a, inputs):
    want = _ref_single("p433", inputs, "clerk_sums")
    for r in a2a:
        assert r["local_shape"] == (1, 8)  # n/p clerks x nb
        np.testing.assert_array_equal(_positive(r["clerk_sums"], 433), want)


def test_all_to_all_dropout_reveal_matches_reference(a2a, inputs):
    jax, jnp = _jax()
    from sda_tpu.parallel import TpuAggregator, make_mesh, shard_participants
    from sda_tpu.parallel.engine import reconstruct

    scheme, dim = _ref_scheme("p433")
    secrets, _ = inputs["p433"]
    jmesh = make_mesh(p_size=8, d_size=1)
    sums = np.array(TpuAggregator(scheme, dim, mesh=jmesh).sharded_clerk_sums_all_to_all()(
        shard_participants(jnp.asarray(secrets), jmesh), jax.random.key(11)))
    sums[1] = -7
    jout = reconstruct(jnp.asarray(sums), [0, 2, 3, 4, 5, 6, 7], scheme, dim)
    want = _plain(secrets, 433)
    np.testing.assert_array_equal(_positive(np.asarray(jout), 433), want)
    for r in a2a:
        np.testing.assert_array_equal(_positive(r["dropout_aggregate"], 433), want)


# -- hybrid h=2 p=2 d=2 ----------------------------------------------------------------


def test_hierarchical_secure_sum_matches_reference(hybrid, inputs):
    jax, jnp = _jax()
    from sda_tpu.parallel.multihost import hierarchical_secure_sum, make_hybrid_mesh, \
        shard_participants_hybrid

    scheme, dim = _ref_scheme("p433")
    secrets, _ = inputs["p433"]
    jmesh = make_hybrid_mesh(h_size=2, p_size=2, d_size=2)
    _, step = hierarchical_secure_sum(scheme, dim, jmesh)
    jout, _ = step(shard_participants_hybrid(jnp.asarray(secrets), jmesh), jax.random.key(2))
    want = _plain(secrets, 433)
    np.testing.assert_array_equal(_positive(np.asarray(jout), 433), want)
    assert sorted(r["coords"] for r in hybrid) == [
        (h, p, d) for h in range(2) for p in range(2) for d in range(2)]
    for r in hybrid:
        np.testing.assert_array_equal(_positive(r["aggregate"], 433), want)
        np.testing.assert_array_equal(_positive(r["plain"], 433), want)


def test_hierarchical_clerk_sums_match_single_device(hybrid, inputs):
    want = _ref_single("p433", inputs, "clerk_sums")
    for r in hybrid:
        np.testing.assert_array_equal(_positive(r["clerk_sums"], 433), want)


def test_hierarchical_limb_accumulators_match_reference(hybrid, inputs):
    jax, jnp = _jax()
    from sda_tpu.parallel.multihost import hierarchical_limb_accumulators, make_hybrid_mesh, \
        shard_participants_hybrid

    want = _ref_single("wide61", inputs, "limb")
    for r in hybrid:
        np.testing.assert_array_equal(r["limb_wide61"], want)
    scheme, dim = _ref_scheme("wide61")
    secrets, _ = inputs["wide61"]
    jmesh = make_hybrid_mesh(h_size=2, p_size=2, d_size=2)
    _, fn = hierarchical_limb_accumulators(scheme, dim, jmesh)
    jacc = fn(shard_participants_hybrid(jnp.asarray(secrets), jmesh), jax.random.key(5))
    np.testing.assert_array_equal(_reveal_limb(np.asarray(jacc), "wide61"),
                                  _plain(secrets, scheme.prime_modulus))


def test_hybrid_mesh_counts_nodes(hybrid):
    for r in hybrid:
        assert r["nodes_mesh"] == {"h": 2, "p": 4, "d": 1}
        assert "must equal the node count (2)" in r["h_check"]


# -- processes, the dry run, and no GPU -------------------------------------------------


def test_spawn_ranks_reraises_a_rank_failure():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn_ranks(_rank_fails, 2, CPU)


def test_dryrun_multichip_all_fabrics_on_cpu():
    """The twin of test_graft_entry_dryrun_all_fabrics: the port's dry run
    over 8 gloo ranks prints every fabric's OK line."""
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_WORLD_SIZE", "LOCAL_RANK")}
    out = subprocess.run(
        [sys.executable, "-m", "sda_tpu_torch.entry", "8", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    for marker in (
        "entry OK",
        "dryrun_multichip OK",
        "dryrun all_to_all fabric OK",
        "dropout reconstruction",
        "dryrun hybrid mesh OK",
        "dryrun wide (61-bit) sharded path OK",
        "dryrun sum-first fabric OK",
        "dryrun chacha masking fabric OK",
    ):
        assert marker in out.stdout, (marker, out.stdout)
    assert "SKIPPED" not in out.stdout


def test_cuda_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    from sda_tpu_torch.entry import dryrun_multichip, entry
    from sda_tpu_torch.parallel.mesh import make_mesh
    from sda_tpu_torch.parallel.multihost import initialize_distributed, make_hybrid_mesh

    for call in (
        lambda: entry(),
        lambda: dryrun_multichip(2),
        lambda: spawn_ranks(_rank_fails, 2),
        lambda: initialize_distributed("file:///nonexistent", 1, 0),
        lambda: make_mesh(1, 1),
        lambda: make_hybrid_mesh(1, 1, 1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
