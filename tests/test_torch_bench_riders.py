"""The protocol-plane riders of ``python -m sda_tpu_torch.bench`` against
``bench.py``'s, on the CPU at the smallest knobs.

Each rider runs in the port (``sda_tpu_torch.riders``, its clients on
``device="cpu"``) and in the reference (the repo's ``bench.py`` loaded by
path, ``SDA_BENCH_ARTIFACTS=0``), once each, under the same knobs
(``KNOBS``) and the same seeded stream of protocol ids (``TypedId.random``
in both packages draws from ``random.Random(ID_SEED)``: the routing of
participants to tier nodes and of requests to shards hashes those ids).
The two results are held to:

- **the schema**: the same nested keys, less the reference's baseline keys
  (``BASELINE_KEYS``: rates of the reference's own earlier host runs, which
  the port does not carry) and plus the port's own (``PORT_KEYS``: the
  native layer's thread count beside each committee config's workers);
- **exactness**: every exactness flag true in both (the riders raise on a
  reveal that differs from the plain modular sum, so a returned result is
  an exact one);
- **equal deterministic quantities** (``EQUAL``, by rider): sizes and
  counts (participants, aggregations, clerks, workers swept, chunk sizes,
  rows read, frontends), the replication legs' reveals, the tier legs' node
  counts, clerk jobs, largest job and stage observation counts, the
  promotion legs' node and observation counts, the shard legs' request
  counts per shard, and every sketch leg's dimension, total, errors, bound
  and headroom;
- **payload bytes within 1 %** (``BYTES_WITHIN``): the wire legs' byte
  counts by format and direction carry random shares and masks, whose
  varint and decimal lengths vary from run to run in either package (by
  a few bytes in 10^4 at these knobs).

Not held equal: rates, seconds, ratios of rates, peak RSS, the overlap
gauges, verdict strings, and ``native_ext`` (the reference's C extension is
not built on this host; the port's native layer is, and must report so).
Rates are held positive in both. The rest of the file holds the bench's
wiring: a rider that raises leaves an error entry and the device line,
``SDA_BENCH_RIDERS=0`` skips the nine, nothing lands in ``bench-artifacts/``.
"""

import contextlib
import fnmatch
import importlib.util
import json
import os
import random
import subprocess
import sys
import types
import uuid
from pathlib import Path

import pytest

import sda_tpu.protocol.ids as reference_ids
from sda_tpu.ops.jaxcfg import sync_platform_to_env
from sda_tpu_torch import bench, native, riders
from sda_tpu_torch.protocol import ids as port_ids

ROOT = Path(__file__).resolve().parent.parent
ID_SEED = 7
KNOBS = {
    "SDA_BENCH_ARTIFACTS": "0",
    "SDA_BENCH_WIRE_N": "40",
    "SDA_BENCH_CLERKING_N": "40",
    "SDA_BENCH_REVEAL_N": "40",
    "SDA_BENCH_COMMITTEE_N": "40",
    "SDA_BENCH_SHARD_N": "16",
    "SDA_BENCH_REPLICATION_N": "12",
    "SDA_BENCH_TIER_N": "8",
    "SDA_BENCH_TIER_REPS": "1",
    "SDA_BENCH_TIER_AB_DIM": "16",
    "SDA_BENCH_TIER_AB_N": "4",
    "SDA_BENCH_TIER_AB_REPS": "1",
}
#: bench.py's keys built on its own earlier host rates (``R5_INGEST_BASELINES``
#: and the wire rider's ``json_baseline_per_s``): in its result dicts, the
#: wire rider's two; the other three sit on its stdout lines and artifacts
BASELINE_KEYS = ("vs_r5_baseline", "r5_seal_batch_vs_scalar", "baselines_r5",
                 "json_baseline_per_s", "ingest_binary_vs_baseline")
PORT_KEYS = {"committee": ("planes.*.*.native_threads",)}
#: key -> (reference function, port function, takes the clients' device)
RIDERS = {
    "crypto_plane": ("measure_crypto_plane", riders.measure_crypto_plane, False),
    "rest_ingest": ("measure_rest_ingest", riders.measure_rest_ingest, False),
    "ingest": ("measure_batched_ingest", riders.measure_batched_ingest, True),
    "wire": ("measure_wire_transport", riders.measure_wire_transport, True),
    "clerking": ("measure_clerking_pipeline", riders.measure_clerking_pipeline, True),
    "reveal": ("measure_reveal_pipeline", riders.measure_reveal_pipeline, True),
    "committee": ("measure_committee_scaling", riders.measure_committee_scaling, True),
    "shard": ("measure_shard_scaling", riders.measure_shard_scaling, True),
    "replication": ("measure_replication_overhead", riders.measure_replication_overhead, True),
    "tier": ("measure_tier_fanout", riders.measure_tier_fanout, True),
    "sketch": ("measure_sketch_accuracy", riders.measure_sketch_accuracy, True),
}
EQUAL = {
    "crypto_plane": (),
    "rest_ingest": (),
    "ingest": (),
    "wire": ("n_participants", "chunk_size", "store"),
    "clerking": ("n_participants", "clerks", "configs.*.chunk_size"),
    "reveal": ("n_participants", "clerks", "configs.*.chunk_size", "configs.*.n_participants"),
    "committee": ("n_participants", "clerks", "cpu_count", "workers_swept", "planes.*.*.workers",
                  "read_pool.*.threads", "read_pool.*.rows_read"),
    "shard": ("n_participations", "n_aggregations", "uploader_threads", "store", "host_cpus",
              "legs.*.frontends", "legs.*.shard_requests.*", "multi_core_host"),
    "replication": ("n_participations", "n_aggregations", "shards", "store", "host_cpus",
                    "legs.*.replicas", "legs.*.reveal", "multi_core_host"),
    "tier": ("n_participants", "configs.*.fanout", "configs.*.reps", "configs.*.nodes",
             "configs.*.clerk_jobs", "configs.*.max_job_participations",
             "configs.*.vs_flat_max_job", "configs.*.stages.*.observations",
             "promotion_ab.*.reps", "promotion_ab.*.dim", "promotion_ab.*.n_participants",
             "promotion_ab.*.promoted_nodes", "promotion_ab.*.promote_observations"),
    "sketch": ("families.*.legs.*.dim", "families.*.legs.*.width", "families.*.legs.*.depth",
               "families.*.legs.*.total", "families.*.legs.*.true", "families.*.legs.*.max_err",
               "families.*.legs.*.abs_err", "families.*.legs.*.estimate",
               "families.*.legs.*.bound", "families.*.legs.*.within_bound",
               "families.*.legs.*.bound_headroom"),
}
BYTES_WITHIN = {"wire": ("*.bytes_*",)}
EXACT_FLAGS = ("exact", "reveals_exact", "identical_reveals", "identical_to_serial", "byte_exact")
#: riders whose results carry exactness flags, and how many (at ``KNOBS``)
FLAG_COUNTS = {"committee": 12, "shard": 3, "replication": 3, "tier": 6, "sketch": 6}


def load_reference_bench():
    sync_platform_to_env()
    spec = importlib.util.spec_from_file_location("reference_bench", ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def seeded_ids(seed: int):
    """Both packages' ``TypedId.random`` from one seeded stream each."""
    saved = reference_ids.uuid, port_ids.uuid
    try:
        for module in (reference_ids, port_ids):
            draw = random.Random(seed)
            module.uuid = types.SimpleNamespace(
                uuid4=lambda draw=draw: uuid.UUID(int=draw.getrandbits(128), version=4),
                UUID=uuid.UUID, SafeUUID=uuid.SafeUUID)
        yield
    finally:
        reference_ids.uuid, port_ids.uuid = saved


def leaves(tree, path=""):
    """``{dotted path: value}`` of every non-dict leaf."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for key, value in tree.items():
        out.update(leaves(value, f"{path}.{key}" if path else str(key)))
    return out


def key_paths(tree, path="") -> set:
    out = set()
    if isinstance(tree, dict):
        for key, value in tree.items():
            here = f"{path}.{key}" if path else str(key)
            out |= {here} | key_paths(value, here)
    return out


def _matching(paths, patterns) -> list:
    return sorted(p for p in paths if any(fnmatch.fnmatchcase(p, pat) for pat in patterns))


class RiderRuns:
    """Each rider run once per package, on first use, under ``KNOBS``."""

    def __init__(self):
        self.reference = None
        self.results = {}

    def __call__(self, key: str):
        if key not in self.results:
            if self.reference is None:
                self.reference = load_reference_bench()
            name, port_fn, takes_device = RIDERS[key]
            with pytest.MonkeyPatch.context() as mp:
                for knob, value in KNOBS.items():
                    mp.setenv(knob, value)
                with seeded_ids(ID_SEED):
                    ours = port_fn(device="cpu") if takes_device else port_fn()
                with seeded_ids(ID_SEED):
                    theirs = getattr(self.reference, name)()
            self.results[key] = ours, theirs
        return self.results[key]


@pytest.fixture(scope="module")
def runs():
    return RiderRuns()


def check_schema(key, ours, theirs):
    port_only = set(_matching(key_paths(ours), PORT_KEYS.get(key, ())))
    assert port_only or key not in PORT_KEYS
    reference = {p for p in key_paths(theirs) if p.split(".")[-1] not in BASELINE_KEYS}
    assert key_paths(ours) - port_only == reference


def check_exact(key, ours, theirs):
    for result in (ours, theirs):
        flags = [v for p, v in leaves(result).items() if p.split(".")[-1] in EXACT_FLAGS]
        assert len(flags) == FLAG_COUNTS.get(key, 0)
        assert all(flag is True for flag in flags)


def check_equal(key, ours, theirs):
    mine, ref = leaves(ours), leaves(theirs)
    paths = _matching(ref, EQUAL[key])
    assert bool(paths) == bool(EQUAL[key])
    for path in paths:
        assert mine[path] == ref[path], path
    within = _matching(ref, BYTES_WITHIN.get(key, ()))
    assert bool(within) == bool(BYTES_WITHIN.get(key))
    for path in within:
        assert abs(mine[path] - ref[path]) <= 0.01 * ref[path], path


def check_rates(key, ours, theirs):
    for result in (ours, theirs):
        for path, value in leaves(result).items():
            if path.endswith("per_s") and path.split(".")[-1] not in BASELINE_KEYS:
                assert isinstance(value, (int, float)) and value > 0, (path, value)
            elif path.endswith("_s") and path.split(".")[-1] != "json_baseline_per_s":
                assert isinstance(value, (int, float)) and value >= 0, (path, value)


CHECKS = {"schema": check_schema, "exact": check_exact, "equal": check_equal, "rates": check_rates}
HERE = ("crypto_plane", "rest_ingest", "ingest", "committee", "replication", "sketch")


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("key", HERE)
def test_rider_against_reference(runs, key, check):
    """The port's rider against bench.py's: ``check`` as the module
    docstring says."""
    CHECKS[check](key, *runs(key))


@pytest.mark.parametrize("key", ("crypto_plane", "ingest"))
def test_native_layer_reported(runs, key):
    """The port's host planes ride its own native layer, and say so."""
    ours, _ = runs(key)
    assert ours["native_ext"] is True


def test_committee_records_both_pools(runs):
    """Every committee config records the Python pool's workers and the
    native layer's threads, which the sweep does not change."""
    ours, _ = runs("committee")
    configs = [c for plane in ours["planes"].values() for c in plane.values()]
    assert len(configs) == 3 * len(ours["workers_swept"])
    assert {c["native_threads"] for c in configs} == {native._default_threads()}
    assert [c["workers"] for c in ours["planes"]["ingest"].values()] == ours["workers_swept"]


# -- the bench's wiring ---------------------------------------------------------

TINY = ["--device", "cpu", "--participants", "400", "--dim", "30", "--chunk", "100", "--no-parity"]


@pytest.fixture
def stub_riders(monkeypatch):
    """Both rider lists replaced by stubs that record their calls; the
    ``wire`` stub raises."""
    calls = []

    def stub(key, result=None, fail=False):
        def rider(device=None):
            calls.append((key, device))
            if fail:
                raise RuntimeError(f"{key} failed on purpose")
            return result if result is not None else {"n": 1}
        return key, f"{key} stub", rider

    monkeypatch.setattr(riders, "HOST_PLANES", (stub("crypto_plane", {"seals_per_s": 5}),
                                                stub("rest_ingest", {"participations_per_s": 7})))
    monkeypatch.setattr(riders, "RIDERS", tuple(
        stub(key, fail=key == "wire") for key in ("ingest", "wire", "clerking", "reveal", "committee",
                                                  "shard", "replication", "tier", "sketch")))
    monkeypatch.delenv("SDA_BENCH_RIDERS", raising=False)
    return calls


def test_failing_rider_keeps_the_device_line(stub_riders, capsys):
    """A rider that raises leaves ``{"error": "<Type>: <message>"}`` under its
    key and its traceback on stderr; the others and the device run go on,
    and the verified line carries every entry under ``crypto``."""
    assert bench.main(TINY) == 0
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["verified"] is True and line["trace_id"] == riders.RUN_TRACE_ID
    crypto = line["crypto"]
    assert crypto["wire"] == {"error": "RuntimeError: wire failed on purpose"}
    assert crypto["seals_per_s"] == 5 and crypto["participations_per_s"] == 7
    assert all(crypto[key] == {"n": 1} for key in ("ingest", "clerking", "sketch"))
    assert [key for key, entry in crypto.items() if isinstance(entry, dict) and "error" in entry] \
        == ["wire"]
    assert "Traceback" in captured.err and "wire failed on purpose" in captured.err
    assert [key for key, _ in stub_riders][2:] == [key for key, _, _ in riders.RIDERS]
    assert {device for key, device in stub_riders[2:]} == {"cpu"}
    assert set(line["riders"]["seconds"]) == {key for key, _ in stub_riders}
    assert not any(line["riders"]["cuda_initialized_after"].values())


def test_error_line_carries_the_riders(stub_riders, monkeypatch, capsys):
    """When the device run fails, the error line carries the host planes."""
    def broken(*args, **kwargs):
        raise RuntimeError("device run broke")

    monkeypatch.setattr(bench, "run", broken)
    assert bench.main(TINY) == 2
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["error"] == "RuntimeError: device run broke" and line["value"] == 0
    assert line["crypto"]["seals_per_s"] == 5 and "error" in line["crypto"]["wire"]


def test_riders_zero_runs_only_the_host_planes(stub_riders, monkeypatch, capsys):
    """``SDA_BENCH_RIDERS=0`` skips the nine riders, not the two host planes."""
    monkeypatch.setenv("SDA_BENCH_RIDERS", "0")
    assert bench.main(TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [key for key, _ in stub_riders] == ["crypto_plane", "rest_ingest"]
    assert set(line["crypto"]) == {"seals_per_s", "participations_per_s"}


def test_no_gpu_fails_before_the_riders(stub_riders, capsys):
    """Without a GPU and without ``--device cpu`` the bench exits 2 at once."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the behaviour without one")
    assert bench.main(["--quick", "--no-parity"]) == 2
    assert stub_riders == []
    assert "no CUDA device" in json.loads(capsys.readouterr().out.strip().splitlines()[-1])["error"]


def test_cli_line_carries_the_host_planes():
    """The command line with ``SDA_BENCH_RIDERS=0``: one stdout line, the
    host planes' rates under ``crypto``, the run's trace id."""
    env = {**os.environ, "SDA_BENCH_RIDERS": "0", "SDA_BENCH_ARTIFACTS": "0"}
    out = subprocess.run([sys.executable, "-m", "sda_tpu_torch.bench", *TINY], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["verified"] and len(line["trace_id"]) == 32
    assert line["crypto"]["native_ext"] is True and line["crypto"]["participations_per_s"] > 0
    assert set(line["riders"]["seconds"]) == {"crypto_plane", "rest_ingest"}


def _files(directory: Path) -> list:
    return sorted(p.relative_to(directory).as_posix() for p in directory.rglob("*")) \
        if directory.exists() else []


def test_artifacts_never_land_in_bench_artifacts(tmp_path, monkeypatch):
    """The riders bank into their own directory (``bench-artifacts-torch/``
    by default, ``--artifacts`` elsewhere), never the earlier benchmark's
    ``bench-artifacts/``; ``SDA_BENCH_ARTIFACTS=0`` banks nothing."""
    assert riders.ARTIFACTS_DIR == ROOT / "bench-artifacts-torch"
    earlier = _files(ROOT / "bench-artifacts")
    default = _files(ROOT / "bench-artifacts-torch")
    monkeypatch.setattr(riders._common, "ARTIFACTS_DIR", riders.ARTIFACTS_DIR)
    monkeypatch.setenv("SDA_BENCH_REPLICATION_N", "6")
    monkeypatch.delenv("SDA_BENCH_ARTIFACTS", raising=False)
    riders.set_artifacts_dir(tmp_path / "banked")
    riders.measure_replication_overhead(device="cpu")
    assert [name.split("-", 1)[0] for name in _files(tmp_path / "banked")] == ["replication"]
    monkeypatch.setenv("SDA_BENCH_ARTIFACTS", "0")
    riders.set_artifacts_dir(tmp_path / "none")
    riders.measure_replication_overhead(device="cpu")
    assert not (tmp_path / "none").exists()
    assert _files(ROOT / "bench-artifacts") == earlier
    assert _files(ROOT / "bench-artifacts-torch") == default


def test_bench_reexports_the_riders():
    """``bench.measure_*`` resolves as in bench.py."""
    for name, fn, _ in RIDERS.values():
        assert getattr(bench, name) is fn


def test_sdad_imports_no_torch():
    """The shard rider's frontends are ``sdad`` processes: the daemon and
    its stores load no torch (its import and libraries cost each frontend
    seconds and gigabytes on the card's host), and the server's modulus
    bound is the field math's."""
    code = ("import sys, sda_tpu_torch.cli.sdad, sda_tpu_torch.server.sqlstore, "
            "sda_tpu_torch.server.sharded; print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "False", out.stderr
    from sda_tpu_torch.ops.modular import WIDE_MAX_MODULUS
    from sda_tpu_torch.server import service

    assert service.WIDE_MAX_MODULUS == WIDE_MAX_MODULUS
