"""A closed loop of sum-first aggregates (``parallel/sumfirst.py``).

Each aggregate streams ``participants / chunk`` chunks of ``chunk x dim``
secrets, uniform in ``[0, 2^secret_bits)`` and handed as ``(hi, lo)`` int32
words, through ``value_limb_sums_chunk_pair``; the port draws the Shamir
randomness itself (``ops/rng.py``). The host epilogue then forms the clerk
sums (``clerk_sums_from_limb_acc``) and reveals the ``(dim,)`` aggregate
from the clerks that remain after ``dropped_clerks`` leave.

The chunks come from a pool of ``pool_chunks`` distinct chunks drawn on the
card at set-up, each far larger than the 50 MB L2 cache; every aggregate
takes its chunks from the pool in an order drawn from the seed, so every
seed does the same work on other data. The reference sums the pool chunks
itself and weighs them by how often each aggregate took them. The share
randomness cancels in the reveal, so every aggregate's clerk sums are kept
too: from them the reference works out the summed randomness and the
dropped clerk's sum (``reference/shamir.py``).

Traffic keys: ``chunk``, ``pool_chunks``, ``secret_bits``, ``dropped_clerks``,
``warm_chunks``, ``trace_units``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from sdabench import least_time
from sdabench.inputs import clerks_of, scheme_of, seeds
from sdabench.record import Run, Unit


class Program:
    """The system under test: the port's sum-first entries."""

    def __init__(self, scheme, dim: int, clerks: list, device, generator):
        from sda_tpu_torch.parallel import engine

        self.scheme, self.dim, self.clerks = scheme, dim, clerks
        self.plan = engine.make_plan(scheme, dim, device)
        self.generator = generator
        self.nbits = scheme.prime_modulus.bit_length() - 1

    def zeros(self) -> torch.Tensor:
        from sda_tpu_torch.parallel import sumfirst

        plan = self.plan
        return torch.zeros((sumfirst.limb_count_sum(plan.modulus), plan.n_batches,
                            plan.input_size + plan.rand_size), dtype=torch.int64, device=plan.device)

    def _draw(self, generator, shape):
        from sda_tpu_torch.ops import rng

        return rng.uniform_bits_device_pair(generator, shape, self.nbits)

    def chunk(self, acc, hi, lo):
        from sda_tpu_torch.parallel import sumfirst

        return acc + sumfirst.value_limb_sums_chunk_pair(hi, lo, self.generator, self.plan, self._draw)

    def reveal(self, acc) -> tuple[np.ndarray, np.ndarray]:
        """The ``(dim,)`` aggregate and the ``(n, nb)`` clerk sums it was
        reconstructed from."""
        from sda_tpu_torch.ops.modular import positive
        from sda_tpu_torch.parallel import sumfirst

        clerk_sums, _ = sumfirst.clerk_sums_from_limb_acc(acc, self.plan)
        got = sumfirst.reconstruct_from_clerk_sums(clerk_sums, self.clerks, self.scheme, self.dim)
        return positive(np.asarray(got, dtype=np.int64), self.scheme.prime_modulus), clerk_sums


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, reference, program=None):
        self.dim = config["dim"]
        self.participants = config["participants"]
        self.chunk = traffic["chunk"]
        if self.participants % self.chunk:
            raise ValueError(f"{self.participants} participants do not split into chunks of {self.chunk}")
        self.chunks = self.participants // self.chunk
        bits = traffic["secret_bits"]
        p = config["scheme"]["prime_modulus"]
        if not 32 < bits < p.bit_length():
            raise ValueError(f"secret_bits {bits} must lie in (32, {p.bit_length()})")
        self.p = p
        self.device = torch.device(device)
        self.tracer, self.reference, self.traffic = tracer, reference, traffic
        pool_seed, order_seed, program_seed = seeds(seed, 3)
        self.scheme = config["scheme"]
        scheme = scheme_of(config)
        self.clerks = clerks = clerks_of(config, traffic["dropped_clerks"])
        generator = torch.Generator(device=self.device).manual_seed(program_seed)
        self.program = program or Program(scheme, self.dim, clerks, self.device, generator)
        pool = torch.Generator(device=self.device).manual_seed(pool_seed)
        shape = (traffic["pool_chunks"], self.chunk, self.dim)
        self.hi = torch.randint(0, 1 << (bits - 32), shape, generator=pool, dtype=torch.int32,
                                device=self.device)
        self.lo = torch.randint(-(1 << 31), 1 << 31, shape, generator=pool, dtype=torch.int32,
                                device=self.device)
        self.order = np.random.default_rng(order_seed)
        self.orders: list = []
        self.revealed: list = []
        self.clerk_sums: list = []

    def warm(self) -> None:
        self._aggregate(np.arange(self.traffic["warm_chunks"]) % self.traffic["pool_chunks"], None)
        self.tracer.collect(Run())  # the warm-up's sections are not the window's

    def window(self, seconds: float) -> Run:
        run = Run()
        tracer = self.tracer
        least = least_time.sumfirst_aggregate_s(self.participants, self.dim, 8)
        longest = 0.0
        traced = self.traffic["trace_units"]
        if traced:
            tracer.start()  # before the window's clock: the profiler's own start is not a unit's
        start = time.perf_counter()
        while not run.units or time.perf_counter() - start + longest <= seconds:
            i = len(run.units)
            if i < traced:
                tracer.add_unit(i)
            order = self.order.integers(0, self.traffic["pool_chunks"], size=self.chunks)
            t0 = time.perf_counter()
            revealed, clerk_sums = self._aggregate(order, run)
            wall = time.perf_counter() - t0
            if i + 1 == traced:
                tracer.stop()
            tracer.collect(run)
            longest = max(longest, wall)
            run.units.append(Unit(wall_s=wall, elems=self.participants * self.dim, least_s=least))
            self.orders.append(order)
            self.revealed.append(revealed)
            self.clerk_sums.append(clerk_sums)
        run.window_s = time.perf_counter() - start
        tracer.stop()
        return run

    def _aggregate(self, order, run: Run | None) -> tuple:
        """One aggregate over the pool chunks ``order``: ``(revealed,
        clerk_sums)``; with ``run``, the epilogue's host seconds go to
        ``run.host_s``."""
        tracer = self.tracer
        acc = self.program.zeros()
        for j in order:
            with tracer.span("chunk"), tracer.timed("chunk"):
                acc = self.program.chunk(acc, self.hi[j], self.lo[j])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        f0 = time.perf_counter()
        with tracer.span("finalize"):
            revealed = self.program.reveal(acc)
        if run is not None:
            run.host_s.setdefault("finalize", []).append(time.perf_counter() - f0)
        return revealed

    def release(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """Every revealed aggregate against the reference: the count of
        columns that differ, over all aggregates (limit 0: exact); and every
        aggregate's sharing (``reference/shamir.py``)."""
        sums = self.reference.pool_sums(self.hi, self.lo)
        mismatches = failed = 0
        for order, got in zip(self.orders, self.revealed):
            want = self.reference.aggregate(sums, order, self.p)
            bad = int(np.count_nonzero(np.asarray(got, dtype=object) != want))
            mismatches += bad
            failed += bad > 0
        checks = {"aggregate_mismatches": (mismatches, 0)}
        checks.update(self.reference.sharing_checks(self.clerk_sums, self.scheme, self.clerks))
        return checks, failed
