"""A closed loop of DP-FedAvg rounds with distributed discrete Gaussian noise
on the port's engine.

A round takes a cohort of ``cohort`` flat float32 updates and, for each
chunk of ``chunk`` parties, runs the port's DP wire in its two steps:
``DPFederatedAveraging.dp_clip_quantize`` (each row clipped to the L2 clip,
quantized into the DP field) and ``dp_add_noise`` (each row plus its own
party's discrete Gaussian noise of σ_party, mod p). The wires are then
masked, shared and combined, folded, reconstructed and applied as
``fedavg_engine.py`` does it: ``chacha_cuda.expand_seeds_counts`` (K2x),
``engine.share_combine_limb_streamed`` (K1), ``combine_masks_device``,
``limb_recombine``, ``engine.reconstruct`` from the clerks that remain after
``dropped_clerks`` leave, ``dequantize_mean`` and ``fedavg_apply``.

The cohorts come from a pool of ``pool_cohorts`` drawn on the card at
set-up: each update a uniform random direction times a norm drawn
log-uniform in ``norm_over_clip`` times the L2 clip, so about half the rows
are clipped. Each round takes one in an order drawn from the seed, with
seeds drawn from it.

The revealed sums carry fresh noise, so the check holds them to the
reference as a law, not value for value. ``kept_rounds`` rounds sampled
from the seed (a reservoir) keep their field sum and the global model
before and after; the reference takes each round's data sum away from its
revealed sum (the aggregate noise, whose variance must be 100·σ²_party and
which must not repeat from round to round) and applies the revealed sum's mean to the model before. The first
``probed_rounds`` of them also keep, for ``probed_rows`` parties of one chunk
drawn from the seed among those whose update is clipped, the noise-free
rows and the wires (the reference quantizes the rows again exactly, and the
difference is each party's noise), the first party's mask and the clerk
sums (as in ``fedavg_engine.py``). All of it is copied into buffers
allocated at set-up, so the window allocates nothing that it keeps.

Traffic keys: ``cohort``, ``chunk``, ``pool_cohorts``, ``norm_over_clip``,
``global_std``, ``seed_words``, ``dropped_clerks``, ``warm_rounds``,
``trace_units``, ``kept_rounds``, ``probed_rounds``, ``probed_rows``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from sdabench import least_time
from sdabench.inputs import clerks_of, scheme_of, seeds
from sdabench.loops.fedavg_engine import layout, tree_of
from sdabench.record import Run, Unit

#: pools above this many values run on the card only: the cell's own
#: (405M values a cohort) would take this host's memory for minutes
CPU_POOL_LIMIT = 1 << 26

#: the largest gap allowed between a round's new global model and the old
#: one plus the revealed sum's mean, as the reference computes it
GLOBAL_LIMIT = 1e-10


def dp_least_s(participants: int, dim: int) -> float:
    """The DP layer's least time: each float32 update read once and each
    noisy value written once as int32, 8 bytes a coordinate."""
    return least_time.bytes_s(participants * dim * 8)


class Program:
    """The system under test: one round through the port's entries."""

    def __init__(self, config: dict, clerks: list, device, generator, tracer):
        from sda_tpu_torch.models.dp import DPConfig, DPFederatedAveraging
        from sda_tpu_torch.parallel import engine

        if not hasattr(DPFederatedAveraging, "dp_add_noise"):
            raise RuntimeError("the port has no chunk-level DP wire (DPFederatedAveraging.dp_clip_quantize, "
                               "dp_add_noise)")
        d, q = config["dp"], config["quantization"]
        self.dp = DPConfig(l2_clip=d["l2_clip"], noise_multiplier=d["noise_multiplier"],
                           expected_participants=d["expected_participants"], delta=d["delta"],
                           mechanism=d["mechanism"])
        self.dim = config["parameters"]
        # the port sizes the DP field; its roots of unity it draws at random,
        # so the scheme takes the configuration's (drawn with seed 0)
        spec, _ = DPFederatedAveraging.fitted_spec(q["frac_bits"], self.dp, self.dim)
        self.scheme = scheme_of(config)
        if spec.modulus != self.scheme.prime_modulus:
            raise ValueError(f"the port's fitted DP field {spec.modulus} is not the configuration's "
                             f"{self.scheme.prime_modulus}")
        template = tree_of(torch.zeros(self.dim, dtype=torch.float64), layout(config["model"]["layers"]))
        self.fed = DPFederatedAveraging(spec, template, self.dp, generator, device=device)
        self.clerks, self.generator, self.tracer = clerks, generator, tracer
        self.plan = engine.make_plan(self.scheme, self.dim, device)

    @staticmethod
    def launches() -> dict:
        """The port's own counts of its kernels' launches, by kernel name."""
        from sda_tpu_torch.ops import chacha_cuda
        from sda_tpu_torch.parallel import limb_cuda

        return {"chacha20_kernel": chacha_cuda.launches, "limb_share_sum_kernel": limb_cuda.launches}

    def round(self, cohort: torch.Tensor, words: np.ndarray, global_model: dict, chunk: int,
              watch: tuple = ()) -> dict:
        """``(P, dim)`` float32 updates and ``(P, w)`` uint32 seed words ->
        ``field_sum``, ``new_global``, the ``(n, nb)`` ``clerk_sums`` that
        the reveal reconstructs from, and for the parties in ``watch`` their
        noise-free rows and wires (``probes``: party -> (q, wire)) and the
        first one's ``mask`` (``None`` without one)."""
        from sda_tpu_torch.models import dequantize_mean, fedavg_apply
        from sda_tpu_torch.ops import chacha_cuda
        from sda_tpu_torch.ops.modular import positive
        from sda_tpu_torch.parallel import engine, limbmatmul

        tracer, plan, fed, dim = self.tracer, self.plan, self.fed, self.dim
        p = fed.spec.modulus
        P = cohort.shape[0]
        mask, probes = None, {}
        seed_words = chacha_cuda.seed_tensor(words, plan.device)
        acc = torch.zeros((plan.limb_stacks.shape[0], plan.n_batches, plan.share_count),
                          dtype=torch.int64, device=plan.device)
        for start in range(0, P, chunk):
            rows = slice(start, min(start + chunk, P))
            with tracer.timed("dp"):
                with tracer.span("quantize"):
                    q = fed.dp_clip_quantize(cohort[rows])
                with tracer.span("noise"):
                    wire = fed.dp_add_noise(q)
            probes.update({row: (q[row - start], wire[row - start]) for row in watch if rows.start <= row < rows.stop})
            with tracer.span("expand"):
                masks, counts = chacha_cuda.expand_seeds_counts(seed_words[rows], dim, p)
            with tracer.span("mask"):
                if int(counts.min()) < dim:
                    raise RuntimeError("a participant's seed window held fewer than dim draws")
                masked = torch.remainder(wire + masks, p).to(torch.int32)
                if watch and rows.start <= watch[0] < rows.stop:
                    mask = masks[watch[0] - start]
            with tracer.span("share"):
                acc = torch.fmod(acc + engine.share_combine_limb_streamed(masked, self.generator, plan), p)
        with tracer.span("expand"):
            fold = chacha_cuda.combine_masks_device(seed_words, dim, p, device=plan.device)
        with tracer.span("reveal"), tracer.timed("reveal"):
            clerk_sums = limbmatmul.limb_recombine(acc, p).T
            masked_total = engine.reconstruct(clerk_sums, self.clerks, self.scheme, dim)
            field_sum = positive(torch.fmod(masked_total - fold, p), p)
            mean = dequantize_mean(field_sum, P, fed.spec, fed.treedef, fed.shapes)
            new_global = fedavg_apply(global_model, mean, device=plan.device)
        return {"field_sum": field_sum, "new_global": new_global, "clerk_sums": clerk_sums, "mask": mask,
                "probes": probes}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, reference, program=None):
        self.config, self.traffic = config, traffic
        self.dim = dim = config["parameters"]
        self.P = P = traffic["cohort"]
        if P != config["participants"] or P != config["dp"]["expected_participants"]:
            raise ValueError(f"a cohort of {P} is not the configuration's {config['participants']}")
        self.leaves = layout(config["model"]["layers"])
        if self.leaves[-1][3] + math.prod(self.leaves[-1][2]) != dim:
            raise ValueError("the model's layers do not add up to its parameters")
        self.device = torch.device(device)
        pools = traffic["pool_cohorts"]
        if self.device.type == "cpu" and pools * P * dim > CPU_POOL_LIMIT:
            raise ValueError(f"a pool of {pools} x {P} x {dim} values runs on the card only")
        self.tracer, self.reference = tracer, reference
        self.l2_clip, self.frac_bits = config["dp"]["l2_clip"], config["quantization"]["frac_bits"]
        self.p = config["scheme"]["prime_modulus"]
        pool_seed, order_seed, program_seed, pick_seed = seeds(seed, 4)
        self.clerks = clerks = clerks_of(config, traffic["dropped_clerks"])
        generator = torch.Generator(device=self.device).manual_seed(program_seed)
        self.program = program or Program(config, clerks, self.device, generator, tracer)
        gen = torch.Generator(device=self.device).manual_seed(pool_seed)
        self.pool = torch.randn((pools, P, dim), generator=gen, dtype=torch.float32, device=self.device)
        self.pool.div_(torch.linalg.vector_norm(self.pool, dim=2, keepdim=True))
        lo, hi = (math.log(r * self.l2_clip) for r in traffic["norm_over_clip"])
        norms = torch.exp(lo + (hi - lo) * torch.rand((pools, P, 1), generator=gen, dtype=torch.float32,
                                                      device=self.device))
        self.pool.mul_(norms)
        self.clipped = (norms[..., 0] > self.l2_clip).cpu().numpy()  # (pools, P): the rows the clip scales
        self.global0 = traffic["global_std"] * torch.randn(dim, generator=gen, dtype=torch.float32,
                                                           device=self.device)
        self.global_model = tree_of(self.global0, self.leaves)
        self.rng = np.random.default_rng(order_seed)
        self.pick = np.random.default_rng(pick_seed)
        kept, rows = traffic["kept_rounds"], traffic["probed_rows"]
        probed = min(traffic["probed_rounds"], kept)
        s = config["scheme"]
        self.kept_sums = torch.empty((kept, dim), dtype=torch.int64, device=self.device)
        self.kept_before = torch.empty((kept, dim), dtype=torch.float64, device=self.device)
        self.kept_models = torch.empty((kept, dim), dtype=torch.float64, device=self.device)
        self.kept_rounds = [None] * kept
        self.kept_q = torch.empty((probed, rows, dim), dtype=torch.int64, device=self.device)
        self.kept_wires = torch.empty((probed, rows, dim), dtype=torch.int64, device=self.device)
        self.kept_masks = torch.empty((probed, dim), dtype=torch.int64, device=self.device)
        self.kept_clerks = torch.empty((probed, s["share_count"], -(-dim // s["secret_count"])),
                                       dtype=torch.int64, device=self.device)
        self.kept_seeds = np.zeros((probed, traffic["seed_words"]), dtype=np.uint32)
        self.kept_watch: list = [()] * probed
        self.probed: list = [False] * probed  # whether the slot's round handed back its probes
        self.masked: list = [False] * probed  # and its mask and clerk sums
        self.cohorts: list = []

    def _round(self, probe: bool = False):
        c = int(self.rng.integers(0, self.traffic["pool_cohorts"]))
        words = self.rng.integers(0, 1 << 32, size=(self.P, self.traffic["seed_words"]),
                                  dtype=np.uint64).astype(np.uint32)
        watch = self._watch(c) if probe else ()
        out = self.program.round(self.pool[c], words, self.global_model, self.traffic["chunk"], watch=watch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return c, words, watch, out

    def _watch(self, c: int) -> tuple:
        """``probed_rows`` distinct parties of one chunk of cohort ``c``,
        drawn from the seed among those whose update the clip scales: only
        their quantization can differ from the reference's, by a last-bit
        scale that moves a rounding, a few values a row (the rest of the
        chunk where it holds too few)."""
        chunk = self.traffic["chunk"]
        first = chunk * int(self.pick.integers(0, -(-self.P // chunk)))
        rows = list(range(first, min(first + chunk, self.P)))
        clipped = [r for r in rows if self.clipped[c, r]]
        rows = clipped if len(clipped) >= self.traffic["probed_rows"] else rows
        picked = self.pick.choice(len(rows), size=min(self.traffic["probed_rows"], len(rows)), replace=False)
        return tuple(rows[int(r)] for r in picked)

    def warm(self) -> None:
        saved = self.rng.bit_generator.state
        for _ in range(self.traffic["warm_rounds"]):
            self._round()
        self.rng.bit_generator.state = saved  # the window starts the seed's own sequence
        self.tracer.collect(Run())

    def window(self, seconds: float) -> Run:
        run = Run()
        tracer = self.tracer
        dim, P, s = self.dim, self.P, self.config["scheme"]
        least = least_time.masked_round_s(P, dim, 4)
        layers = {"dp": dp_least_s(P, dim), "expand": least_time.chacha_s(2 * P, dim),
                  "share": least_time.share_s(P, dim, s["share_count"], s["secret_count"])}
        longest = 0.0
        traced = self.traffic["trace_units"]
        if traced:
            # before the window's clock: the profiler's own start is not a unit's
            tracer.start(getattr(self.program, "launches", None))
        start = time.perf_counter()
        # two rounds at least: the check compares their noise
        while len(run.units) < 2 or time.perf_counter() - start + longest <= seconds:
            i = len(run.units)
            if i < traced:
                tracer.add_unit(i)
            slot = i if i < len(self.kept_rounds) else int(self.pick.integers(0, i + 1))
            before = self.global_model
            t0 = time.perf_counter()
            c, words, watch, out = self._round(probe=slot < len(self.probed))
            wall = time.perf_counter() - t0
            if i + 1 == traced:
                tracer.stop()
            tracer.collect(run)
            longest = max(longest, wall)
            run.units.append(Unit(wall_s=wall, elems=P * dim, least_s=least, layer_least_s=dict(layers)))
            self._keep(i, slot, out, before, words, watch)
            self.cohorts.append(c)
            self.global_model = out["new_global"]
        run.window_s = time.perf_counter() - start
        tracer.stop()
        return run

    def _keep(self, i: int, slot: int, out: dict, before: dict, words: np.ndarray, watch: tuple) -> None:
        if slot < len(self.kept_rounds):
            self.kept_sums[slot].copy_(out["field_sum"])
            torch.cat([before[layer][name].reshape(-1) for layer, name, _, _ in self.leaves],
                      out=self.kept_before[slot])
            torch.cat([out["new_global"][layer][name].reshape(-1) for layer, name, _, _ in self.leaves],
                      out=self.kept_models[slot])
            self.kept_rounds[slot] = i
        if slot < len(self.probed):
            probes, mask, clerk_sums = out.get("probes", {}), out.get("mask"), out.get("clerk_sums")
            self.probed[slot] = bool(watch) and all(r in probes for r in watch)
            self.masked[slot] = mask is not None and clerk_sums is not None
            if self.probed[slot]:
                for j, r in enumerate(watch):
                    self.kept_q[slot, j].copy_(probes[r][0])
                    self.kept_wires[slot, j].copy_(probes[r][1])
                self.kept_watch[slot] = watch
            if self.masked[slot]:
                self.kept_masks[slot].copy_(mask)
                self.kept_clerks[slot].copy_(clerk_sums)
                self.kept_seeds[slot] = words[watch[0]]

    def release(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """The probed rows' quantization (exact: the count of values that
        differ, limit 0), the noise's law in the kept rounds' sums and the
        probed rows, and its independence from round to round
        (``reference.noise_checks``), the probed masks (exact)
        and sharing (``reference/shamir.py``), and each kept round's new
        model against the old one plus its revealed sum's mean. A probed
        round that handed back no probes gives no numbers, which fails."""
        ref, p, P = self.reference, self.p, self.P
        data: dict = {}
        aggregate, party, pairs, by_round = ref.Moments(), ref.Moments(), [], []
        worst, failed = 0.0, 0
        for slot, i in enumerate(self.kept_rounds):
            if i is None:
                continue
            c = self.cohorts[i]
            if c not in data:
                data[c] = ref.data_sum(self.pool[c], self.l2_clip, self.frac_bits, p)
            by_round.append(ref.centered(self.kept_sums[slot] - data[c], p))
            aggregate.add(by_round[-1])
            want = self.kept_before[slot] + ref.mean_update(self.kept_sums[slot], P, self.frac_bits, p)
            gap = float(torch.max(torch.abs(self.kept_models[slot] - want)))
            worst = max(worst, gap)
            failed += gap > GLOBAL_LIMIT
        rounds = [j for j, r in enumerate(self.kept_rounds[: len(self.probed)]) if r is not None]
        mismatches = None
        if rounds and all(self.probed[j] for j in rounds):
            mismatches = 0
            for j in rounds:
                rows = list(self.kept_watch[j])
                want = ref.quantize_rows(self.pool[self.cohorts[self.kept_rounds[j]]][rows], self.l2_clip,
                                         self.frac_bits, p)
                bad = int(torch.count_nonzero(self.kept_q[j, : len(rows)] != want))
                mismatches += bad
                failed += bad > 0
                noise = ref.centered(self.kept_wires[j, : len(rows)] - self.kept_q[j, : len(rows)], p)
                party.add(noise)
                if len(rows) > 1:
                    pairs.append((noise[0], noise[1]))
        masks = None
        if rounds and all(self.masked[j] for j in rounds):
            wrong = [int(np.count_nonzero(ref.mask(self.kept_seeds[j], self.dim, p)
                                          != self.kept_masks[j].cpu().numpy())) for j in rounds]
            masks = sum(wrong)
            failed += sum(w > 0 for w in wrong)
            clerk_sums = [self.kept_clerks[j].cpu().numpy() for j in rounds]
        else:
            clerk_sums = [None]
        checks = {"quantize_mismatches": (mismatches, 0)}
        by_round = torch.stack(by_round) if by_round else torch.empty((0, self.dim), dtype=torch.int64)
        checks.update(ref.noise_checks(aggregate, party, pairs, by_round, ref.sigma_party(self.config), P))
        checks["mask_mismatches"] = (masks, 0)
        checks.update(ref.sharing_checks(clerk_sums, self.config["scheme"], self.clerks))
        checks["global_max_abs_err"] = (worst if aggregate.n else None, GLOBAL_LIMIT)
        return checks, failed
