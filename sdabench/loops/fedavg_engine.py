"""A closed loop of ChaCha-masked secure FedAvg rounds on the port's engine.

A round takes a cohort of ``cohort`` flat float32 updates, as the
aggregating host receives the wire vectors, and for each chunk of ``chunk``
participants quantizes them (``QuantizationSpec.quantize``), masks them mod
p with the expansion of fresh 128-bit seeds (``chacha_cuda.expand_seeds_counts``:
K2 and the compaction, one host sync on the accepted counts), and shares and
combines them (``engine.share_combine_limb_streamed``: K1). The recipient
folds every seed's mask (``combine_masks_device``: K2), recombines the limbs
(``limb_recombine``), reconstructs from the clerks that remain after
``dropped_clerks`` leave (``engine.reconstruct``), subtracts the fold,
dequantizes the mean (``dequantize_mean``) and applies it to the global
model (``fedavg_apply``), whose result the next round starts from.

The cohorts come from a pool of ``pool_cohorts`` distinct cohorts drawn on
the card at set-up, normal with ``update_std`` and clamped to the clip; each
round takes one in an order drawn from the seed, with seeds drawn from it.

The check takes every round's mean into the reference's chain of global
models and compares the last round's model, and compares the field sum and
the model of ``kept_rounds`` rounds sampled from the seed (a reservoir:
each round of the window equally likely). Masks and share randomness
cancel in those, so the first ``PROBED_ROUNDS`` of the kept rounds also
keep the mask of one participant drawn from the seed, which the reference
expands again from its seed (plain ChaCha20), and the clerk sums that the
reveal reconstructs from, from which the reference works out the summed
share randomness and the dropped clerk's sum. All of it is copied into
buffers allocated at set-up, so the window allocates nothing that it keeps.

Traffic keys: ``cohort``, ``chunk``, ``pool_cohorts``, ``update_std``,
``global_std``, ``seed_words``, ``dropped_clerks``, ``warm_rounds``,
``trace_units``, ``kept_rounds``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from sdabench import least_time
from sdabench.inputs import clerks_of, scheme_of, seeds
from sdabench.record import Run, Unit

#: kept rounds that also keep a mask and their clerk sums: the reference's
#: ChaCha20 takes about half a second a mask on the host
PROBED_ROUNDS = 4


def layout(model: dict) -> list:
    """``[(layer, name, shape, offset)]`` in sorted key order, the order in
    which the port flattens a two-level dict of leaves."""
    out, offset = [], 0
    for layer in sorted(model):
        for name in sorted(model[layer]):
            shape = tuple(model[layer][name])
            out.append((layer, name, shape, offset))
            offset += math.prod(shape)
    return out


def tree_of(flat: torch.Tensor, leaves: list) -> dict:
    tree: dict = {}
    for layer, name, shape, offset in leaves:
        tree.setdefault(layer, {})[name] = flat[offset: offset + math.prod(shape)].view(shape)
    return tree


def flat_of(tree: dict, leaves: list) -> torch.Tensor:
    return torch.cat([tree[layer][name].reshape(-1) for layer, name, _, _ in leaves])


class Program:
    """The system under test: one round through the port's entries."""

    def __init__(self, config: dict, clerks: list, device, generator, tracer):
        from sda_tpu_torch.models import QuantizationSpec, tree_layout
        from sda_tpu_torch.parallel import engine

        q = config["quantization"]
        # the port sizes the field; its roots of unity it draws at random, so
        # the scheme takes the configuration's (drawn with seed 0)
        self.spec, _ = QuantizationSpec.fitted(q["frac_bits"], q["clip"], config["participants"])
        self.scheme = scheme_of(config)
        if self.spec.modulus != self.scheme.prime_modulus:
            raise ValueError(f"the port's fitted field {self.spec.modulus} is not the configuration's "
                             f"{self.scheme.prime_modulus}")
        self.clerks, self.generator, self.tracer = clerks, generator, tracer
        self.dim = config["parameters"]
        self.plan = engine.make_plan(self.scheme, self.dim, device)
        self.template = tree_of(torch.zeros(self.dim, dtype=torch.float64), layout(config["model"]["layers"]))
        self.treedef, self.shapes, _ = tree_layout(self.template)

    @staticmethod
    def launches() -> dict:
        """The port's own counts of its kernels' launches, by kernel name."""
        from sda_tpu_torch.ops import chacha_cuda
        from sda_tpu_torch.parallel import limb_cuda

        return {"chacha20_kernel": chacha_cuda.launches, "limb_share_sum_kernel": limb_cuda.launches}

    def round(self, cohort: torch.Tensor, words: np.ndarray, global_model: dict, chunk: int,
              watch: int | None = None) -> dict:
        """``(P, dim)`` float32 updates and ``(P, w)`` uint32 seed words ->
        ``field_sum``, ``new_global``, the ``(n, nb)`` ``clerk_sums`` that
        the reveal reconstructs from, and the ``mask`` of participant
        ``watch`` (``None`` without one)."""
        from sda_tpu_torch.models import dequantize_mean, fedavg_apply
        from sda_tpu_torch.ops import chacha_cuda
        from sda_tpu_torch.ops.modular import positive
        from sda_tpu_torch.parallel import engine, limbmatmul

        tracer, plan, p, dim = self.tracer, self.plan, self.spec.modulus, self.dim
        P = cohort.shape[0]
        mask = None
        seed_words = chacha_cuda.seed_tensor(words, plan.device)
        acc = torch.zeros((plan.limb_stacks.shape[0], plan.n_batches, plan.share_count),
                          dtype=torch.int64, device=plan.device)
        for start in range(0, P, chunk):
            rows = slice(start, min(start + chunk, P))
            with tracer.span("quantize"):
                q = self.spec.quantize(cohort[rows])
            with tracer.span("expand"):
                masks, counts = chacha_cuda.expand_seeds_counts(seed_words[rows], dim, p)
            with tracer.span("mask"):
                if int(counts.min()) < dim:
                    raise RuntimeError("a participant's seed window held fewer than dim draws")
                masked = torch.remainder(q + masks, p).to(torch.int32)
                if watch is not None and rows.start <= watch < rows.stop:
                    mask = masks[watch - rows.start]
            with tracer.span("share"):
                acc = torch.fmod(acc + engine.share_combine_limb_streamed(masked, self.generator, plan), p)
        with tracer.span("expand"):
            fold = chacha_cuda.combine_masks_device(seed_words, dim, p, device=plan.device)
        with tracer.span("reveal"), tracer.timed("reveal"):
            clerk_sums = limbmatmul.limb_recombine(acc, p).T
            masked_total = engine.reconstruct(clerk_sums, self.clerks, self.scheme, dim)
            field_sum = positive(torch.fmod(masked_total - fold, p), p)
            mean = dequantize_mean(field_sum, P, self.spec, self.treedef, self.shapes)
            new_global = fedavg_apply(global_model, mean, device=plan.device)
        return {"field_sum": field_sum, "new_global": new_global, "clerk_sums": clerk_sums, "mask": mask}


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer, reference, program=None):
        self.config, self.traffic = config, traffic
        self.dim = config["parameters"]
        self.P = traffic["cohort"]
        if self.P != config["participants"]:
            raise ValueError(f"a cohort of {self.P} is not the configuration's {config['participants']}")
        self.leaves = layout(config["model"]["layers"])
        if self.leaves[-1][3] + math.prod(self.leaves[-1][2]) != self.dim:
            raise ValueError("the model's layers do not add up to its parameters")
        self.device = torch.device(device)
        self.tracer, self.reference = tracer, reference
        self.q, self.p = config["quantization"], config["scheme"]["prime_modulus"]
        pool_seed, order_seed, program_seed, pick_seed = seeds(seed, 4)
        self.clerks = clerks = clerks_of(config, traffic["dropped_clerks"])
        generator = torch.Generator(device=self.device).manual_seed(program_seed)
        self.program = program or Program(config, clerks, self.device, generator, tracer)
        gen = torch.Generator(device=self.device).manual_seed(pool_seed)
        clip = self.q["clip"]
        self.pool = torch.randn((traffic["pool_cohorts"], self.P, self.dim), generator=gen,
                                dtype=torch.float32, device=self.device)
        self.pool.mul_(traffic["update_std"]).clamp_(-clip, clip)
        self.global0 = traffic["global_std"] * torch.randn(self.dim, generator=gen, dtype=torch.float32,
                                                           device=self.device)
        self.global_model = tree_of(self.global0, self.leaves)
        self.rng = np.random.default_rng(order_seed)
        self.pick = np.random.default_rng(pick_seed)
        kept = traffic["kept_rounds"]
        probed = min(PROBED_ROUNDS, kept)
        s = config["scheme"]
        self.kept_sums = torch.empty((kept, self.dim), dtype=torch.int64, device=self.device)
        self.kept_models = torch.empty((kept, self.dim), dtype=torch.float64, device=self.device)
        self.kept_rounds = [None] * kept
        self.kept_masks = torch.empty((probed, self.dim), dtype=torch.int64, device=self.device)
        self.kept_clerks = torch.empty((probed, s["share_count"], -(-self.dim // s["secret_count"])),
                                       dtype=torch.int64, device=self.device)
        self.kept_seeds = np.zeros((probed, traffic["seed_words"]), dtype=np.uint32)
        self.probed: list = [False] * probed  # whether the slot's round handed back its mask and clerk sums
        self.cohorts: list = []

    def _round(self, watch: int | None = None):
        c = int(self.rng.integers(0, self.traffic["pool_cohorts"]))
        words = self.rng.integers(0, 1 << 32, size=(self.P, self.traffic["seed_words"]),
                                  dtype=np.uint64).astype(np.uint32)
        out = self.program.round(self.pool[c], words, self.global_model, self.traffic["chunk"], watch=watch)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return c, words, out

    def warm(self) -> None:
        saved = self.rng.bit_generator.state
        for _ in range(self.traffic["warm_rounds"]):
            self._round()
        self.rng.bit_generator.state = saved  # the window starts the seed's own sequence
        self.tracer.collect(Run())

    def window(self, seconds: float) -> Run:
        run = Run()
        tracer = self.tracer
        cfg, dim, P = self.config, self.dim, self.P
        s = cfg["scheme"]
        least = least_time.masked_round_s(P, dim, 4)
        layers = {"expand": least_time.chacha_s(2 * P, dim),
                  "share": least_time.share_s(P, dim, s["share_count"], s["secret_count"])}
        longest = 0.0
        traced = self.traffic["trace_units"]
        if traced:
            # before the window's clock: the profiler's own start is not a unit's
            tracer.start(getattr(self.program, "launches", None))
        start = time.perf_counter()
        while not run.units or time.perf_counter() - start + longest <= seconds:
            i = len(run.units)
            if i < traced:
                tracer.add_unit(i)
            slot = i if i < len(self.kept_rounds) else int(self.pick.integers(0, i + 1))
            watch = int(self.pick.integers(0, P)) if slot < len(self.probed) else None
            t0 = time.perf_counter()
            c, words, out = self._round(watch)
            wall = time.perf_counter() - t0
            if i + 1 == traced:
                tracer.stop()
            tracer.collect(run)
            longest = max(longest, wall)
            run.units.append(Unit(wall_s=wall, elems=P * dim, least_s=least, layer_least_s=dict(layers)))
            self._keep(i, slot, out, words[watch] if watch is not None else None)
            self.cohorts.append(c)
            self.global_model = out["new_global"]
        run.window_s = time.perf_counter() - start
        tracer.stop()
        return run

    def _keep(self, i: int, slot: int, out: dict, seed) -> None:
        if slot < len(self.kept_rounds):
            self.kept_sums[slot].copy_(out["field_sum"])
            torch.cat([out["new_global"][layer][name].reshape(-1) for layer, name, _, _ in self.leaves],
                      out=self.kept_models[slot])
            self.kept_rounds[slot] = i
        if slot < len(self.probed):
            mask, clerk_sums = out.get("mask"), out.get("clerk_sums")
            self.probed[slot] = mask is not None and clerk_sums is not None
            if self.probed[slot]:
                self.kept_masks[slot].copy_(mask)
                self.kept_clerks[slot].copy_(clerk_sums)
                self.kept_seeds[slot] = seed

    def release(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict, int]:
        """The kept rounds' field sums (exact: the count of coordinates that
        differ, limit 0) and models, and the last round's model (the
        largest gap to the reference's chain from the same start), against
        the reference; the probed rounds' masks (exact) and sharing
        (``reference/shamir.py``). A probed round that handed back no mask
        or clerk sums gives no number, which fails."""
        ref = self.reference
        sums = {}
        slots = {r: j for j, r in enumerate(self.kept_rounds) if r is not None}
        model = self.global0.to(torch.float64)
        mismatches, worst, failed = 0, 0.0, 0
        last = len(self.cohorts) - 1
        for i, c in enumerate(self.cohorts):
            if c not in sums:
                sums[c] = ref.field_sum(self.pool[c], self.q["clip"], self.q["frac_bits"], self.p)
            model = model + ref.mean_update(sums[c], self.P, self.q["frac_bits"], self.p)
            got = []
            if i in slots:
                got.append(self.kept_models[slots[i]])
                bad = int(torch.count_nonzero(self.kept_sums[slots[i]] != sums[c]))
                mismatches += bad
                failed += bad > 0
            if i == last:
                got.append(flat_of(self.global_model, self.leaves))
            for flat in got:
                gap = float(torch.max(torch.abs(flat - model)))
                worst = max(worst, gap)
                failed += gap > GLOBAL_LIMIT
        checks = {"field_sum_mismatches": (mismatches, 0), "global_max_abs_err": (worst, GLOBAL_LIMIT)}
        rounds = [j for j, r in enumerate(self.kept_rounds[: len(self.probed)]) if r is not None]
        if all(self.probed[j] for j in rounds):
            wrong = [int(np.count_nonzero(ref.mask(self.kept_seeds[j], self.dim, self.p)
                                          != self.kept_masks[j].cpu().numpy())) for j in rounds]
            checks["mask_mismatches"] = (sum(wrong), 0)
            failed += sum(w > 0 for w in wrong)
            clerk_sums = [self.kept_clerks[j].cpu().numpy() for j in rounds]
        else:
            checks["mask_mismatches"] = (None, 0)
            clerk_sums = [None]
        checks.update(ref.sharing_checks(clerk_sums, self.config["scheme"], self.clerks))
        return checks, failed


#: the largest gap allowed between a round's new global model and the
#: reference's (PERF.md gives the readings it was set from)
GLOBAL_LIMIT = 1e-10
