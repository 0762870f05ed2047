"""The committee-scaling rider (counterpart of ``bench.py``'s
``measure_committee_scaling``): the ``SDA_WORKERS`` sweep over the pooled
crypto planes, and the store's read-pool probe."""

from __future__ import annotations

import os
import threading
import time

import numpy as np

from ._common import RssSampler, aggregation, bank, emit_line, env_int, rest_deployment, scoped_env

COMMITTEE_ENV = ("SDA_WORKERS", "SDA_JOB_PAGE_THRESHOLD", "SDA_JOB_CHUNK_SIZE",
                 "SDA_RESULT_PAGE_THRESHOLD", "SDA_RESULT_CHUNK_SIZE")


def measure_committee_scaling(n_participants: int | None = None, device=None) -> dict:
    """One Full-masked cohort is seeded over a loopback sqlite REST server;
    then workers in {1, 2, 4, cpu_count} sweep three planes: clerking
    (``process_clerking_job`` on the same paged job, its result never
    posted, so every count decrypts the identical column), reveal
    (``reveal_aggregation``, read-only) and ingest (``encrypt_batch`` over a
    fixed message list). Each config is held to the serial one: clerking's
    decrypted combined plaintext and the reveal's values byte-identical, the
    pooled seals opened serially back to their inputs. Then 1 and 4 threads
    hammer the snapshot's mask column with chunk range reads.

    ``SDA_WORKERS`` sizes the Python pool (``utils/workpool.py``); the
    port's seals and opens run in the native layer's own pthread pool,
    sized by ``SDA_NATIVE_THREADS`` (default: one per CPU) whatever
    ``SDA_WORKERS`` says. Every config records both, so a flat ratio reads
    as what it is. N is ``SDA_BENCH_COMMITTEE_N`` (default 4,000)."""
    from .. import native
    from ..crypto.encryption import SodiumDecryptor, SodiumEncryptor, generate_encryption_keypair
    from ..protocol import AdditiveSharing, FullMasking, SodiumEncryptionScheme
    from ..server import new_sqlite_server

    n = n_participants or env_int("SDA_BENCH_COMMITTEE_N", 4000)
    n_clerks, dim, modulus, chunk = 2, 32, 433, 4096
    cpu = os.cpu_count() or 1
    workers_swept = sorted({1, 2, 4, cpu})
    native_threads = native._default_threads()
    out: dict = {
        "n_participants": n,
        "clerks": n_clerks,
        "cpu_count": cpu,
        "workers_swept": workers_swept,
        "planes": {"clerking": {}, "reveal": {}, "ingest": {}},
        "read_pool": {},
    }

    def plane_entry(plane: str, w: int, wall: float, rss, identical) -> dict:
        cfg = {
            "workers": w,
            "native_threads": native_threads,
            "per_s": round(n / wall) if wall else None,
            "wall_s": round(wall, 3),
            "peak_rss_mib": rss,
            "identical_to_serial": identical,
        }
        serial = out["planes"][plane].get("w1")
        if serial and cfg["per_s"] and serial["per_s"]:
            cfg["vs_w1"] = round(cfg["per_s"] / serial["per_s"], 2)
        else:
            cfg["vs_w1"] = 1.0 if w == 1 else None
        out["planes"][plane][f"w{w}"] = cfg
        emit_line(f"committee_scaling_{plane}_w{w}", cfg["per_s"], "encryptions_per_second",
                  vs_serial=cfg["vs_w1"], workers=w, native_threads=native_threads, cpu_count=cpu,
                  n_participants=n, peak_rss_mib=rss,
                  roofline={"plane": "host_crypto_pool",
                            "bound": f"min(workers={w}, cores={cpu}) x serial kernel",
                            "kernel": plane})
        return cfg

    def sweep(plane: str, run, check) -> None:
        for w in workers_swept:
            os.environ["SDA_WORKERS"] = str(w)
            with RssSampler() as rss:
                t1 = time.perf_counter()
                got = run()
                wall = time.perf_counter() - t1
            identical = check(got)
            assert identical, f"{plane} output diverged at workers={w}"
            plane_entry(plane, w, wall, rss.peak_mib, identical)

    with scoped_env(*COMMITTEE_ENV):
        # paged delivery everywhere: the sweep times the chunked pipelines
        for knob in COMMITTEE_ENV[1:]:
            os.environ[knob] = str(chunk) if knob.endswith("CHUNK_SIZE") else "0"
        with rest_deployment(lambda root: new_sqlite_server(str(root / "sda.db")), device) as d:
            service = d.service
            recipient, rkey = d.keyed("r")
            clerks = d.committee(n_clerks)
            agg = aggregation(recipient, rkey, "committee-bench", dim, modulus,
                              FullMasking(modulus=modulus),
                              AdditiveSharing(share_count=n_clerks, modulus=modulus))
            recipient.upload_aggregation(agg)
            recipient.begin_aggregation(agg.id)
            participant = d.client("p", upload=True)

            t0 = time.perf_counter()
            os.environ["SDA_WORKERS"] = "1"
            participant.participate_many([[1] * dim] * n, agg.id, chunk_size=512)
            recipient.end_aggregation(agg.id)
            out["seed_s"] = round(time.perf_counter() - t0, 2)

            # -- clerking: the job is fetched, its result never posted -------
            clerk = clerks[0]
            job = service.get_clerking_job(clerk.agent, clerk.agent.id)
            result_decryptor = recipient.crypto.new_share_decryptor(rkey, SodiumEncryptionScheme())
            serial: dict = {}

            def same_as_first(key, value) -> bool:
                first = serial.setdefault(key, value)
                return bool(np.array_equal(value, first))

            sweep("clerking", lambda: clerk.process_clerking_job(job),
                  lambda result: same_as_first(
                      "clerking", np.asarray(result_decryptor.decrypt(result.encryption))))

            # finish the round, so the reveal has a result to stream
            os.environ["SDA_WORKERS"] = "1"
            for c in clerks:
                c.run_chores(-1)

            # -- reveal: read-only, so every count sees the same snapshot ----
            def reveal_check(revealed) -> bool:
                values = np.asarray(revealed.values)
                if "reveal" not in serial:
                    np.testing.assert_array_equal(np.asarray(revealed.positive().values),
                                                  np.full(dim, n % modulus, dtype=np.int64))
                return same_as_first("reveal", values)

            sweep("reveal", lambda: recipient.reveal_aggregation(agg.id), reveal_check)

            # -- ingest: fixed messages, pooled seal, serial open ------------
            keypair = generate_encryption_keypair()
            messages = [np.arange(i, i + dim, dtype=np.int64) % modulus for i in range(n)]
            encryptor, opener = SodiumEncryptor(keypair.ek), SodiumDecryptor(keypair)

            def ingest_check(sealed) -> bool:
                # sealing is randomised: the pooled boxes must open, serially,
                # to exactly their plaintexts
                os.environ["SDA_WORKERS"] = "1"
                opened = opener.decrypt_batch(sealed[:256])
                return all(np.array_equal(o, m) for o, m in zip(opened, messages[:256]))

            sweep("ingest", lambda: encryptor.encrypt_batch(messages), ingest_check)

            # -- read pool: concurrent mask-column range reads ---------------
            # small chunks, so each thread issues many range reads
            probe_chunk = 256
            os.environ["SDA_RESULT_CHUNK_SIZE"] = str(probe_chunk)
            snap_id = service.get_aggregation_status(recipient.agent, agg.id).snapshots[0].id
            starts = list(range(0, n, probe_chunk))

            def hammer(reads_done: list) -> None:
                for start in starts:
                    got = service.get_snapshot_result_masks(recipient.agent, agg.id, snap_id, start)
                    reads_done.append(len(got))

            for t_count in (1, 4):
                done: list = []
                threads = [threading.Thread(target=hammer, args=(done,), daemon=True)
                           for _ in range(t_count)]
                t1 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t1
                entry = {
                    "threads": t_count,
                    "reads_per_s": round(t_count * len(starts) / wall, 1) if wall else None,
                    "wall_s": round(wall, 3),
                    "rows_read": sum(done),
                }
                base = out["read_pool"].get("t1")
                if base and entry["reads_per_s"] and base["reads_per_s"]:
                    entry["vs_t1"] = round(entry["reads_per_s"] / base["reads_per_s"], 2)
                else:
                    entry["vs_t1"] = 1.0 if t_count == 1 else None
                out["read_pool"][f"t{t_count}"] = entry
                emit_line(f"committee_scaling_read_pool_t{t_count}", entry["reads_per_s"],
                          "chunk_reads_per_second", vs_serial=entry["vs_t1"], threads=t_count,
                          cpu_count=cpu,
                          roofline={"plane": "sqlite_wal_read_pool",
                                    "bound": "per-thread read connections over WAL"})

    bank({"committee": {
        "metric": "committee_scaling",
        "config": {"n_participants": n, "clerks": n_clerks, "dim": dim, "chunk_size": chunk,
                   "masking": "full", "committee": f"additive x{n_clerks}", "store": "sqlite",
                   "transport": "loopback_rest", "native_threads": native_threads},
        **out,
    }})
    return out
