#!/usr/bin/env python3
"""Benchmark: end-to-end HGT breakpoint detection throughput on one GPU.

Default workload (LHT_BENCH_SCALE=big): 100 genomes / ~100 Mbp reference /
~1.7M read pairs at the reference's default k=32, approximating the
reference's headline workload shape (a human-gut sample vs a large
reference, README.md:6). Two passes: pass 1 includes compilation (the cold
wall), pass 2 is the steady-state number; both are reported, and the JSON
records the pass mode (`two_pass`). LHT_BENCH_SCALE=species20 keeps the
small smoke fixture for quick iteration; LHT_BENCH_SCALE=scale1g is the
>=1 Gbp / >=10M-pair scale proof (one pass).

Prints ONE JSON line:

    {"metric": "bkp_pairs_per_sec", "value": N, "unit": "pairs/s",
     "vs_baseline": R, "stage_walls": {...}, "hbm_peak_gb": ..., ...}

Baseline anchor: the reference processes a human-gut sample (~13M read
pairs at the 2 Gbp down-sample) in ~2 h on 10 CPU threads (README.md:6) ==
~1800 pairs/s end-to-end. vs_baseline = ours / 1800.

Run hygiene:
  * an exclusive flock on .bench/.bench.lock serializes benches — a held
    lock fails loudly after LHT_BENCH_LOCK_TIMEOUT (default 120 s) instead
    of timing a contended run;
  * every scale writes into its own outdir (.bench/run_<scale>) with a
    per-scale sample name, so concurrent scales cannot clobber each
    other's artifacts;
  * per-batch count dispatch walls are recorded in the JSON
    (count_batch_dispatch_s), so a dispatch anomaly is diagnosable from the
    artifact alone.

--profile writes a jax profiler trace per stage under
.bench/run_<scale>/trace and links it from the JSON.
"""

import fcntl
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

BASELINE_PAIRS_PER_SEC = 13_000_000 / (2 * 3600.0)
FIXTURE_DIR = os.path.join(ROOT, ".bench")  # fixtures are shared, immutable
LOCK_PATH = os.path.join(FIXTURE_DIR, ".bench.lock")

SCALES = {
    # name: (n_genomes, genome_len, hgt_num, depth, two-pass?)
    "species20": (20, 150_000, 10, 10, True),
    "big": (100, 1_000_000, 50, 5, True),
    # scale proof: >= 1 Gbp reference / >= 10M pairs — the headline
    # workload's shape (multi-Gbp UHGG, 13M pairs at the 2 Gbp down-sample)
    "scale1g": (205, 5_000_000, 100, 3, False),
}
FIXTURE_SEED = 42


def _fail(reason: str, **extra):
    rec = {"metric": "bkp_pairs_per_sec", "value": 0.0, "unit": "pairs/s",
           "vs_baseline": 0.0, "error": reason}
    rec.update(extra)
    print(json.dumps(rec))
    sys.exit(1)


def _acquire_lock(timeout_s: float):
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    fd = os.open(LOCK_PATH, os.O_CREAT | os.O_RDWR, 0o644)
    deadline = time.time() + timeout_s
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            os.ftruncate(fd, 0)
            os.write(fd, f"{os.getpid()}\n".encode())
            return fd
        except BlockingIOError:
            if time.time() >= deadline:
                try:
                    with open(LOCK_PATH) as f:
                        holder = f.read().strip()
                except OSError:
                    holder = "?"
                _fail("another bench holds the lock", lock_holder_pid=holder)
            time.sleep(2.0)


def fixture(scale: str, outdir: str = FIXTURE_DIR, reuse: bool = True):
    """Simulate (or reuse) the seeded fixture of `scale`; returns
    (ref, fq1, fq2, truth) paths."""
    from localhgt_tpu.sim.simulate import SimParams, simulate_sample

    name = f"bench_{scale}"
    paths = [os.path.join(outdir, f"{name}{s}")
             for s in (".ref.fa", ".1.fq", ".2.fq", ".true.sv.txt")]
    if (reuse and not os.environ.get("LHT_BENCH_REGEN")
            and all(os.path.isfile(p) for p in paths)):
        return tuple(paths)
    n_genomes, genome_len, hgt, depth, _ = SCALES[scale]
    pa = SimParams(n_genomes=n_genomes, genome_len=genome_len, hgt_num=hgt,
                   depth=depth, snp_rate=0.01, seed=FIXTURE_SEED)
    return simulate_sample(outdir, name, pa)


def main():
    scale = os.environ.get("LHT_BENCH_SCALE", "big")
    two_pass = SCALES[scale][4]
    # unique outdir + sample name per scale: concurrent scales can never
    # clobber each other's artifacts
    out = os.path.join(FIXTURE_DIR, f"run_{scale}")
    os.makedirs(out, exist_ok=True)
    sample = f"bench_{scale}"

    lock_timeout = float(os.environ.get("LHT_BENCH_LOCK_TIMEOUT", "120"))
    lock_fd = _acquire_lock(lock_timeout)

    profile = "--profile" in sys.argv[1:]
    trace_dir = None
    if profile:
        trace_dir = os.path.join(out, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        os.environ["LHT_PROFILE"] = trace_dir

    import jax

    from localhgt_tpu.utils import compile_cache

    compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        _fail(f"no GPU: JAX's first device is {dev.platform!r}")

    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.sim import evaluate
    from localhgt_tpu.sim.simulate import read_truth
    from localhgt_tpu.utils import formats, metrics

    t_sim = time.time()
    ref, fq1, fq2, truth_path = fixture(scale)
    sim_wall = time.time() - t_sim
    truth = read_truth(truth_path)
    n_pairs = sum(1 for _ in open(fq1)) // 4

    # k=32 is the reference default (scripts/localhgt.py:56): 3 packed
    # int32-word tables (3 x 2 GB) + the rank-map vote path.
    k = int(os.environ.get("LHT_BENCH_K", "32"))
    cfg = Config().replace(kmer=KmerConfig(k=k))

    from localhgt_tpu.pipeline.bkp import detect_breakpoint

    t0 = time.time()
    acc = detect_breakpoint(ref, fq1, fq2, sample, out, cfg=cfg)
    wall_cold = time.time() - t0
    if two_pass:
        metrics.reset()
        t0 = time.time()
        acc = detect_breakpoint(ref, fq1, fq2, sample, out, cfg=cfg)
        wall = time.time() - t0
    else:
        wall = wall_cold

    rows, _, _ = formats.read_acc_csv(acc)
    called = [
        (r["from_ref"], int(r["from_pos"]), r["to_ref"], int(r["to_pos"]))
        for r in rows
    ]
    score = evaluate.score_bkps(evaluate.truth_to_bkps(truth), called)

    pairs_per_sec = n_pairs / wall
    rec = {
        "metric": "bkp_pairs_per_sec",
        "value": round(pairs_per_sec, 1),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 3),
        "vs_baseline_cold": round(
            n_pairs / wall_cold / BASELINE_PAIRS_PER_SEC, 3),
        "wall_s": round(wall, 1),
        "wall_cold_s": round(wall_cold, 1),
        "sim_wall_s": round(sim_wall, 1),
        "n_pairs": n_pairs,
        "recall": score.recall,
        "fdr": score.fdr,
        "f1": score.f1,
        "k": k,
        "scale": scale,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "two_pass": bool(two_pass),
        "stage_walls": metrics.stage_walls(),
        "stage_rss_gb": metrics.stage_rss(),
    }
    series = metrics.series_stats()
    if series:
        rec["batch_series"] = series
    cnt = metrics.counters()
    if cnt:
        rec["counters"] = {k: round(v, 1) for k, v in cnt.items()}
    if trace_dir:
        rec["trace_dir"] = trace_dir
    rec.update(metrics.device_memory_stats())
    rec.update(evaluate.resource_usage())  # host CPU time + max RSS
    rec.update(metrics.derived(n_pairs, 150, cfg.kmer.coder_num))
    print(json.dumps(rec))
    os.close(lock_fd)


if __name__ == "__main__":
    main()
