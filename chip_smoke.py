#!/usr/bin/env python3
"""End-to-end proof that `localhgt bkp` runs on one GPU, kernels and all.

Phases, in one process and in this order (any failure exits non-zero):

  device   refuse anything but a GPU; print the card, its memory limit, the
           JAX version, XLA_FLAGS, the compile cache and the native IO build
  kernels  every Pallas kernel on the bkp path against its plain reference
           at production widths, bit-exact (all device math is integer),
           each timed against what XLA makes of the plain version
  golden   `localhgt_tpu.cli.main(["bkp", ...])` on the golden fixture of
           tests/test_golden.py; acc.csv must equal tests/golden/gold.acc.csv
  big      the bench.py `big` deployment (100 x 1 Mbp genomes, ~1.68M pairs,
           k=32) through detect_breakpoint, cold and warm; recall >= 0.90
           and FDR <= 0.02 against the simulated truth

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

--four runs only the mesh phase on four cards: the golden fixture and `big`
through detect_breakpoint(mesh="force") and through mesh=None on one card,
in the same process; the two acc.csv files must be byte-identical, and every
card must have held shards.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")  # fixtures and outputs (gitignored)

RECALL_MIN = 0.90
FDR_MAX = 0.02


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check_device(n_cards: int):
    """Fail unless JAX's devices are at least `n_cards` GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (first device is "
                 f"{devs[0].platform!r})")
    if len(devs) < n_cards:
        sys.exit(f"chip_smoke: {n_cards} GPUs needed, {len(devs)} visible")
    return devs


def phase_device(n_cards: int):
    import jax

    devs = check_device(n_cards)
    from localhgt_tpu.io import native
    from localhgt_tpu.utils import compile_cache

    cache = compile_cache.configure()
    st = devs[0].memory_stats() or {}
    log(f"device: {devs[0].device_kind} x {len(devs)}")
    log(f"card: {card()}")
    log(f"bytes_limit: {st.get('bytes_limit')}")
    log(f"jax {jax.__version__}  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    built = native.available()
    log(f"native io library: {'built' if built else 'NOT built'}")
    for mod in ("networkx", "sklearn"):
        try:
            __import__(mod)
            log(f"host package {mod}: installed")
        except ImportError:
            log(f"host package {mod}: missing")
    if not built:
        sys.exit("chip_smoke: the native IO library did not build")
    return devs


def _timed(fn, *args, reps: int = 5) -> float:
    """Median wall of `reps` warm calls, each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return sorted(walls)[len(walls) // 2]


def vote_inputs(B: int, seed: int, C: int = 3, P: int = 256):
    """Candidate streams for B pairs at the production vote shape: C=3 hash
    functions, P=256 (two 150 bp mates at k=32, 64-bucketed). Each pair
    sees two dense real genomes among many single-hit spurious ones, so the
    8-slot register overflows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_genomes, n_peaks = 4096, 1 << 16
    peak_contig = rng.integers(1, n_genomes + 1, n_peaks).astype(np.int32)
    peak_contig[0] = 0
    by_genome = rng.integers(1, n_peaks, (n_genomes + 1, 8))
    real = rng.integers(1, n_genomes + 1, (B, 2))
    pk = rng.integers(1, n_peaks, (C, B, P))
    pick = rng.random((C, B, P))
    which = rng.integers(0, 2, (C, B, P))
    rows = real[np.arange(B)[None, :, None], which]
    dense = by_genome[rows, rng.integers(0, 8, (C, B, P))]
    pk = np.where(pick < 0.35, dense, pk)
    pk = np.where(pick > 0.75, 0, pk).astype(np.int32)
    peak_contig[by_genome[1:].reshape(-1)] = np.repeat(
        np.arange(1, n_genomes + 1), 8)
    return peak_contig[pk], pk


def align_inputs(B: int, seed: int, M: int = 150, N: int = 214):
    """Reads against their candidate windows at the align stage's shapes
    (M = read length, N = L + 2 * window_pad): most reads are planted in
    their window with SNPs and a short indel, some are unrelated, some
    carry N runs, and a few windows are all N."""
    import numpy as np

    rng = np.random.default_rng(seed)
    r = rng.integers(0, 4, (B, N)).astype(np.uint8)
    q = rng.integers(0, 4, (B, M)).astype(np.uint8)
    off = rng.integers(0, N - M + 1, B)
    planted = rng.random(B) < 0.8
    for b in np.flatnonzero(planted):
        seg = r[b, off[b]:off[b] + M].copy()
        cut = rng.integers(10, M - 10)
        if b % 3 == 0:      # deletion in the read
            seg = np.concatenate([seg[:cut], seg[cut + 3:], r[b, :3]])
        elif b % 3 == 1:    # insertion in the read
            seg = np.concatenate([seg[:cut], [0, 1, 2], seg[cut:M - 3]])
        snp = rng.random(M) < 0.02
        seg[snp] = (seg[snp] + 1) % 4
        q[b] = seg[:M]
    q[rng.random(B) < 0.02, 40:60] = 4
    r[rng.random(B) < 0.005] = 4
    return q, r


def phase_kernels(tag: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from localhgt_tpu.ops import pallas_sw, pallas_vote, sw
    from localhgt_tpu.pipeline import peaks

    scan = jax.jit(peaks.vote_state_scan, static_argnames=("n_slots",))
    for B in (512, 4096, 32768):
        genome, pk = (jnp.asarray(a) for a in vote_inputs(B, seed=B))
        got = pallas_vote.vote_state(genome, pk)
        want = scan(genome, pk, n_slots=8)
        for name, a, b in zip(("slots_g", "slots_c", "slots_p", "hits"),
                              got, want):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                sys.exit(f"chip_smoke: vote kernel {name} differs at B={B}")
        full = int((np.asarray(want[0]) != 0).all(axis=1).sum())
        t_k = _timed(pallas_vote.vote_state, genome, pk)
        t_x = _timed(lambda g, p: scan(g, p, n_slots=8), genome, pk)
        log(f"kernel vote_greedy B={B} C=3 P=256 G=8: bit-exact "
            f"({full}/{B} registers full); kernel {t_k * 1e3:.3f} ms, "
            f"XLA lax.scan {t_x * 1e3:.3f} ms [{tag}]")

    B, M, N = 8192, 150, 214
    q, r = (jnp.asarray(a) for a in align_inputs(B, seed=7, M=M, N=N))
    got = np.asarray(pallas_sw.sw_align_pallas(q, r))
    want = np.asarray(sw._sw_align_packed(q, r)).astype(np.int32)
    if not np.array_equal(got, want):
        bad = np.flatnonzero((got != want).any(axis=0))
        sys.exit(f"chip_smoke: sw_align kernel differs on {len(bad)} rows "
                 f"(first {bad[:5].tolist()})")
    t_k = _timed(pallas_sw.sw_align_pallas, q, r)
    t_x = _timed(sw._sw_align_packed, q, r)
    cells = B * M * N
    log(f"kernel sw_align B={B} M={M} N={N}: bit-exact "
        f"({int((got[0] > 0).sum())} nonzero scores); kernel "
        f"{t_k * 1e3:.3f} ms ({cells / t_k / 1e9:.1f} GCUPS), XLA "
        f"lax.scan {t_x * 1e3:.3f} ms ({cells / t_x / 1e9:.1f} GCUPS) [{tag}]")
    log("kernel sw_score: none (accbkp runs the plain sw.sw_score)")


def golden_fixture(out: str):
    from localhgt_tpu.sim.simulate import SimParams, simulate_sample

    pa = SimParams(n_genomes=6, genome_len=30_000, hgt_num=3, depth=8,
                   snp_rate=0.01, seed=33)
    return simulate_sample(out, "gold", pa)


def phase_golden() -> None:
    from localhgt_tpu import cli

    out = os.path.join(WORK, "golden")
    ref, fq1, fq2, _ = golden_fixture(out)
    rc = cli.main(["bkp", "-r", ref, "--fq1", fq1, "--fq2", fq2, "-k", "18",
                   "-s", "gold", "-o", out])
    if rc != 0:
        sys.exit(f"chip_smoke: cli bkp returned {rc}")
    gold = os.path.join(ROOT, "tests", "golden", "gold.acc.csv")
    with open(os.path.join(out, "gold.acc.csv"), "rb") as f, \
            open(gold, "rb") as g:
        if f.read() != g.read():
            sys.exit("chip_smoke: golden acc.csv differs from "
                     "tests/golden/gold.acc.csv")
    log("golden: acc.csv byte-identical to tests/golden/gold.acc.csv")


def _score(acc: str, truth_path: str):
    from localhgt_tpu.sim import evaluate
    from localhgt_tpu.sim.simulate import read_truth
    from localhgt_tpu.utils import formats

    rows, _, _ = formats.read_acc_csv(acc)
    called = [(r["from_ref"], int(r["from_pos"]), r["to_ref"],
               int(r["to_pos"])) for r in rows]
    truth = evaluate.truth_to_bkps(read_truth(truth_path))
    return evaluate.score_bkps(truth, called), len(rows)


def big_fixture():
    import bench

    t0 = time.perf_counter()
    paths = bench.fixture("big", os.path.join(WORK, "big"), reuse=False)
    with open(paths[1]) as f:
        n_pairs = sum(1 for _ in f) // 4
    log(f"big fixture: {n_pairs} pairs simulated in "
        f"{time.perf_counter() - t0:.1f} s (seed {bench.FIXTURE_SEED})")
    return paths, n_pairs


def phase_big(tag: str) -> None:
    import jax

    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.pipeline.bkp import detect_breakpoint
    from localhgt_tpu.utils import metrics

    (ref, fq1, fq2, truth), n_pairs = big_fixture()
    out = os.path.join(WORK, "big", "run")
    os.makedirs(out, exist_ok=True)
    cfg = Config().replace(kmer=KmerConfig(k=32))
    walls = {}
    for run in ("cold", "warm"):
        metrics.reset()
        t0 = time.perf_counter()
        acc = detect_breakpoint(ref, fq1, fq2, "big", out, cfg=cfg)
        walls[run] = time.perf_counter() - t0
        log(f"big {run}: {walls[run]:.1f} s, {n_pairs / walls[run]:.1f} "
            f"pairs/s, stage walls {json.dumps(metrics.stage_walls())} [{tag}]")
    score, n_bkp = _score(acc, truth)
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"big: {n_bkp} breakpoints, recall {score.recall:.4f}, FDR "
        f"{score.fdr:.4f}, peak_bytes_in_use {peak}")
    if score.recall < RECALL_MIN or score.fdr > FDR_MAX:
        sys.exit(f"chip_smoke: big recall {score.recall} / FDR {score.fdr} "
                 f"outside >= {RECALL_MIN} / <= {FDR_MAX}")


def device_stats() -> list:
    import jax

    return [d.memory_stats() for d in jax.devices()]


def phase_four(tag: str) -> None:
    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.pipeline.bkp import detect_breakpoint

    golden = golden_fixture(os.path.join(WORK, "golden"))
    (big, _) = big_fixture()
    for name, (ref, fq1, fq2, _), k in (("golden", golden, 18),
                                        ("big", big, 32)):
        cfg = Config().replace(kmer=KmerConfig(k=k))
        accs = {}
        for mode, mesh in (("four", "force"), ("one", None)):
            out = os.path.join(WORK, f"four_{name}_{mode}")
            os.makedirs(out, exist_ok=True)
            t0 = time.perf_counter()
            accs[mode] = detect_breakpoint(ref, fq1, fq2, name, out,
                                           cfg=cfg, mesh=mesh)
            log(f"{name} mesh={mesh}: {time.perf_counter() - t0:.1f} s [{tag}]")
            if mode == "four":
                stats = device_stats()
                log(f"{name} per-device peak_bytes_in_use "
                    f"{[s['peak_bytes_in_use'] for s in stats]}, "
                    f"bytes_in_use {[s['bytes_in_use'] for s in stats]}")
                if min(s["peak_bytes_in_use"] for s in stats) == 0:
                    sys.exit(f"chip_smoke: a card held no shard ({name})")
        with open(accs["four"], "rb") as f, open(accs["one"], "rb") as g:
            if f.read() != g.read():
                sys.exit(f"chip_smoke: {name} acc.csv differs between four "
                         f"cards and one")
        log(f"{name}: four-card acc.csv byte-identical to one-card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1
    check_device(n_cards)
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    devs = phase_device(n_cards)
    tag = card()
    if args.four:
        phase_four(tag)
    else:
        phase_kernels(tag)
        phase_golden()
        phase_big(tag)
    shutil.rmtree(WORK, ignore_errors=True)
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
