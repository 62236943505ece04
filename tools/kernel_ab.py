#!/usr/bin/env python3
"""End-to-end A/B of the Pallas kernels against the plain XLA paths on the
bench `big` deployment (k=32), on one GPU, in one process.

The kernels are chosen where the code asks `jax.default_backend() == "gpu"`
(ops/sw.py `_sw_align_device`, pipeline/peaks.py `_vote_core`). For the
plain side this tool answers "cpu" to that question while the device stays
the GPU, clearing JAX's trace caches at each switch so the other path is
traced again. Timed passes run kernel, plain, plain, kernel; each switch is
followed by one untimed pass that traces (and compiles) the other path.
Every pass prints its wall and stage walls, and all passes must write the
same acc.csv.

Usage: python tools/kernel_ab.py
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import jax

    import bench
    import chip_smoke
    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.pipeline.bkp import detect_breakpoint
    from localhgt_tpu.utils import compile_cache, metrics

    chip_smoke.check_device(1)
    compile_cache.configure()
    tag = chip_smoke.card()
    work = os.path.join(ROOT, ".bench", "kernel_ab")
    ref, fq1, fq2, truth = bench.fixture("big", work)
    cfg = Config().replace(kmer=KmerConfig(k=32))
    real_backend = jax.default_backend
    outputs = set()
    acc_path = os.path.join(work, "big.acc.csv")

    def run(side: str, timed: int) -> None:
        jax.clear_caches()
        jax.default_backend = (real_backend if side == "kernel"
                               else (lambda: "cpu"))
        try:
            for i in range(1 + timed):
                metrics.reset()
                t0 = time.perf_counter()
                acc = detect_breakpoint(ref, fq1, fq2, "big", work, cfg=cfg)
                wall = time.perf_counter() - t0
                with open(acc, "rb") as f:
                    outputs.add(f.read())
                print(f"{side} pass {i}{' (compiles)' if i == 0 else ''}: "
                      f"{wall:.2f} s stage walls "
                      f"{json.dumps(metrics.stage_walls())} [{tag}]",
                      flush=True)
        finally:
            jax.default_backend = real_backend

    for side, timed in (("kernel", 1), ("plain", 2), ("kernel", 1)):
        run(side, timed)
    if len(outputs) != 1:
        print("kernel_ab: acc.csv differs between paths", flush=True)
        return 1
    score, n_bkp = chip_smoke._score(acc_path, truth)
    print(f"kernel_ab: acc.csv identical on every pass; {n_bkp} breakpoints, "
          f"recall {score.recall:.4f}, FDR {score.fdr:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
