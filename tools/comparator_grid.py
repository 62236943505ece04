#!/usr/bin/env python3
"""Comparator grid over simulation scenarios (VERDICT r3 ask #8).

Runs the three-way comparator (localhgt_tpu k-mer pipeline, direct mode,
the compiled reference extract_ref engine's extraction stage) over the
paper harness's scenario axes — SNP rate, depth, community complexity
(simulation.py:339-817 scenario functions scored by evaluation.py) — and
commits one table. LEMON itself is not installable in this image
(no conda; run_lemon.sh needs its packaged toolchain); any LEMON-format
CSV dropped as <workdir>/lemon.csv joins its fixture's rows, same as
tools/comparator_run.py.

Writes reports/comparator_grid.csv + .json.

Usage: python tools/comparator_grid.py [workdir]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import comparator_run  # noqa: E402  (sibling tool, same directory)

from localhgt_tpu.utils import compile_cache  # noqa: E402

# scenario axes mirror sim/grid.py SCENARIOS (the paper harness grids)
GRID = [
    ("snp0.01_depth10_n20", dict(snp_rate=0.01, depth=10, n_genomes=20)),
    ("snp0.03_depth10_n20", dict(snp_rate=0.03, depth=10, n_genomes=20)),
    ("snp0.05_depth10_n20", dict(snp_rate=0.05, depth=10, n_genomes=20)),
    ("snp0.01_depth5_n20", dict(snp_rate=0.01, depth=5, n_genomes=20)),
    ("snp0.01_depth30_n20", dict(snp_rate=0.01, depth=30, n_genomes=20)),
    ("snp0.01_depth10_n40", dict(snp_rate=0.01, depth=10, n_genomes=40)),
]


def main():
    from localhgt_tpu.sim.simulate import SimParams

    compile_cache.configure()

    base = sys.argv[1] if len(sys.argv) > 1 else "/tmp/lht_comp_grid"
    k = int(os.environ.get("LHT_BENCH_K", "32"))
    results = []
    for label, kw in GRID:
        wd = os.path.join(base, label)
        pa = SimParams(genome_len=150_000, hgt_num=10, seed=42, **kw)
        out = comparator_run.run(wd, k, pa=pa, fixture_label=label)
        out["scenario"] = label
        results.append(out)
        print(json.dumps({"scenario": label,
                          "rows": {n: {kk: vv for kk, vv in r.items()
                                       if kk in ("recall", "fdr", "f1",
                                                 "extraction_truth_coverage",
                                                 "wall_s")}
                                   for n, r in out["rows"].items()}}))

    rep = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reports")
    os.makedirs(rep, exist_ok=True)
    cols = ["scenario", "tool", "stage", "recall", "fdr", "f1", "n_called",
            "extraction_truth_coverage", "n_intervals", "wall_s", "cpu_s",
            "max_rss_gb"]
    with open(os.path.join(rep, "comparator_grid.csv"), "w") as f:
        f.write(",".join(cols) + "\n")
        for out in results:
            for name, row in out["rows"].items():
                f.write(",".join([out["scenario"], name]
                                 + [str(row.get(c, "")) for c in cols[2:]])
                        + "\n")
    with open(os.path.join(rep, "comparator_grid.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"-> {rep}/comparator_grid.csv")


if __name__ == "__main__":
    main()
