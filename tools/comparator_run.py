#!/usr/bin/env python3
"""Recorded comparator table (r2 VERDICT ask #9).

Head-to-head on one simulated truth fixture (the paper harness's comparator
flow, paper_results/evaluation.py + run_lemon.sh — LEMON itself is not
installable here, but any LEMON-format CSV dropped into the workdir as
lemon.csv joins the table via evaluate.read_comparator_csv):

  * localhgt_tpu (k-mer extraction pipeline, the product default)
  * localhgt_tpu direct mode (use_kmer=0 — the reference's ground-truth
    mode, infer_HGT_breakpoint.py:36-97)
  * the reference's compiled extract_ref engine — extraction stage only
    (its downstream needs bwa/samtools, absent here), scored as
    extraction-stage truth coverage (evaluation.py:64-76)

Each row: recall / FDR / F1 at +-50 bp, wall seconds, host CPU + max RSS.
Writes <workdir>/comparator.csv and prints JSON; the committed artifact
lives at reports/comparator.csv.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("LHT_FORCE_CPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def run(workdir: str = "/tmp/lht_comp", k: int = 32, pa=None,
        fixture_label: str = "species20 snp0.01 depth10 seed42") -> dict:
    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.pipeline.bkp import detect_breakpoint
    from localhgt_tpu.sim import evaluate
    from localhgt_tpu.sim.simulate import SimParams, read_truth, simulate_sample
    from localhgt_tpu.tools import ab_reference

    os.makedirs(workdir, exist_ok=True)
    pa = pa or SimParams(n_genomes=20, genome_len=150_000, hgt_num=10,
                         depth=10, snp_rate=0.01, seed=42)
    ref, fq1, fq2, truth_path = simulate_sample(workdir, "cmp", pa)
    truth = read_truth(truth_path)
    true_bkps = evaluate.truth_to_bkps(truth)
    true_loci = [(r, p) for (r, p, _, _) in true_bkps] + \
        [(r, p) for (_, _, r, p) in true_bkps]
    cfg = Config().replace(kmer=KmerConfig(k=k, strict_sampling=True))

    table = {}

    def bkp_row(name, **kw):
        t0 = time.time()
        r0 = evaluate.resource_usage()
        acc = detect_breakpoint(ref, fq1, fq2, name, workdir, cfg=cfg, **kw)
        wall = time.time() - t0
        r1 = evaluate.resource_usage()
        calls = evaluate.read_localhgt_csv(acc)
        s = evaluate.score_bkps(true_bkps, calls)
        table[name] = {
            "stage": "full bkp pipeline",
            "recall": s.recall, "fdr": s.fdr, "f1": s.f1,
            "n_called": s.n_called, "wall_s": round(wall, 1),
            "cpu_s": round(r1["cpu_user_s"] + r1["cpu_sys_s"]
                           - r0["cpu_user_s"] - r0["cpu_sys_s"], 1),
            "max_rss_gb": r1["max_rss_gb"],
        }

    bkp_row("localhgt_tpu")
    bkp_row("localhgt_tpu_direct", use_kmer=False)

    # reference engine: extraction stage (interval truth coverage + wall)
    binary = ab_reference.compile_reference(workdir)
    if binary is not None:
        t0 = time.time()
        ref_ivs = ab_reference.run_reference_extract(
            binary, fq1, fq2, ref, workdir, cfg, threads=1)
        wall = time.time() - t0
        cov = _coverage(ref_ivs, true_loci)
        table["reference_extract_ref"] = {
            "stage": "extraction only (downstream needs bwa/samtools)",
            "extraction_truth_coverage": cov, "n_intervals": len(ref_ivs),
            "wall_s": round(wall, 1),
        }
        our_ivs = ab_reference.run_extract(fq1, fq2, ref, cfg)
        table["localhgt_tpu_extract_stage"] = {
            "stage": "extraction only (same scoring as the row above)",
            "extraction_truth_coverage": _coverage(our_ivs, true_loci),
            "n_intervals": len(our_ivs),
        }
    else:
        table["reference_extract_ref"] = {"skipped": "no g++/source"}

    # any LEMON-format CSV present joins the table (run_lemon.sh flow)
    lemon = os.path.join(workdir, "lemon.csv")
    if os.path.isfile(lemon):
        s = evaluate.score_bkps(true_bkps, evaluate.read_comparator_csv(lemon))
        table["lemon"] = {"stage": "full (external run)", "recall": s.recall,
                          "fdr": s.fdr, "f1": s.f1}

    out = {"fixture": fixture_label, "k": k,
           "tolerance_bp": 50, "rows": table}
    csv_path = os.path.join(workdir, "comparator.csv")
    cols = ["tool", "stage", "recall", "fdr", "f1", "n_called",
            "extraction_truth_coverage", "n_intervals", "wall_s", "cpu_s",
            "max_rss_gb"]
    with open(csv_path, "w") as f:
        f.write(",".join(cols) + "\n")
        for name, row in table.items():
            f.write(",".join([name] + [str(row.get(c, "")) for c in cols[1:]])
                    + "\n")
    return out


def _coverage(intervals, true_loci, tol: int = 50) -> float:
    """Fraction of true breakpoint loci inside the extracted intervals
    +-tol (check_if_bkp_in_extracted_ref, evaluation.py:64-76)."""
    hit = 0
    for r, p in true_loci:
        for name, s, e in intervals:
            if name == r and s - tol <= p <= e + tol:
                hit += 1
                break
    return round(hit / max(len(true_loci), 1), 4)


if __name__ == "__main__":
    wd = sys.argv[1] if len(sys.argv) > 1 else "/tmp/lht_comp"
    k = int(os.environ.get("LHT_BENCH_K", "32"))
    print(json.dumps(run(wd, k)))
