#!/usr/bin/env python3
"""Per-stage truth-loss table for a bench fixture (VERDICT r3 ask #6).

Runs the bkp pipeline on the given fixture while tracking, for every truth
breakpoint pair, where it survives:

    truth -> extraction intervals -> aligned split/cross support
          -> raw junctions -> accurate bkps -> final acc.csv

Writes reports/loss_table_<scale>.json (one record per truth bkp, plus a
stage summary) so a recall drop is attributable to a single stage from the
artifact alone. Matching tolerance is the reference's +-50 bp
(evaluation.py:22,138-187).

Usage: [LHT_BENCH_SCALE=big] python tools/loss_table.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

TOL = 50


def main():
    from localhgt_tpu.config import Config, KmerConfig
    from localhgt_tpu.index import reference
    from localhgt_tpu.io import fastq
    from localhgt_tpu.pipeline import accbkp, align, bkp as bkp_mod, extract, rawbkp
    from localhgt_tpu.sim.simulate import read_truth
    from localhgt_tpu.utils import compile_cache, formats

    import bench

    compile_cache.configure()
    scale = os.environ.get("LHT_BENCH_SCALE", "big")
    fx = bench.FIXTURE_DIR
    ref = os.path.join(fx, f"bench_{scale}.ref.fa")
    fq1 = os.path.join(fx, f"bench_{scale}.1.fq")
    fq2 = os.path.join(fx, f"bench_{scale}.2.fq")
    truth_path = os.path.join(fx, f"bench_{scale}.true.sv.txt")
    for p in (ref, fq1, fq2, truth_path):
        if not os.path.isfile(p):
            sys.exit(f"fixture missing: {p} (run bench.py first)")
    k = int(os.environ.get("LHT_BENCH_K", "32"))
    cfg = Config().replace(kmer=KmerConfig(k=k))
    outdir = os.path.join(fx, f"run_{scale}")
    os.makedirs(outdir, exist_ok=True)

    truth = read_truth(truth_path)
    # truth bkp pairs: (receptor, insert_locus, donor, seg_start/seg_end)
    tb = []
    for t in truth:
        tb.append((t.receptor, t.insert_locus, t.donor, t.seg_start))
        tb.append((t.receptor, t.insert_locus, t.donor, t.seg_end))

    contigs = reference.build(ref)
    name2id = {contigs.name_of(c): c for c in range(1, contigs.n + 1)}

    t0 = time.time()
    res = extract.extract(fq1, fq2, contigs, cfg)
    print(f"extract: {len(res.intervals)} intervals in {time.time()-t0:.0f}s")

    # stage 1: both endpoints inside an (padded) emitted interval
    iv_by_c = {}
    for cid, s, e in res.intervals:
        iv_by_c.setdefault(cid, []).append((s, e))

    def covered(name, pos):
        cid = name2id.get(name)
        return any(pos >= s - TOL and pos <= e + TOL
                   for s, e in iv_by_c.get(cid, []))

    # run the alignment + calling exactly as detect_breakpoint does
    subref = align.build_subref(contigs, res.intervals)
    index = align.SeedIndex.build(subref, cfg.align.seed_len)
    tables1, tables2, codes1, codes2 = [], [], [], []
    n_pairs = 0
    batch_reads = 1 << 16 if len(subref.codes) < (32 << 20) else 1 << 14
    width = None
    row_base = 0
    for b1, b2 in fastq.paired_batches(fq1, fq2, batch_reads=batch_reads,
                                       threads=cfg.threads):
        if width is None:
            width = max(64, -(-max(b1.codes.shape[1], b2.codes.shape[1]) // 64) * 64)
        ids = np.arange(b1.start_ordinal, b1.start_ordinal + b1.n)
        batch_t = {}
        for b, mate, codes_all in ((b1, 0, codes1), (b2, 1, codes2)):
            c = bkp_mod._pad_to(b.codes, width)
            ln = np.minimum(b.lengths, width)
            if b.n < batch_reads:
                target = max(256, 1 << (b.n - 1).bit_length())
                c = np.concatenate([c, np.full((target - b.n, width), 4, np.uint8)])
                ln = np.concatenate([ln, np.zeros(target - b.n, np.int32)])
                full_ids = np.concatenate([ids, np.full(target - b.n, -1, np.int64)])
            else:
                full_ids = ids
            t = align.align_batch(subref, index, c, ln, full_ids, mate,
                                  cfg.align, threads=cfg.threads)
            t = bkp_mod._crop_table(t, b.n)
            batch_t[mate] = t
            keep = np.flatnonzero(t.contig2 >= 0)
            codes_all.append((keep + row_base, c[keep]))
        keep_pair = (batch_t[0].contig > 0) | (batch_t[1].contig > 0)
        tables1.append(bkp_mod._take_rows(batch_t[0], keep_pair))
        tables2.append(bkp_mod._take_rows(batch_t[1], keep_pair))
        row_base += b1.n
        n_pairs += b1.n
    a1 = align.AlnTable.concat(tables1)
    a2 = align.AlnTable.concat(tables2)
    codes1 = bkp_mod.CompactRows.concat(codes1, width or 64)
    codes2 = bkp_mod.CompactRows.concat(codes2, width or 64)
    print(f"aligned {n_pairs} pairs, kept {len(a1)} rows")

    ins = rawbkp.estimate_insert(a1, a2, cfg.bkp)
    raw = rawbkp.call_raw_bkps(a1, a2, ins, cfg.bkp)
    accs = accbkp.find_accurate_bkps(raw, a1, a2, codes1, codes2, contigs,
                                     ins, cfg.bkp, subref, read_info=True)
    final = formats.dedup_rows(accs, cfg.bkp.dedup_cutoff)

    # stage 2: aligned evidence near the truth junction — cross pairs and
    # split reads linking (c1 near p1) <-> (c2 near p2)
    win = max(ins.insert_size, 500)

    def support(c1, p1, c2, p2):
        i1, i2 = name2id.get(c1), name2id.get(c2)
        cross = split = 0
        for x, y in ((a1, a2), (a2, a1)):
            m = (x.contig == i1) & (y.contig == i2) & \
                (np.abs(x.pos - p1) < win) & (np.abs(y.pos - p2) < win)
            cross += int(m.sum())
            s = (x.contig == i1) & (x.contig2 == i2) & \
                (np.abs(x.pos - p1) < win) & (np.abs(x.pos2 - p2) < win)
            split += int(s.sum())
        return cross, split

    def near_raw(c1, p1, c2, p2):
        i1, i2 = name2id.get(c1), name2id.get(c2)
        for r in raw:
            for (rc1, rp1, rc2, rp2) in ((r.c1, r.pos1, r.c2, r.pos2),
                                         (r.c2, r.pos2, r.c1, r.pos1)):
                if rc1 == i1 and rc2 == i2 and \
                        abs(rp1 - p1) < TOL and abs(rp2 - p2) < TOL:
                    return True
        return False

    def near_rows(rows, c1, p1, c2, p2):
        for r in rows:
            if isinstance(r, dict):
                f = (r["from_ref"], r["from_pos"], r["to_ref"], r["to_pos"])
            else:  # accbkp.AccBkp objects (contig ids + *_bkp coords)
                f = (r.from_ref, r.from_bkp, r.to_ref, r.to_bkp)
            for (rc1, rp1, rc2, rp2) in (f, (f[2], f[3], f[0], f[1])):
                rn1 = contigs.name_of(rc1) if isinstance(rc1, (int, np.integer)) else rc1
                rn2 = contigs.name_of(rc2) if isinstance(rc2, (int, np.integer)) else rc2
                if rn1 == c1 and rn2 == c2 and \
                        abs(int(rp1) - p1) < TOL and abs(int(rp2) - p2) < TOL:
                    return True
        return False

    records = []
    for (c1, p1, c2, p2) in tb:
        cross, split = support(c1, p1, c2, p2)
        rec = {
            "bkp": [c1, p1, c2, p2],
            "extracted": bool(covered(c1, p1) and covered(c2, p2)),
            "cross_pairs": cross,
            "split_reads": split,
            "raw": near_raw(c1, p1, c2, p2),
            "acc": near_rows(accs, c1, p1, c2, p2),
            "final": near_rows(final, c1, p1, c2, p2),
        }
        records.append(rec)

    summary = {
        "scale": scale, "k": k, "n_truth_bkps": len(tb),
        "extracted": sum(r["extracted"] for r in records),
        "has_cross": sum(r["cross_pairs"] > 0 for r in records),
        "has_split": sum(r["split_reads"] > 0 for r in records),
        "raw": sum(r["raw"] for r in records),
        "acc": sum(r["acc"] for r in records),
        "final": sum(r["final"] for r in records),
        "n_intervals": len(res.intervals),
        "subref_bp": int(len(subref.codes)),
        "insert_size": ins.insert_size,
    }
    rep = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "reports")
    os.makedirs(rep, exist_ok=True)
    out = os.path.join(rep, f"loss_table_{scale}.json")
    with open(out, "w") as f:
        json.dump({"summary": summary, "bkps": records}, f, indent=1)
    print(json.dumps(summary))
    lost = [r for r in records if not r["final"]]
    for r in lost:
        print("LOST:", json.dumps(r))
    print(f"-> {out}")


if __name__ == "__main__":
    main()
