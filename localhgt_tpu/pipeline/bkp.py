"""End-to-end HGT breakpoint detection (`localhgt bkp` equivalent).

Orchestrates the full device-native pipeline (reference call stack: SURVEY.md
section 3.1, pipeline.sh):

    extract (k-mer stage, unless use_kmer=0)         extract_ref + get_bed
 -> sub-reference + seed index                       samtools faidx + bwa index
 -> seed-and-extend alignment of all read pairs      bwa mem | samtools
 -> insert-size estimate                             getInsertSize
 -> discordant-pair clustering -> raw junctions      get_raw_bkp.py
 -> split-read SW refinement -> precise breakpoints  accurate_bkp.py
 -> near-duplicate removal -> <sample>.acc.csv       remove_repeat.py

No files pass between stages except the final CSV (and optional bed/interval
files for inspection) — the file-bus design of the reference is replaced by
in-memory arrays (SURVEY.md section 1 closing note).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from localhgt_tpu.config import Config
from localhgt_tpu.index import reference
from localhgt_tpu.io import fastq
from localhgt_tpu.pipeline import accbkp, align, extract, rawbkp
from localhgt_tpu.utils import formats

log = logging.getLogger("localhgt_tpu.bkp")


class CompactRows:
    """Row-indexable view over a sparse subset of rows (the split-read code
    sequences accbkp needs — ~0.1% of reads), so the full [n_reads, width]
    code matrix (GBs at 13M pairs) never stays resident. Rows not kept at
    construction raise, which is the contract: callers index only rows they
    selected (aln.contig2 >= 0)."""

    def __init__(self, row_ids: np.ndarray, data: np.ndarray):
        self.row_ids = row_ids  # sorted global row indices
        self.data = data

    @classmethod
    def concat(cls, parts: list, width: int) -> "CompactRows":
        if not parts:
            return cls(np.zeros(0, np.int64), np.zeros((0, width), np.uint8))
        return cls(np.concatenate([p[0] for p in parts]),
                   np.concatenate([p[1] for p in parts]))

    def has(self, i: int) -> bool:
        """Whether row i was retained. Callers selecting rows by any
        predicate other than `contig2 >= 0` must check this at selection
        time so a loosened filter fails there, not mid-loop in accbkp."""
        j = int(np.searchsorted(self.row_ids, i))
        return j < len(self.row_ids) and self.row_ids[j] == i

    def __getitem__(self, i: int) -> np.ndarray:
        j = int(np.searchsorted(self.row_ids, i))
        if j >= len(self.row_ids) or self.row_ids[j] != i:
            raise KeyError(f"read row {i} was not retained (not a split read)")
        return self.data[j]


def detect_breakpoint(
    ref_path: str,
    fq1: str,
    fq2: str,
    sample: str,
    outdir: str,
    cfg: Config | None = None,
    use_kmer: bool = True,
    read_info: bool = True,
    refine_fq: bool = False,
    mesh=None,
) -> str:
    """Run breakpoint detection; returns the path of <sample>.acc.csv.

    `mesh`: a jax.sharding.Mesh to run the extraction stage multi-chip
    (parallel.extract_sharded — interval output identical to single-device);
    pass "auto" to use all visible devices when more than one is present
    (the CLI default). None = single-device extract."""
    from localhgt_tpu.utils import validate

    cfg = cfg or Config()
    validate.check_bkp_inputs(ref_path, fq1, fq2, outdir)
    from localhgt_tpu.utils import hostmem

    hostmem.cap_mmap_threshold()  # see utils/hostmem.py: glibc retention
    t0 = time.time()
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(message)s", datefmt="%H:%M:%S",
    )

    if refine_fq:
        # fastp-equivalent QC (refine_fastq, infer_HGT_breakpoint.py:99-109)
        from localhgt_tpu.io import qc

        r1 = os.path.join(outdir, f"{sample}_refined_1.fq")
        r2 = os.path.join(outdir, f"{sample}_refined_2.fq")
        st = qc.refine_fastq(fq1, fq2, r1, r2)
        log.info("qc: %d/%d pairs kept, %d adapter trims",
                 st.pairs_out, st.pairs_in, st.adapter_trimmed)
        fq1, fq2 = r1, r2

    contigs = reference.build(ref_path)
    log.info("reference: %d contigs, %d bp", contigs.n, len(contigs.codes))

    if mesh in ("auto", "force"):
        import jax

        want = mesh == "force" or len(jax.devices()) > 1
        mesh = None
        if want:
            from localhgt_tpu.parallel import extract_sharded as shx

            mesh = shx.make_flat_mesh()
            log.info("multi-chip extraction: %d devices", mesh.devices.size)

    if use_kmer:
        if mesh is not None:
            from localhgt_tpu.parallel import extract_sharded as shx

            res = shx.extract_sharded(fq1, fq2, contigs, cfg, mesh)
        else:
            res = extract.extract(fq1, fq2, contigs, cfg)
        intervals = res.intervals
        # numeric interval file + .bed, same formats as extract_ref +
        # get_bed_file.py produce (pipeline.sh:35-36)
        with open(os.path.join(outdir, f"{sample}.interval.txt"), "w") as f:
            for cid, s, e in intervals:
                f.write(f"{cid}\t{s}\t{e}\n")
        with open(os.path.join(outdir, f"{sample}.interval.txt.bed"), "w") as f:
            f.write("\n".join(res.bed) + ("\n" if res.bed else ""))
        log.info("extraction: %d intervals (%.1fs)", len(intervals), time.time() - t0)
    else:
        intervals = [
            (cid, 1, contigs.length_of(cid)) for cid in range(1, contigs.n + 1)
        ]

    from localhgt_tpu.utils import metrics

    subref = align.build_subref(contigs, intervals)
    metrics.add("n_intervals", len(intervals))
    metrics.add("subref_bp", len(subref.codes))
    log.info("sub-reference: %d segments, %d bp", len(subref.seg_off), len(subref.codes))
    if len(subref.codes) == 0:
        acc_path = os.path.join(outdir, f"{sample}.acc.csv")
        formats.write_acc_csv(acc_path, [], contigs, 0, 0)
        return acc_path
    index = align.SeedIndex.build(subref, cfg.align.seed_len)

    # --- align all read pairs ---
    t1 = time.time()
    _align_t = metrics.stage("align")
    _align_t.__enter__()
    tables1, tables2 = [], []
    codes1, codes2 = [], []
    n_pairs = 0
    # big batches: each align_batch is one SW dispatch, and per-dispatch
    # latency dominates small batches. On a
    # LARGE sub-reference (many intervals at scale — r3 saw 87k intervals /
    # ~130 Mbp on the 1 Gbp fixture) seed hits per read multiply, so the
    # batch shrinks to bound the per-batch hit/grouping temporaries.
    batch_reads = 1 << 16 if len(subref.codes) < (32 << 20) else 1 << 14
    use_pf = bool(len(index.prefix32)) and \
        os.environ.get("LHT_SEED_PREFILTER", "1") != "0"
    # the stage-A code cache feeds alignment directly: no FASTQ re-read,
    # and device-tier entries run the seed prefilter with no H2D upload
    # either. Only usable with the prefilter on — without it, the host
    # seeding path needs the smaller batch_reads granularity at scale.
    cache = getattr(res, "cache", None) if use_kmer else None
    if cache is not None and (
        not use_pf
        or any(e1.n != e2.n for e1, e2 in zip(cache[fq1], cache[fq2]))
    ):
        cache = None

    def raw_batches():
        """(pf1_input, l1, c1_np, l1_np, pf2_input, l2, c2_np, l2_np, n)"""
        if cache is not None:
            for e1, e2 in zip(cache[fq1], cache[fq2]):
                yield (e1.codes, e1.lengths, e1.codes_np, e1.lengths_np,
                       e2.codes, e2.lengths, e2.codes_np, e2.lengths_np,
                       e1.n)
            return
        width = None
        for b1, b2 in fastq.paired_batches(fq1, fq2, batch_reads=batch_reads,
                                           threads=cfg.threads):
            if width is None:
                width = max(
                    64,
                    -(-max(b1.codes.shape[1], b2.codes.shape[1]) // 64) * 64)
            out = []
            for b in (b1, b2):
                c = _pad_to(b.codes, width)
                ln = np.minimum(b.lengths, width).astype(np.int32)
                if b.n < batch_reads:  # pow2 bucket for stable jit shapes
                    target = max(256, 1 << (b.n - 1).bit_length())
                    c = np.concatenate(
                        [c, np.full((target - b.n, width), 4, np.uint8)])
                    ln = np.concatenate(
                        [ln, np.zeros(target - b.n, np.int32)])
                out.extend([c, ln, c, ln])
            yield (*out, b1.n)

    def enqueue(item):
        c1d, l1d, c1n, l1n, c2d, l2d, c2n, l2n, n = item
        pf1 = (align.seed_prefilter_device(c1d, l1d, index)
               if use_pf else None)
        pf2 = (align.seed_prefilter_device(c2d, l2d, index)
               if use_pf else None)
        return c1n, l1n, c2n, l2n, n, pf1, pf2

    from collections import deque

    ALIGN_LOOKAHEAD = 4
    q = deque()
    it = raw_batches()
    done = False
    row_base = 0
    width = None
    while True:
        while not done and len(q) < ALIGN_LOOKAHEAD:
            try:
                q.append(enqueue(next(it)))
            except StopIteration:
                done = True
        if not q:
            break
        c1n, l1n, c2n, l2n, n, pf1, pf2 = q.popleft()
        width = c1n.shape[1]
        B = c1n.shape[0]
        ids = np.arange(row_base, row_base + B, dtype=np.int64)
        ids[n:] = -1
        batch_t = {}
        for mate, cn, ln, pfm, codes_all in (
            (0, c1n, l1n, pf1, codes1), (1, c2n, l2n, pf2, codes2),
        ):
            t = align.align_batch(
                subref, index, cn, ln, ids, mate, cfg.align,
                threads=cfg.threads, mesh=mesh,
                pf_mask=np.asarray(pfm) if pfm is not None else None)
            t = _crop_table(t, n)
            batch_t[mate] = t
            # retain code sequences ONLY for split candidates (contig2 >= 0):
            # accbkp.make_split_reads reads nothing else (keyed by global
            # read_id), and the full code matrix would hold ~n_pairs *
            # width * 2 bytes of host RAM (~4 GB at the 13M-pair headline
            # workload) for the entire run
            keep = np.flatnonzero(t.contig2 >= 0)
            codes_all.append((keep + row_base, cn[keep]))
        # drop pairs with NO mapped end before accumulating: rawbkp and
        # accbkp's AlnIndex only ever select rows with a mapped end (the
        # tables must stay positionally paired, so one shared mask), and
        # at reference scale ~99% of reads never touch the sub-reference —
        # accumulating them held GBs of host RAM at the 1 Gbp scale run
        keep_pair = (batch_t[0].contig > 0) | (batch_t[1].contig > 0)
        tables1.append(_take_rows(batch_t[0], keep_pair))
        tables2.append(_take_rows(batch_t[1], keep_pair))
        row_base += n
        n_pairs += n
    a1 = align.AlnTable.concat(tables1)
    a2 = align.AlnTable.concat(tables2)
    if cache is not None:  # free the code cache (HBM + host) before accbkp
        cache.clear()
        res.cache = None
    codes1 = CompactRows.concat(codes1, width or 64)
    codes2 = CompactRows.concat(codes2, width or 64)
    mapped = int(((a1.contig > 0) | (a2.contig > 0)).sum())
    metrics.add("mapped_pairs", mapped)
    _align_t.__exit__(None, None, None)
    log.info("aligned %d pairs (%d with a mapped end) in %.1fs",
             n_pairs, mapped, time.time() - t1)

    # --- breakpoint calling ---
    with metrics.stage("rawbkp"):
        ins = rawbkp.estimate_insert(a1, a2, cfg.bkp)
        log.info("read length %d, insert size %d (n=%d)",
                 ins.rlen, ins.insert_size, ins.n)
        raw = rawbkp.call_raw_bkps(a1, a2, ins, cfg.bkp)
    log.info("raw junctions: %d", len(raw))

    with metrics.stage("accbkp"):
        accs = accbkp.find_accurate_bkps(
            raw, a1, a2, codes1, codes2, contigs, ins, cfg.bkp,
            subref if use_kmer else None, read_info=read_info,
        )
        accs = formats.dedup_rows(accs, cfg.bkp.dedup_cutoff)
    log.info("final breakpoints: %d", len(accs))

    acc_path = os.path.join(outdir, f"{sample}.acc.csv")
    formats.write_acc_csv(acc_path, accs, contigs, 2 * n_pairs, ins.insert_size)
    log.info("total %.1fs -> %s", time.time() - t0, acc_path)
    return acc_path


def _pad_to(codes: np.ndarray, width: int) -> np.ndarray:
    if codes.shape[1] >= width:
        return codes[:, :width]
    out = np.full((codes.shape[0], width), 4, np.uint8)
    out[:, : codes.shape[1]] = codes
    return out


def _crop_table(t: align.AlnTable, n: int) -> align.AlnTable:
    return align.AlnTable(
        **{f: getattr(t, f)[:n] for f in t.__dataclass_fields__}
    )


def _take_rows(t: align.AlnTable, mask: np.ndarray) -> align.AlnTable:
    return align.AlnTable(
        **{f: getattr(t, f)[mask] for f in t.__dataclass_fields__}
    )
