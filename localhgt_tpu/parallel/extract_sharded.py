"""Production multi-chip extraction: the full `extract_ref` stage under a
device mesh, with the REAL table dtypes and the REAL lookup structures.

Design (SPMD over one flat mesh axis "x"; SURVEY.md section 2.5's
"designed, not ported" distributed layer):

* **Count tables sharded, queries move.** The int8 [2^k] / packed int32
  [2^(k-3)] tables shard on dim 0 across devices. Read batches shard across
  the same axis: every device hashes + rank-caps its OWN shard (1/n of the
  sort work — the count step's hot op), then the compacted (sorted hash,
  capped delta) streams are all_gathered (a few MB) and every device
  scatters the slice-local subset into its table shard. Equivalent to the
  single-device semantics min(total_occurrences, cap) — per-shard caps sum
  then clip to exactly that (the deterministic replacement for the
  reference's benign counter races, cpp:1082-1085).
* **Scan: distributed gather.** Position blocks (with window+2k halo) shard
  across "x"; per-position table lookups move the *queries* over ICI
  (all_gather), each device answers for its table slice, and a psum_scatter
  returns combined counts to the block owner — the tables (GBs) never
  replicate. Blocks from ALL contigs batch into one fixed-shape dispatch
  stream, so dispatch count tracks reference size / block, not contig count.
* **Vote: replicated rank-select map.** The hash->peak structure in sharded
  mode is always the RankMap (word bitmap + prefix popcounts + pids in hash
  order; ~8 B per stored k-mer plus the 2^(k-4)-int bitmap) — small enough
  to replicate, so vote lookups are local; per-shard vote tallies merge
  with one psum. The 2^k direct map is a single-chip luxury, not worth a
  distributed lookup per read position.
* **Peakset build:** member hashing is replicated (cheap, chunk-local);
  the count-table presence filter uses the distributed gather; the rank map
  builds from the replicated pair stream with the same scatter passes as the
  single-device build (scatter-max pid == the reference's last-writer
  overwrite), so it is deterministic and identical on every device.

Interval outputs are bit-identical to the single-device `extract()` (the
dedupe order is unified across build paths), asserted by
`tests/test_sharded_extract.py` and the driver's `dryrun_multichip`.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from localhgt_tpu.config import Config
from localhgt_tpu.io import fasta, fastq
from localhgt_tpu.ops import count, encode, scan
from localhgt_tpu.pipeline import extract as extract_mod
from localhgt_tpu.pipeline import peaks as peaks_mod

log = logging.getLogger("localhgt_tpu.sharded")

SENTINEL = np.uint32(0xFFFFFFFF)


def make_flat_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("x",))


def _shard_x(mesh: Mesh, x):
    return jax.device_put(
        x, NamedSharding(mesh, P("x", *([None] * (np.ndim(x) - 1)))))


def _replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))


# --------------------------------------------------------------------------
# stage A: sharded counting
# --------------------------------------------------------------------------


def _local_slice_bounds(table_local_len: int):
    x = jax.lax.axis_index("x")
    return x.astype(jnp.int32) * table_local_len


def _scatter_slice_plain(t, s, c, cap: int, clip: bool):
    """Scatter a gathered (hash, delta) stream into an int8 table slice."""
    size = t.shape[0]
    lo = _local_slice_bounds(size)
    idx = s.astype(jnp.int32) - lo  # valid hashes < 2^30 fit int32
    mine = (s != jnp.uint32(SENTINEL)) & (idx >= 0) & (idx < size)
    idx = jnp.where(mine, idx, size)
    t = t.at[idx].add(jnp.where(mine, c, 0), mode="drop")
    if clip:
        t = jnp.minimum(t, jnp.int8(cap))
    return t


def _scatter_slice_packed(t, s, c, cap: int):
    """Packed slice update via an int8 per-hash delta + saturating fold.

    Per-batch deltas can reach n_shards*cap > 15, so they accumulate in a
    transient int8 delta array (one byte per hash of this slice) and fold
    into the 4-bit fields with min(field+delta, cap) — exact min(total, cap)
    semantics, no nibble carry at any shard count."""
    words = t.shape[0]
    n_hash = words << count.PACKED_SHIFT_BITS
    lo = _local_slice_bounds(words) << count.PACKED_SHIFT_BITS
    idx = (s - lo.astype(jnp.uint32)).astype(jnp.int32)
    mine = (s != jnp.uint32(SENTINEL)) & (idx >= 0) & (idx < n_hash)
    idx = jnp.where(mine, idx, n_hash)
    d = jnp.zeros(n_hash, jnp.int8).at[idx].add(
        jnp.where(mine, c, 0), mode="drop")
    d = d.reshape(words, 1 << count.PACKED_SHIFT_BITS).astype(jnp.int32)
    acc = jnp.zeros_like(t)
    for f in range(1 << count.PACKED_SHIFT_BITS):
        fld = (t >> (4 * f)) & 15
        acc = acc | (jnp.minimum(fld + d[:, f], cap) << (4 * f))
    return acc


def make_count_step(mesh: Mesh, k: int, cap: int, coder_num: int,
                    clip: bool):
    """Jitted sharded count step: (tables, codes, lengths, accept, masks)
    -> tables. Tables sharded P("x"); reads sharded P("x")."""
    packed = k > count.TABLE_BITS

    def step(tables, codes, lengths, accept, masks):
        h, v = encode.canonical_hashes(jnp, codes, masks, k)
        L = codes.shape[-1]
        inwin = jnp.arange(L, dtype=jnp.int32)[None, :] <= (lengths[:, None] - k)
        valid = v & inwin & accept[:, None]
        C = h.shape[0]
        s, c = count.capped_batch_delta_multi(h.reshape(C, -1),
                                              valid.reshape(-1), cap)
        s_all = jax.lax.all_gather(s, "x")      # [n, C, m] compacted stream
        c_all = jax.lax.all_gather(c, "x")
        out = []
        for i, t in enumerate(tables):
            si = s_all[:, i, :].reshape(-1)
            ci = c_all[:, i, :].reshape(-1)
            if packed:
                out.append(_scatter_slice_packed(t, si, ci, cap))
            else:
                out.append(_scatter_slice_plain(t, si, ci, cap, clip))
        return tuple(out)

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(tuple(P("x") for _ in range(coder_num)),
                  P("x", None), P("x"), P("x"), P()),
        out_specs=tuple(P("x") for _ in range(coder_num)),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(0,))


def count_kmers_sharded(mesh: Mesh, fq1, fq2, masks, cfg: Config,
                        batch_reads: int = 1 << 16):
    """Stage A over the mesh. Returns (tables sharded, ratio, n_pairs)."""
    k = cfg.kmer.k
    cap = cfg.kmer.least_depth
    n = mesh.devices.size
    packed = k > count.TABLE_BITS
    tables = tuple(_shard_x(mesh, count.make_table(k))
                   for _ in range(cfg.kmer.coder_num))
    ratio = fastq.downsample_ratio(cfg.kmer.sample, fq1)
    masks_j = _replicate(mesh, jnp.asarray(masks))
    # every shard applies n rank-capped streams per batch: int8 headroom
    # shrinks n-fold; packed slices fold+clip inside the step every batch
    clip_every = 1 if packed else max(1, 120 // max(n * cap, 1) - 2)
    step = make_count_step(mesh, k, cap, cfg.kmer.coder_num,
                           clip=(clip_every == 1 and not packed))
    n_pairs = 0
    width = None
    since_clip = 0
    for path in (fq1, fq2):
        for b in fastq.iter_fastq_batches(path, batch_reads=batch_reads,
                                          threads=cfg.threads):
            if width is None:
                width = extract_mod._batch_width(b.codes.shape[1])
            acc = fastq.accept_mask(b.start_ordinal, b.n, ratio,
                                    cfg.kmer.seed, cfg.kmer.strict_sampling)
            codes, lengths, acc = extract_mod._pad_read_batch(
                b, acc, batch_reads, width)
            tables = step(
                tables, _shard_x(mesh, codes), _shard_x(mesh, lengths),
                _shard_x(mesh, acc), masks_j,
            )
            since_clip += 1
            if not packed and since_clip >= clip_every:
                tables = _clip_sharded(tables, cap)
                since_clip = 0
            if path == fq1:
                n_pairs += b.n
    tables = _clip_sharded(tables, cap)
    return tables, ratio, n_pairs


@partial(jax.jit, static_argnames=("cap",), donate_argnums=(0,))
def _clip_sharded(tables, cap: int):
    # elementwise; XLA keeps the P("x") sharding
    return count.clip_tables(tables, cap)


# --------------------------------------------------------------------------
# stage B: sharded scan over position blocks
# --------------------------------------------------------------------------


def _distributed_lookup(t, q):
    """Counts for replicated-per-rank queries q against the x-sharded table
    slice t: all ranks hold the same q; each answers for its slice; psum
    combines. Returns int32 counts, replicated."""
    if count.is_packed(t):
        words = t.shape[0]
        lo_h = _local_slice_bounds(words) << count.PACKED_SHIFT_BITS
        idx = (q - lo_h.astype(jnp.uint32)).astype(jnp.int32)
        n_hash = words << count.PACKED_SHIFT_BITS
        mine = (idx >= 0) & (idx < n_hash)
        widx = jnp.where(mine, idx >> count.PACKED_SHIFT_BITS, 0)
        word = t[widx]
        shift = ((q & jnp.uint32(7)) << jnp.uint32(2)).astype(jnp.int32)
        ans = jnp.where(mine, (word >> shift) & 15, 0)
    else:
        size = t.shape[0]
        lo = _local_slice_bounds(size)
        idx = q.astype(jnp.int32) - lo
        mine = (idx >= 0) & (idx < size)
        ans = jnp.where(mine, t[jnp.where(mine, idx, 0)].astype(jnp.int32), 0)
    return jax.lax.psum(ans, "x")


def make_scan_step(mesh: Mesh, k: int, scan_cfg, cap: int, coder_num: int):
    """Jitted sharded scan step over halo blocks.

    codes_blocks [NB, Lc] and true_lens [NB] shard over "x"; each device
    hashes its blocks locally and the table lookups ride the distributed
    gather (queries all_gather over "x", answers psum_scatter back)."""

    def step(tables, codes_blocks, true_lens, masks):
        h, v = encode.canonical_hashes(jnp, codes_blocks, masks, k)  # [C,b,L]
        hq = jax.lax.all_gather(h, "x")          # [n, C, b, L]
        rows = []
        for i, t in enumerate(tables):
            qi = hq[:, i]
            if count.is_packed(t):
                words = t.shape[0]
                lo_h = _local_slice_bounds(words) << count.PACKED_SHIFT_BITS
                idx = (qi - lo_h.astype(jnp.uint32)).astype(jnp.int32)
                n_hash = words << count.PACKED_SHIFT_BITS
                mine = (idx >= 0) & (idx < n_hash)
                word = t[jnp.where(mine, idx >> count.PACKED_SHIFT_BITS, 0)]
                shift = ((qi & jnp.uint32(7)) << jnp.uint32(2)).astype(jnp.int32)
                ans = jnp.where(mine, (word >> shift) & 15, 0)
            else:
                size = t.shape[0]
                lo = _local_slice_bounds(size)
                idx = qi.astype(jnp.int32) - lo
                mine = (idx >= 0) & (idx < size)
                ans = jnp.where(
                    mine, t[jnp.where(mine, idx, 0)].astype(jnp.int32), 0)
            cnt = jax.lax.psum_scatter(ans, "x", scatter_dimension=0,
                                       tiled=False)       # [b, L] mine
            rows.append(cnt)
        hc_all = jnp.stack(rows).astype(jnp.int8)          # [C, b, L]
        hc_all = jnp.where(v[None] & (h != 0), hc_all, 0)

        def one(hc, tl):
            g, p = scan.scan_hits(jnp, hc, k, scan_cfg, cap, true_len=tl)
            return jnp.packbits(g), jnp.packbits(p)

        return jax.vmap(one, in_axes=(1, 0), out_axes=0)(hc_all, true_lens)

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(tuple(P("x") for _ in range(coder_num)),
                  P("x", None), P("x"), P()),
        out_specs=(P("x", None), P("x", None)),
        check_vma=False,
    )
    return jax.jit(fn)


def scan_reference_sharded(mesh: Mesh, tables, contigs: fasta.Contigs,
                           masks, cfg: Config,
                           block: int = 1 << 18):
    """Stage B: all contigs' halo blocks in one fixed-shape dispatch stream
    (dispatch count ~ reference_bp / (block * n_devices), independent of
    contig count). Returns per_contig peak lists like
    extract.scan_reference."""
    k = cfg.kmer.k
    halo = cfg.scan.window + 4 * k + 64
    n = mesh.devices.size
    Lc = block + 2 * halo
    masks_j = _replicate(mesh, jnp.asarray(masks))
    step = make_scan_step(mesh, k, cfg.scan, cfg.kmer.least_depth,
                          cfg.kmer.coder_num)

    # host: carve every contig into core blocks with halo context
    blocks = []           # (cid, core_start, core_len)
    for cid in range(1, contigs.n + 1):
        L = contigs.length_of(cid)
        if L <= k:
            continue
        for s in range(0, L, block):
            blocks.append((cid, s, min(block, L - s)))
    good = {cid: np.zeros(contigs.length_of(cid), bool)
            for cid in range(1, contigs.n + 1)}
    peak = {cid: np.zeros(contigs.length_of(cid), bool)
            for cid in range(1, contigs.n + 1)}
    NB = max(n, 8)
    for base in range(0, len(blocks), NB):
        chunk = blocks[base : base + NB]
        codes_b = np.full((NB, Lc), 4, np.uint8)
        lens_b = np.zeros(NB, np.int32)
        for j, (cid, s, ln) in enumerate(chunk):
            cs = max(0, s - halo)
            seq = contigs.contig_codes(cid)[cs : s + ln + halo]
            codes_b[j, : len(seq)] = seq
            lens_b[j] = len(seq)
        gb, pb = step(tables, _shard_x(mesh, jnp.asarray(codes_b)),
                      _shard_x(mesh, jnp.asarray(lens_b)), masks_j)
        gb = np.unpackbits(np.asarray(gb), axis=1).astype(bool)
        pb = np.unpackbits(np.asarray(pb), axis=1).astype(bool)
        for j, (cid, s, ln) in enumerate(chunk):
            cs = max(0, s - halo)
            good[cid][s : s + ln] = gb[j][s - cs : s - cs + ln]
            peak[cid][s : s + ln] = pb[j][s - cs : s - cs + ln]
    per_contig = []
    total_peaks = 0
    for cid in range(1, contigs.n + 1):
        if contigs.length_of(cid) <= k:
            continue
        ivs = scan.good_intervals(good[cid], cfg.scan.window,
                                  pad=cfg.scan.good_pad)
        pos, mem, gid = scan.peaks_in_intervals(peak[cid], ivs,
                                                cfg.scan.merge_close_peak)
        if total_peaks + len(pos) > cfg.scan.max_peak:
            keep = max(0, cfg.scan.max_peak - total_peaks)
            sel = gid < keep
            pos, mem, gid = pos[:keep], mem[sel], gid[sel]
        total_peaks += len(pos)
        per_contig.append((cid, pos, mem, gid))
        if total_peaks >= cfg.scan.max_peak:
            break
    return per_contig


# --------------------------------------------------------------------------
# peakset build (sharded count filter) + vote (replicated rank map)
# --------------------------------------------------------------------------


def make_collect_step(mesh: Mesh, k: int, coder_num: int):
    def step(tables, codes_flat, gpos, pids, masks):
        h, v = encode.canonical_hashes(jnp, codes_flat[None, :], masks, k)
        h = h[:, 0, :]
        v = v[0, :]
        hm = h[:, gpos]
        ok = v[gpos][None, :] & (hm != 0) & (pids != 0)[None, :]
        for i, t in enumerate(tables):
            cnt = _distributed_lookup(t, hm[i])
            ok = ok.at[i].set(ok[i] & (cnt > 0))
        SEN = jnp.uint32(0xFFFFFFFF)
        # coder-major flatten (no [n, C] transpose); order is irrelevant
        # under scatter-max dedupe
        keys = jnp.where(ok, hm, SEN).reshape(-1)
        vals = jnp.broadcast_to(pids[None, :], hm.shape).reshape(-1)
        vals = jnp.where(keys == SEN, 0, vals)
        return keys, vals

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(tuple(P("x") for _ in range(coder_num)), P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def build_peakset_sharded(mesh: Mesh, per_contig, contigs, tables, masks,
                          k: int) -> peaks_mod.PeakSet:
    pcontig, ppos, gpos, pids = peaks_mod._flatten_members(
        per_contig, contigs, k, consume=True)
    total = len(contigs.codes)
    masks_j = _replicate(mesh, jnp.asarray(masks))
    step = make_collect_step(mesh, k, len(tables))
    CH = peaks_mod.MAP_BUILD_CHUNK

    def pair_batches():
        """Replicated (hash, pid) pair batches: every device computes the
        same stream, so the rank-map scatter passes stay replicated and
        deterministic."""
        for base in range(0, max(total, 1), CH):
            m = (gpos >= base) & (gpos < base + CH)
            if not m.any():
                continue
            gp = (gpos[m] - base).astype(np.int32)
            pd = pids[m]
            ncap = max(256, 1 << (len(gp) - 1).bit_length())
            gp_p = np.zeros(ncap, np.int32)
            gp_p[: len(gp)] = gp
            pd_p = np.zeros(ncap, np.int32)
            pd_p[: len(gp)] = pd
            codes_chunk = np.full(CH + k, 4, np.uint8)
            avail = contigs.codes[base : base + CH + k]
            codes_chunk[: len(avail)] = avail
            yield step(tables, _replicate(mesh, jnp.asarray(codes_chunk)),
                       _replicate(mesh, jnp.asarray(gp_p)),
                       _replicate(mesh, jnp.asarray(pd_p)), masks_j)

    rmap = peaks_mod.build_rankmap_device(pair_batches, k)
    return peaks_mod.PeakSet(
        contig=pcontig, pos=ppos,
        sorted_hash=np.zeros(0, np.uint32),
        sorted_peak=np.zeros(0, np.int32),
        rmap=rmap,
    )


def make_vote_step(mesh: Mesh, k: int, min_base_num: int):
    def step(peak_filter, codes1, len1, codes2, len2, accept, masks,
             rank_wp, rank_pids, pc):
        def cands(codes, lengths):
            h, v = encode.canonical_hashes(jnp, codes, masks, k)
            L = codes.shape[-1]
            inwin = (jnp.arange(L, dtype=jnp.int32)[None, :]
                     <= (lengths[:, None] - k))
            return peaks_mod._candidates_from_h(
                h, v & inwin, jnp.zeros(0, jnp.uint32),
                jnp.zeros(0, jnp.int32), False,
                rank_wp, rank_pids, True)

        delta = peaks_mod._vote_core(
            jnp.zeros_like(peak_filter), cands(codes1, len1),
            cands(codes2, len2), pc, accept, min_base_num, 8)
        return peak_filter + jax.lax.psum(delta, "x")

    fn = shard_map(
        step, mesh=mesh,
        in_specs=(P(), P("x", None), P("x"), P("x", None), P("x"), P("x"),
                  P(), P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def vote_peaks_sharded(mesh: Mesh, pset, fq1, fq2, masks, cfg: Config,
                       ratio, batch_reads: int = 1 << 15) -> np.ndarray:
    if pset.rmap is None:
        return np.zeros(pset.n + 1, np.int32)
    k = cfg.kmer.k
    rank_wp = _replicate(mesh, jnp.asarray(pset.rmap.wp))
    rank_pids = _replicate(mesh, jnp.asarray(pset.rmap.pids))
    pc = _replicate(mesh, jnp.asarray(pset.contig.astype(np.int32)))
    masks_j = _replicate(mesh, jnp.asarray(masks))
    pf = _replicate(mesh, jnp.zeros(pset.n + 1, jnp.int32))
    step = make_vote_step(mesh, k, cfg.scan.min_base_num)
    width = None
    for b1, b2 in fastq.paired_batches(fq1, fq2, batch_reads=batch_reads,
                                       threads=cfg.threads):
        if width is None:
            width = extract_mod._batch_width(
                max(b1.codes.shape[1], b2.codes.shape[1]))
        acc = fastq.accept_mask(b1.start_ordinal, b1.n, ratio,
                                cfg.kmer.seed, cfg.kmer.strict_sampling)
        c1, l1, acc_p = extract_mod._pad_read_batch(b1, acc, batch_reads, width)
        c2, l2, _ = extract_mod._pad_read_batch(b2, acc, batch_reads, width)
        pf = step(pf, _shard_x(mesh, jnp.asarray(c1)),
                  _shard_x(mesh, jnp.asarray(l1)),
                  _shard_x(mesh, jnp.asarray(c2)),
                  _shard_x(mesh, jnp.asarray(l2)),
                  _shard_x(mesh, jnp.asarray(acc_p)),
                  masks_j, rank_wp, rank_pids, pc)
    return np.asarray(pf)


# --------------------------------------------------------------------------
# the full sharded stage
# --------------------------------------------------------------------------


def extract_sharded(fq1: str, fq2: str, contigs: fasta.Contigs,
                    cfg: Config, mesh: Mesh | None = None,
                    scan_block: int = 1 << 18) -> extract_mod.ExtractResult:
    """Multi-chip `extract()`: same inputs, same outputs, sharded stages.

    Interval output matches the single-device path exactly (deterministic
    collectives; unified dedupe order)."""
    import time as _time

    mesh = mesh or make_flat_mesh()
    masks, _ = encode.hasher_for(cfg.kmer.k, cfg.kmer.coder_num,
                                 cfg.kmer.seed)
    t = _time.time()
    log.info("stage A (x%d): k-mer counting", mesh.devices.size)
    tables, ratio, n_pairs = count_kmers_sharded(mesh, fq1, fq2, masks, cfg)
    jax.block_until_ready(tables)
    log.info("counted %d pairs (ratio %.4f) in %.1fs", n_pairs, ratio,
             _time.time() - t)

    t = _time.time()
    per_contig = scan_reference_sharded(mesh, tables, contigs, masks, cfg,
                                        block=scan_block)
    n_raw = sum(len(p) for _, p, _, _ in per_contig)
    log.info("raw candidate peaks: %d in %.1fs", n_raw, _time.time() - t)

    t = _time.time()
    pset = build_peakset_sharded(mesh, per_contig, contigs, tables, masks,
                                 cfg.kmer.k)
    log.info("peakset (%d peaks) built in %.1fs", pset.n, _time.time() - t)

    t = _time.time()
    votes = vote_peaks_sharded(mesh, pset, fq1, fq2, masks, cfg, ratio)
    log.info("vote pass in %.1fs", _time.time() - t)

    kept = np.flatnonzero(votes[1:] >= cfg.scan.min_reads) + 1
    contig_lens = {cid: contigs.length_of(cid)
                   for cid in range(1, contigs.n + 1)}
    pairs = sorted(
        ((int(pset.contig[p]), int(pset.pos[p])) for p in kept))
    intervals = scan.final_intervals(
        pairs, cfg.scan.ref_near, cfg.scan.ref_gap, contig_lens)
    bed = []
    final = []
    for cid, s, e in intervals:
        if e - s < cfg.scan.min_frag_len:
            continue
        final.append((cid, s, e))
        bed.append(f"{contigs.name_of(cid)}:{s}-{e}")
    log.info("kept %d peaks -> %d intervals", len(kept), len(final))
    return extract_mod.ExtractResult(final, bed, pset, votes, n_pairs, ratio)
