"""Candidate-peak bookkeeping and the k-mer split-read vote.

Port of the Peaks/Split_reads machinery
(src/extract_ref_normal_peak.cpp:91-548): peaks found by the reference scan
get ids; the k-mers at each peak position (with table count > 0) map
hash -> peak id; a second pass over the read pairs votes, per pair, on which
genomes its peak k-mers support; a pair whose top-2 supported genomes both
have >= MIN_BASE_NUM voting bases bumps those genomes' first-seen peaks
(check_split, cpp:161-202). Peaks with >= MIN_READS votes become the final
extraction intervals.

The reference's 2^32-entry peak_kmer array (16 GB) is replaced by either
  * a **direct-address device map** int32[2^k] when it is at most
    MAX_DIRECT_MAP_BYTES (k <= 30: 4 GB) — one gather per query, or
  * a **rank-select map** (RankMap) for k > 30: a 32-bit-word presence
    bitmap with interleaved prefix popcounts plus a pids-in-hash-order
    array — 1.5-2 GB at k=32 vs 16 GB direct, and a lookup is 2 adjacent
    gathers + popcount + 1 gather (vs log2(K) dependent binary-search
    probes, which profiling showed dominated the vote pass).
Both are built **on device** with streaming scatter passes per <=2^22-bp
reference chunk: hash every reference position (bit-sliced, same kernel as
the scan), gather the member positions, filter by count-table hits, and
resolve duplicate hashes by scatter-MAX of the peak id — equal to the
reference's last-writer overwrite of peak_kmer[hash] in scan order (add_peak
cpp:239-286), because writes happen in ascending position order and pids
ascend with position, so the last writer is exactly the largest pid.
Every resident array is 1-D.
The sequential per-pair greedy genome selection (judge_base, cpp:118-159) runs
with a fixed G-slot genome register: a Pallas kernel on a GPU
(ops.pallas_vote), elsewhere a lax.scan over read positions vectorized over
the pair batch (vote_state_scan).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import numpy as np

from localhgt_tpu.ops import encode


@dataclass
class PeakSet:
    """Peak ids are 1-based; index 0 of every array is a sentinel."""

    contig: np.ndarray       # int32 [P+1] contig id of each peak
    pos: np.ndarray          # int64 [P+1] representative position
    sorted_hash: np.ndarray  # uint32 [K] peak k-mer hashes (sorted)
    sorted_peak: np.ndarray  # int32 [K] peak id per hash
    direct_map: object = None  # device int32 [2^k] hash -> peak id, or None
    rmap: "RankMap | None" = None  # k > 30: succinct hash -> peak id map
    cmap: "CuckooMap | None" = None  # k > 30 fast path (2 gathers/query)

    @property
    def n(self) -> int:
        return len(self.contig) - 1


@dataclass
class CuckooMap:
    """Two-table tagged cuckoo hash -> peak-id map: the k > 30 vote-lookup
    fast path (2 independent gathers per query vs the RankMap's 3; the
    lookup is gather-count-bound).

    Slot schemes (S = 2^bits slots per table, production bits = 28):
      T1[h & (S-1)]        stores tag = h >> bits  (colliders share the
                           low bits, so the top 32-bits bits identify the
                           key EXACTLY);
      T2[(h*MIX) >> bits]  on the bijectively mixed key (h * CUCKOO_MIX
                           mod 2^32 — canonical-min hashes skew low, see
                           cuckoo_lookup); tag = mixed low (32-bits) bits,
                           so (slot, tag) reconstructs the key exactly
                           via the inverse multiplier.
    A slot packs (tag << bits) | pid with pid in [1, 2^bits); empty = 0
    (pid 0 never exists, and a stored value is >= 1). Tag equality
    implies FULL key equality — zero false positives, so lookups are
    exact.

    The key is reconstructible from (table, slot, tag), which lets the
    device-side build detect displaced occupants without any host state
    (build_cuckoo_device). Placement needs load < 0.5 of total slots; at
    ~163M stored k-mers (the 100 Mbp big fixture) load is 0.30. Larger
    key sets (or pids >= 2^bits) fall back to the RankMap."""

    t1: object  # uint32 [2^bits] (device)
    t2: object  # uint32 [2^bits]
    k: int = 0   # hash width (T1 needs bits < k; T2 uses the mixed key)
    bits: int = 28


CUCKOO_BITS = 28                   # slots per table
CUCKOO_MAX_KEYS = 240_000_000      # ~0.45 load; beyond -> RankMap fallback


@dataclass
class RankMap:
    """Succinct hash -> peak-id map for k > 30, where the 2^k direct map
    exceeds HBM.

    Two 1-D arrays (1-D by design — see the module docstring's tiling note):

      wp:   int32 [2 * 2^(k-5)] interleaved (bit-word, exclusive-prefix
            popcount) pairs. Word i covers hashes [32i, 32i+32): bit
            (h & 31) of wp[2i] is set iff hash h is stored; wp[2i+1] is the
            number of stored hashes < 32i. The pair sits at adjacent
            addresses, so a lookup's two gathers land in one HBM line.
      pids: int32 [>= Ku] peak id of each stored hash, ascending hash order.

    Lookup (rank_lookup): i = h >> 5; present = wp[2i] >> (h & 31) & 1;
    rank = wp[2i+1] + popcount(wp[2i] & ((1 << (h & 31)) - 1));
    pid = present ? pids[rank] : 0.  Misses clamp the pids gather to row 0,
    which stays cache-resident — so the effective random HBM traffic per
    query is ~one line, the same as the k <= 30 direct map.

    Duplicate (hash, pid) pairs in the build stream resolve by scatter-MAX
    of the pid — equal to the reference's last-writer overwrite (add_peak
    cpp:239-286; see module docstring)."""

    wp: object    # int32 [2*W] (device or np)
    pids: object  # int32 [>= Ku]
    k: int = 0


def build_peakset(per_contig, contig_codes_fn, count_lookup, masks, k) -> PeakSet:
    """Collect peaks + their k-mers.

    Args:
        per_contig: list of (contig_id, positions, members, group_ids) from
            scan.peaks_in_intervals, in contig order.
        contig_codes_fn: contig_id -> uint8 code array.
        count_lookup: (hash_fn_index, uint32 hashes) -> counts; typically a
            device gather so the multi-GB tables never leave HBM.
        masks: hash masks.

    Duplicate hashes resolve to the MAX peak id, matching the reference's
    overwrite of peak_kmer[hash] in scan order (add_peak, cpp:239-286):
    writes ascend in position and pids ascend with position, so the last
    writer is the largest pid (see RankMap).
    """
    contigs = [0]
    positions = [0]
    all_hashes = []
    all_peaks = []
    pid_base = 0
    coder_num = masks.shape[0]
    for cid, pos, memb, gid in per_contig:
        if not len(pos):
            continue
        codes = contig_codes_fn(cid)
        contigs.extend([cid] * len(pos))
        positions.extend(int(p) for p in pos)
        # k-mers only exist for positions <= len-k (add_peak bounds check,
        # cpp:247,262: near_pos <= ref_len-k+1)
        sel = memb <= len(codes) - k
        mem = memb[sel]
        pids = gid[sel].astype(np.int32) + np.int32(pid_base + 1)
        pid_base += len(pos)
        if len(mem) == 0:
            continue
        win = codes[mem[:, None] + np.arange(k)[None, :]]
        h, v = encode.canonical_hashes(np, win, masks, k)  # [C, n, k] pos 0
        for i in range(coder_num):
            hv = h[i, :, 0]
            ok = v[:, 0] & (hv != 0)
            cnt = np.asarray(count_lookup(i, hv[ok]))
            keep = cnt > 0
            all_hashes.append(hv[ok][keep].astype(np.uint32))
            all_peaks.append(pids[ok][keep])
    if all_hashes:
        hs = np.concatenate(all_hashes)
        ps = np.concatenate(all_peaks)
        hs, ps = _dedupe_max_np(hs, ps)
    else:
        hs = np.zeros(0, np.uint32)
        ps = np.zeros(0, np.int32)
    return PeakSet(
        contig=np.asarray(contigs, np.int32),
        pos=np.asarray(positions, np.int64),
        sorted_hash=hs,
        sorted_peak=ps,
        rmap=build_rankmap_host(hs, ps, k),
    )


MAX_DIRECT_MAP_BYTES = 4 << 30  # int32 [2^k] fits beside the count tables


# --------------------------------------------------------------------------
# RankMap build + lookup (the k > 30 vote-lookup path)
# --------------------------------------------------------------------------


def _dedupe_max_np(hs: np.ndarray, ps: np.ndarray):
    """Unique hashes ascending, each with its MAX pid (see RankMap)."""
    order = np.lexsort((ps, hs))
    hs, ps = hs[order], ps[order]
    last = np.ones(len(hs), bool)
    last[:-1] = hs[1:] != hs[:-1]
    return hs[last], ps[last]


def _popcount_np(w: np.ndarray) -> np.ndarray:
    """SWAR popcount of a uint32 array (exact: byte sums <= 32 < 256)."""
    w = w.astype(np.uint32)
    x = w - ((w >> np.uint32(1)) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> np.uint32(2)) & np.uint32(0x33333333))
    x = (x + (x >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def _pids_cap(n: int) -> int:
    return max(128, -(-n // 128) * 128)


def build_rankmap_host(hs: np.ndarray, ps: np.ndarray, k: int):
    """Numpy mirror of build_rankmap_device for host-built peaksets (tests,
    the sharded dedupe path). hs need not be unique; duplicates resolve to
    max pid."""
    if len(hs) == 0:
        return None
    hs, ps = _dedupe_max_np(hs.astype(np.uint32), ps.astype(np.int32))
    W = 1 << max(k - 5, 0)
    w = np.zeros(W, np.uint32)
    h64 = hs.astype(np.uint64)
    np.bitwise_or.at(
        w, (h64 >> np.uint64(5)).astype(np.int64),
        (np.uint64(1) << (h64 & np.uint64(31))).astype(np.uint32))
    pc = _popcount_np(w)
    pref = np.cumsum(pc) - pc          # int64 (_popcount_np returns int64)
    if int(pc.sum()) >= 1 << 31:       # int32 interleave would truncate
        raise ValueError("rank map exceeds 2^31 stored k-mers; raise "
                         "--max_peak filtering or use k <= 30")
    wp = np.empty(2 * W, np.int32)
    wp[0::2] = w.view(np.int32)
    wp[1::2] = pref.astype(np.int32)
    pids = np.zeros(_pids_cap(len(ps)), np.int32)
    pids[: len(ps)] = ps
    return RankMap(wp=wp, pids=pids, k=k)


def rank_lookup(wp, pids, h):
    """Device lookup: pid per uint32 hash (0 where absent). See RankMap.
    Traceable — call inside a jit; all gathers are from 1-D arrays.

    The bit tests use 32-entry LUT gathers instead of per-element variable
    shifts."""
    import jax.numpy as jnp

    bit_lut = jnp.asarray([1 << b for b in range(32)], jnp.uint32)
    low_lut = jnp.asarray([(1 << b) - 1 for b in range(32)], jnp.uint32)
    wi = (h >> jnp.uint32(5)).astype(jnp.int32)  # < 2^27 at k = 32
    word = wp[2 * wi].astype(jnp.uint32)
    pref = wp[2 * wi + 1]
    bit = (h & jnp.uint32(31)).astype(jnp.int32)
    present = (word & bit_lut[bit]) != 0
    below = jax.lax.population_count(word & low_lut[bit])
    # misses clamp to row 0 so their gathers stay cache-resident
    rank = jnp.where(present, pref + below.astype(jnp.int32), 0)
    return jnp.where(present, pids[jnp.minimum(rank, pids.shape[0] - 1)], 0)


@partial(jax.jit, donate_argnums=(0,))
def _word_add(w, keys):
    """OR the keys' presence bits into int32 bit-words, with scatter-ADD
    made exact:

    XLA scatter has no OR combiner, and .at[].max of single-bit values
    loses bits placed by earlier batches (max != or) — the round-3 bug the
    first bitmap build shipped with. But scatter-add IS an exact OR when
    every added bit is provably not yet set: (1) sort+dedupe the batch, so
    unique keys within it map to unique (word, bit) cells (the key <->
    (word, bit) mapping is a bijection); (2) gather the current words and
    add only bits still 0, which filters duplicates from earlier batches.
    Distinct keys sharing a word add distinct bits — no carries.

    One sort of the ~3M-key batch (the count stage sorts bigger batches
    every step) + 1 gather + 1 scatter; replaces a byte-per-hash slab
    design whose bit-packing step cost 16 s/GB on strided uint8 slices."""
    import jax.numpy as jnp

    SEN = jnp.uint32(0xFFFFFFFF)
    kk = jnp.sort(keys)
    uniq = jnp.concatenate([jnp.ones(1, bool), kk[1:] != kk[:-1]]) \
        & (kk != SEN)
    wi = (kk >> jnp.uint32(5)).astype(jnp.int32)  # < 2^27 at k = 32
    bit = kk & jnp.uint32(31)
    cur = jax.lax.bitcast_convert_type(
        w[jnp.where(uniq, wi, 0)], jnp.uint32)
    absent = ((cur >> bit) & jnp.uint32(1)) == 0
    add = uniq & absent
    val = jax.lax.bitcast_convert_type(
        jnp.where(add, jnp.uint32(1) << bit, jnp.uint32(0)), jnp.int32)
    idx = jnp.where(add, wi, jnp.int32(w.shape[0]))
    return w.at[idx].add(val, mode="drop")


@jax.jit
def _words_to_wp(w):
    """Bit-words -> interleaved (word, exclusive-prefix-popcount) pairs +
    per-block partial key counts. All 1-D.

    The caller must total the partials EXACTLY on host (int64) and reject
    totals >= 2^31 before trusting wp: the int32 device cumsum wraps
    negative past 2^31, so an on-device int32 total would leave the
    overflow guard dead and the wp interleave silently corrupt (r3 ADVICE
    medium; int64 on device is unavailable without x64). Each block
    partial is <= 32 * 4096 = 2^17, so int32 partials are exact."""
    import jax.numpy as jnp

    pc = jax.lax.population_count(
        jax.lax.bitcast_convert_type(w, jnp.uint32)).astype(jnp.int32)
    pref = jnp.cumsum(pc) - pc
    W = w.shape[0]
    wp = jnp.zeros(2 * W, jnp.int32)
    wp = wp.at[0::2].set(w)
    wp = wp.at[1::2].set(pref)
    block = min(4096, W)  # W is a power of two
    partials = jnp.sum(pc.reshape(-1, block), axis=1)
    return wp, partials


@partial(jax.jit, donate_argnums=(0,))
def _scatter_pids(pids_arr, wp, keys, vals):
    """Scatter-max each live (key, pid) pair into pids_arr[rank(key)].
    Every live key was added to the bitmap first, so presence is
    guaranteed."""
    import jax.numpy as jnp

    SEN = jnp.uint32(0xFFFFFFFF)
    live = keys != SEN
    wi = (keys >> jnp.uint32(5)).astype(jnp.int32)
    wi = jnp.minimum(wi, wp.shape[0] // 2 - 1)  # sentinel rows: any in-range
    word = wp[2 * wi].astype(jnp.uint32)
    pref = wp[2 * wi + 1]
    bit = keys & jnp.uint32(31)
    below = jax.lax.population_count(
        word & ((jnp.uint32(1) << bit) - jnp.uint32(1)))
    rank = pref + below.astype(jnp.int32)
    oob = jnp.int32(pids_arr.shape[0])
    idx = jnp.where(live, rank, oob)
    return pids_arr.at[idx].max(jnp.where(live, vals, 0), mode="drop")


CUCKOO_MIX = 2654435761          # odd => bijective mod 2^32 (T2)
CUCKOO_MIX_INV = pow(CUCKOO_MIX, -1, 1 << 32)
CUCKOO_MIX1 = 2246822519         # independent odd multiplier (T1)
CUCKOO_MIX1_INV = pow(CUCKOO_MIX1, -1, 1 << 32)


def cuckoo_lookup(t1, t2, h, bits: int = CUCKOO_BITS):
    """Device lookup: pid per uint32 hash (0 where absent). Two independent
    1-D gathers; see CuckooMap for the exactness argument. Traceable
    (`bits` must be trace-static).

    T2 buckets on the BIJECTIVELY MIXED key (h * CUCKOO_MIX mod 2^32):
    canonical hashes are min(fwd, revcomp) and therefore skew LOW, which
    overloads the low T2 slots if bucketing on raw top bits (observed:
    real-data placement livelocked while uniform synthetic keys
    converged). The odd-multiplier mix is invertible, so (slot, tag)
    still reconstructs the key exactly."""
    import jax.numpy as jnp

    M = jnp.uint32((1 << bits) - 1)
    TAGM = jnp.uint32((1 << (32 - bits)) - 1)
    hm1 = h * jnp.uint32(CUCKOO_MIX1)
    hm2 = h * jnp.uint32(CUCKOO_MIX)
    v1 = t1[(hm1 & M).astype(jnp.int32)]
    v2 = t2[(hm2 >> jnp.uint32(32 - bits)).astype(jnp.int32)]
    hit1 = (v1 != 0) & ((v1 >> jnp.uint32(bits)) == (hm1 >> jnp.uint32(bits)))
    hit2 = (v2 != 0) & ((v2 >> jnp.uint32(bits)) == (hm2 & TAGM))
    # MAX over both tables: duplicate-key copies may settle in both (see
    # _cuckoo_round's domination rules); the max is the reference's
    # last-writer/max-pid resolution (see RankMap)
    pid = jnp.maximum(jnp.where(hit1, v1 & M, 0),
                      jnp.where(hit2, v2 & M, 0))
    return jax.lax.bitcast_convert_type(pid, jnp.int32)


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("use_t1", "bits", "evict"))
def _cuckoo_round(table, keys, pids, salt, use_t1: bool,
                  bits: int = CUCKOO_BITS, evict: bool = True):
    """One placement round: scatter-SET (key, pid) packs into one table
    (arbitrary winner per contested slot — true cuckoo eviction: ANY
    occupant can be knocked out, which a scatter-max cannot do), read
    back, and classify every pool entry.

    Duplicate keys (same key, different pids — common in the member
    stream) resolve by DOMINATION instead of a pre-pass dedupe: a copy
    finding its own key in the slot with pid >= its own is dominated and
    leaves the pool; a displaced same-key occupant with pid <= the
    winner's is likewise discarded rather than re-pooled. Copies may
    settle in both tables; cuckoo_lookup takes the MAX over both, which
    is exactly the reference's last-writer/max-pid resolution (RankMap).

    Returns (table, status int8 [N], disp_keys uint32 [N], disp_pids
    int32 [N]): status 0 = placed or dominated (leaves the pool), 1 =
    loser (retries the other table); `disp_*` are occupants knocked out
    of overwritten slots (SENTINEL key where none), reconstructed
    entirely from the old packed value — possible because (table, slot,
    tag) determines the key (see CuckooMap)."""
    import jax.numpy as jnp

    SEN = jnp.uint32(0xFFFFFFFF)
    present = keys != SEN
    # damped attempts (salt != 0): only a pseudorandom half of the pool
    # inserts this round. Batch-parallel cuckoo displacement livelocks
    # without this — displaced cohorts re-displace each other in lockstep
    # (observed as a stable ~134k-entry oscillation on the big fixture);
    # the asymmetric half breaks the cycles. salt == 0 attempts all.
    att = (((keys * (salt | jnp.uint32(1))) >> jnp.uint32(20))
           & jnp.uint32(1)) == (salt & jnp.uint32(1))
    att = att | (salt == 0)
    live = present & att
    defer = present & ~att
    if use_t1:
        # T1 on mixed-key LOW bits: raw low bits of adjacent-position
        # k-mer hashes are shift-related (the coder hash is a sliding
        # window), so consecutive peak members saturate local slot
        # clusters; mixing restores the uniformity cuckoo needs
        km = keys * jnp.uint32(CUCKOO_MIX1)
        slot = (km & jnp.uint32((1 << bits) - 1)).astype(jnp.int32)
        tag = km >> jnp.uint32(bits)
    else:
        # T2 on the mixed key's TOP bits (see cuckoo_lookup: the
        # canonical-min skew overloads raw top bits)
        km = keys * jnp.uint32(CUCKOO_MIX)
        slot = (km >> jnp.uint32(32 - bits)).astype(jnp.int32)
        tag = km & jnp.uint32((1 << (32 - bits)) - 1)
    PIDM = jnp.uint32((1 << bits) - 1)
    mypid = jax.lax.bitcast_convert_type(pids, jnp.uint32)
    pack = (tag << jnp.uint32(bits)) | mypid
    idx = jnp.where(live, slot, jnp.int32(table.shape[0]))
    old = table[jnp.where(live, slot, 0)]
    if evict:
        # true cuckoo eviction: ANY occupant can be knocked out
        table = table.at[idx].set(jnp.where(live, pack, 0), mode="drop")
    else:
        # mass-placement rounds: scatter-MAX kills same-key duplicate
        # populations in ONE round (every smaller-pid copy sees a >=-pid
        # winner and is dominated below; a .set round only halves them,
        # which serialized heavy genomic repeats for dozens of rounds)
        table = table.at[idx].max(jnp.where(live, pack, 0), mode="drop")
    new = table[jnp.where(live, slot, 0)]
    placed = live & (new == pack)
    same_key_new = (new >> jnp.uint32(bits)) == tag
    # dominated: my own key holds the slot with pid >= mine — this copy
    # is redundant (max resolution) and leaves the pool
    dominated = live & ~placed & same_key_new & ((new & PIDM) >= mypid)
    keep = (live & ~placed & ~dominated) | defer  # stays in the pool
    status = keep.astype(jnp.int8)
    # displaced occupant: existed, lost the slot, and is NOT a dominated
    # duplicate of the winner (same key with pid <= the winner's). Only
    # the slot's winner reports it, so an occupant re-enters exactly once.
    same_key_old = (old >> jnp.uint32(bits)) == tag
    disp = placed & (old != 0) & (old != pack) \
        & ~(same_key_old & ((old & PIDM) <= mypid))
    if use_t1:
        km_old = ((old >> jnp.uint32(bits)) << jnp.uint32(bits)) \
            | jax.lax.bitcast_convert_type(slot, jnp.uint32)
        okey = km_old * jnp.uint32(CUCKOO_MIX1_INV)  # un-mix
    else:
        km_old = (jax.lax.bitcast_convert_type(slot, jnp.uint32)
                  << jnp.uint32(32 - bits)) | (old >> jnp.uint32(bits))
        okey = km_old * jnp.uint32(CUCKOO_MIX_INV)  # un-mix
    disp_keys = jnp.where(disp, okey, SEN)
    disp_pids = jax.lax.bitcast_convert_type(
        jnp.where(disp, old & PIDM, 0), jnp.int32)
    # scalar counts only — the pool compaction happens on device
    # (_compact_pool_dev), so no O(N) mask ever crosses to the host
    n_keep = jnp.sum(keep.astype(jnp.int32))
    n_disp = jnp.sum(disp.astype(jnp.int32))
    return table, status, disp_keys, disp_pids, n_keep, n_disp


@jax.jit
def _dedupe_pool(keys, pids):
    """Sort + run-max dedupe of a (small) pool: duplicate keys collapse to
    their MAX pid. Heavy genomic repeats put thousands of same-key copies
    in the stream; copies starved out of both slots during the max phase
    otherwise circulate through the eviction rounds forever."""
    import jax.numpy as jnp
    from jax import lax

    ks, ps = lax.sort((keys, pids), dimension=0, num_keys=2)
    SEN = jnp.uint32(0xFFFFFFFF)
    is_last = jnp.concatenate([ks[:-1] != ks[1:], jnp.ones(1, bool)])
    live = is_last & (ks != SEN)
    return jnp.where(live, ks, SEN), jnp.where(live, ps, 0)


@partial(jax.jit, static_argnames=("cap",))
def _compact_pool_dev(keys, pids, status, disp_keys, disp_pids, cap: int):
    """Device compaction of the next round's pool (kept entries +
    displaced occupants) into a `cap`-row bucket, SENTINEL-padded. Only
    the pool COUNTS cross to the host; the index build runs on device."""
    import jax.numpy as jnp

    SEN = jnp.uint32(0xFFFFFFFF)
    N = keys.shape[0]
    allk = jnp.concatenate(
        [jnp.where(status == 1, keys, SEN), disp_keys,
         jnp.full(1, SEN, jnp.uint32)])
    allp = jnp.concatenate(
        [jnp.where(status == 1, pids, 0), disp_pids,
         jnp.zeros(1, jnp.int32)])
    idx = jnp.nonzero(allk != SEN, size=cap, fill_value=2 * N)[0]
    return allk[idx], allp[idx]  # fill rows hit the appended SENTINEL


def build_cuckoo_device(keys, pids, k: int, max_rounds: int = 48,
                        bits: int = CUCKOO_BITS):
    if bits >= 32:
        return None  # no tag bits left: no valid split
    """Place a (key uint32, pid int32) multiset into a CuckooMap ON
    DEVICE. SENTINEL (0xFFFFFFFF) key rows are dropped; duplicate keys
    resolve to the MAX pid (scatter-MAX placement — see _cuckoo_round), so
    callers feed the raw member pair stream with no dedupe pass. Returns
    None if placement does not converge (load too high; callers fall back
    to the RankMap).

    Iterative 2-choice insertion as data-parallel rounds: alternate
    tables; scatter the whole unplaced pool into one table, detect
    winners by readback, reconstruct displaced occupants from their
    packed values, carry losers + displaced forward. The pool shrinks
    geometrically at production load (~0.3), so total work is ~2x the
    first round's."""
    import jax.numpy as jnp

    import logging as _logging

    log = _logging.getLogger("localhgt_tpu.extract")
    keys = jnp.asarray(keys)
    pids = jnp.asarray(pids)
    t1 = jnp.zeros(1 << bits, jnp.uint32)
    t2 = jnp.zeros(1 << bits, jnp.uint32)
    MAX_PHASE = 6   # scatter-max rounds: mass placement + instant dedupe
    DAMP_START = 12  # then half-attempt damping breaks parallel livelock
    for r in range(max_rounds):
        use_t1 = (r % 2 == 0)
        salt = jnp.uint32(0 if r < DAMP_START
                          else (2654435761 * (r + 1)) & 0xFFFFFFFF)
        evict = r >= MAX_PHASE
        if use_t1:
            t1, status, dk, dp, n_keep, n_disp = _cuckoo_round(
                t1, keys, pids, salt, use_t1=True, bits=bits, evict=evict)
        else:
            t2, status, dk, dp, n_keep, n_disp = _cuckoo_round(
                t2, keys, pids, salt, use_t1=False, bits=bits, evict=evict)
        n_next = int(n_keep) + int(n_disp)  # two scalar D2H per round
        log.debug("cuckoo round %d: pool %d -> kept %d + displaced %d",
                  r, int(keys.shape[0]), int(n_keep), int(n_disp))
        if n_next == 0:
            return CuckooMap(t1=t1, t2=t2, k=k, bits=bits)
        cap = max(1024, 1 << (n_next - 1).bit_length())
        keys, pids = _compact_pool_dev(keys, pids, status, dk, dp, cap=cap)
        if cap <= (1 << 22):
            keys, pids = _dedupe_pool(keys, pids)
    return None


PAIR_CACHE_LIMIT = 2 << 30  # keep the (hash, pid) stream on device below 2 GB


def build_rankmap_device(pair_batches, k: int,
                         cache_limit: int = PAIR_CACHE_LIMIT):
    """RankMap built ON DEVICE from a (hash, pid) pair stream.

    Args:
        pair_batches: zero-arg callable returning an iterator of
            (keys uint32 [T], vals int32 [T]) device arrays, sentinel
            (0xFFFFFFFF) rows allowed. The batches are kept device-resident
            across passes while they fit `cache_limit`; otherwise the
            callable is re-invoked per pass (the member stream regenerates
            from the reference codes, which is cheaper than holding GBs of
            HBM).

    Streaming scatter passes only — no device-wide sort (batches sort
    individually, ~3M keys each) and no transient beyond the 2^(k-5)-word
    bit array (512 MB at k=32): pass 1 ORs presence bits via the exact
    add-if-absent scatter (_word_add), one popcount+cumsum turns them into
    the interleaved (word, prefix) pairs, and pass 2 scatter-maxes each pid
    at its key's rank. Returns a RankMap, or None if the stream is empty.
    """
    import jax.numpy as jnp

    cached = []
    cache_bytes = 0
    exhausted = False

    def replay():
        nonlocal cached, cache_bytes, exhausted
        if exhausted and cached is not None:
            yield from cached
            return
        for kv in pair_batches():
            if not exhausted and cached is not None:
                cached.append(kv)
                cache_bytes += kv[0].size * 8
                if cache_bytes > cache_limit:
                    cached = None
            yield kv
        exhausted = True

    w = jnp.zeros(1 << max(k - 5, 0), jnp.int32)
    for kk, vv in replay():
        w = _word_add(w, kk)
    wp, partials = _words_to_wp(w)
    del w
    # exact int64 total on host — the device cumsum is int32 and wraps
    # past 2^31, so the guard must not trust it (r3 ADVICE medium)
    ku = int(np.asarray(partials).astype(np.int64).sum())
    if ku == 0:
        return None
    if ku >= 1 << 31:  # int32 prefix (wp[1::2]) would be corrupt
        raise ValueError("rank map exceeds 2^31 stored k-mers; raise "
                         "--max_peak filtering or use k <= 30")
    pids = jnp.zeros(_pids_cap(ku), jnp.int32)
    for kk, vv in replay():
        pids = _scatter_pids(pids, wp, kk, vv)
    return RankMap(wp=wp, pids=pids, k=k)


def _flatten_members(per_contig, contigs, k, consume: bool = False):
    """Host: peak table (contig, pos) + flat member positions (global
    coordinates in the concatenated code array) with their peak ids.

    Vectorized over the (pos, mem, gid) arrays that scan.peaks_in_intervals
    emits — a UHGG-scale sample has millions of peaks / tens of millions of
    members, so no per-peak Python loops."""
    pcontig = [np.zeros(1, np.int32)]
    ppos = [np.zeros(1, np.int64)]
    gpos_all = []
    pid_all = []
    pid_base = 0
    # with consume=True the per-contig arrays are freed as they are
    # copied: at reference scale the member arrays are the dominant host
    # allocation (scale1g: ~500M members), and holding both the
    # per-contig copies and the flat concatenation peaked host RSS at
    # 42 GB against the reference's <25 GB envelope (README.md:6)
    for i in range(len(per_contig)):
        cid, pos, mem, gid = per_contig[i]
        if consume:
            per_contig[i] = None
        ln = contigs.length_of(cid)
        off = np.int64(contigs.offsets[cid - 1])
        pcontig.append(np.full(len(pos), cid, np.int32))
        ppos.append(np.asarray(pos, np.int64))
        # k-mers only exist for positions <= len-k (add_peak bounds check,
        # cpp:247,262)
        sel = mem <= ln - k
        gpos_all.append(mem[sel].astype(np.int64) + off)
        pid_all.append(gid[sel].astype(np.int32) + np.int32(pid_base + 1))
        pid_base += len(pos)
        del pos, mem, gid
    if consume:
        per_contig.clear()
    gpos = np.concatenate(gpos_all) if gpos_all else np.zeros(0, np.int64)
    gpos_all.clear()
    pids = np.concatenate(pid_all) if pid_all else np.zeros(0, np.int32)
    pid_all.clear()
    return (np.concatenate(pcontig), np.concatenate(ppos), gpos, pids)


@partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _build_map_chunk(direct_map, tables, codes_flat, gpos, pids, masks,
                     k: int):
    """One device dispatch: hash every reference position of this chunk,
    gather the peak-member hashes, keep those present in the count tables
    (count > 0, build_kmer_table cpp:246-270), scatter-MAX the peak ids into
    the direct map (== the reference's last-writer overwrite; see RankMap —
    max composes across chunks, so chunk order is irrelevant too).

    Padding rows carry pid 0 and are masked out; valid pids are >= 1."""
    import jax.numpy as jnp

    from localhgt_tpu.ops import count as count_mod

    h, v = encode.canonical_hashes(jnp, codes_flat[None, :], masks, k)
    h = h[:, 0, :]                    # [C, Lc]
    v = v[0, :]                       # [Lc]
    hm = h[:, gpos]                   # [C, n]
    ok = v[gpos][None, :] & (hm != 0) & (pids != 0)[None, :]
    for i, t in enumerate(tables):
        cnt = count_mod.table_lookup(t, hm[i])
        ok = ok.at[i].set(ok[i] & (cnt > 0))
    # valid hashes < 2^k <= 2^30 fit int32; masked rows go to a positive
    # out-of-bounds slot, which the scatter drops
    idx = jnp.where(ok, hm.astype(jnp.int32), jnp.int32(1 << k)).reshape(-1)
    vals = jnp.broadcast_to(pids[None, :], hm.shape).reshape(-1)
    vals = jnp.where(ok.reshape(-1), vals, 0)
    return direct_map.at[idx].max(vals, mode="drop")


MAP_BUILD_CHUNK = 1 << 22  # positions hashed per dispatch ([C, chunk] int32)


def build_direct_map(per_contig, contigs, tables, masks, k: int):
    """Device build of the hash -> peak-id map; returns a PeakSet whose
    `direct_map` is a device int32[2^k]. Reference chunks without any peak
    members are skipped, so the dispatch count tracks the peak intervals,
    not the reference length."""
    import jax.numpy as jnp

    pcontig, ppos, gpos, pids = _flatten_members(per_contig, contigs, k,
                                                 consume=True)
    direct_map = jnp.zeros(1 << k, jnp.int32)
    total = len(contigs.codes)
    masks_j = jnp.asarray(masks)
    for base in range(0, max(total, 1), MAP_BUILD_CHUNK):
        m = (gpos >= base) & (gpos < base + MAP_BUILD_CHUNK)
        if not m.any():
            continue
        gp = (gpos[m] - base).astype(np.int32)
        pd = pids[m]
        ncap = max(256, 1 << (len(gp) - 1).bit_length())
        gp_p = np.zeros(ncap, np.int32)
        gp_p[: len(gp)] = gp
        pd_p = np.zeros(ncap, np.int32)
        pd_p[: len(gp)] = pd
        codes_chunk = np.full(MAP_BUILD_CHUNK + k, 4, np.uint8)
        avail = contigs.codes[base : base + MAP_BUILD_CHUNK + k]
        codes_chunk[: len(avail)] = avail
        direct_map = _build_map_chunk(
            direct_map, tables, jnp.asarray(codes_chunk),
            jnp.asarray(gp_p), jnp.asarray(pd_p), masks_j, k=k,
        )
    return PeakSet(
        contig=pcontig, pos=ppos,
        sorted_hash=np.zeros(0, np.uint32), sorted_peak=np.zeros(0, np.int32),
        direct_map=direct_map,
    )


@partial(jax.jit, static_argnames=("k",))
def _hash_ref_chunk(codes_flat, masks, k: int):
    """Hash one reference chunk (bit-sliced, same kernel as the scan);
    returns (h uint32 [C, Lc], v bool [Lc]) device-resident for member
    gathering."""
    import jax.numpy as jnp

    h, v = encode.canonical_hashes(jnp, codes_flat[None, :], masks, k)
    return h[:, 0, :], v[0, :]


@jax.jit
def _member_batch(h, v, tables, gpos, pids):
    """Gather one fixed-size member sub-batch from a hashed chunk, filter by
    count-table presence (build_kmer_table cpp:246-270); returns (keys,
    vals) [C*n] with dropped rows as the SENTINEL key. Stream order is
    irrelevant — duplicates resolve by scatter-MAX (see RankMap) — so the
    flatten is coder-major, avoiding a [n, C] transpose. Fixed shape: one compile for the whole build
    regardless of per-chunk member counts."""
    import jax.numpy as jnp

    from localhgt_tpu.ops import count as count_mod

    hm = h[:, gpos]                   # [C, n]
    ok = v[gpos][None, :] & (hm != 0) & (pids != 0)[None, :]
    for i, t in enumerate(tables):
        cnt = count_mod.table_lookup(t, hm[i])
        ok = ok.at[i].set(ok[i] & (cnt > 0))
    SEN = jnp.uint32(0xFFFFFFFF)
    keys = jnp.where(ok, hm, SEN).reshape(-1)             # [C*n]
    vals = jnp.broadcast_to(pids[None, :], hm.shape).reshape(-1)
    vals = jnp.where(keys == SEN, 0, vals)
    return keys, vals


MEMBER_SUB = 1 << 20  # member positions gathered per fixed-shape dispatch


def _member_pair_batches(gpos, pids, contigs, tables, masks_j, k: int):
    """Yield the device-resident (hash, peak-id) pair stream for all peak
    members: hash each reference chunk once, gather members in fixed-shape
    sub-batches. SENTINEL rows interleave with live pairs.

    No dedupe: duplicate hashes keep every (hash, pid) entry, and the map
    builds resolve them by scatter-MAX of the pid — identical to the
    reference's last-writer overwrite (add_peak cpp:239-286) because pids
    are assigned in position-major order, so the last writer is exactly the
    largest pid."""
    import jax.numpy as jnp

    total = len(contigs.codes)
    # gpos ascending (contigs in order, members ascending): slice by range
    for base in range(0, max(total, 1), MAP_BUILD_CHUNK):
        lo = int(np.searchsorted(gpos, base))
        hi = int(np.searchsorted(gpos, base + MAP_BUILD_CHUNK))
        if hi == lo:
            continue
        codes_chunk = np.full(MAP_BUILD_CHUNK + k, 4, np.uint8)
        avail = contigs.codes[base : base + MAP_BUILD_CHUNK + k]
        codes_chunk[: len(avail)] = avail
        h, v = _hash_ref_chunk(jnp.asarray(codes_chunk), masks_j, k=k)
        for s in range(lo, hi, MEMBER_SUB):
            e = min(hi, s + MEMBER_SUB)
            gp_p = np.zeros(MEMBER_SUB, np.int32)
            gp_p[: e - s] = gpos[s:e] - base
            pd_p = np.zeros(MEMBER_SUB, np.int32)
            pd_p[: e - s] = pids[s:e]
            yield _member_batch(h, v, tables, jnp.asarray(gp_p),
                                jnp.asarray(pd_p))


def _member_pair_batches_pc(per_contig, pid_bases, contigs, tables, masks_j,
                            k: int):
    """_member_pair_batches walking the per-contig arrays DIRECTLY — the
    flat int64 (gpos, pids) stream is never materialized. At reference
    scale that stream is the dominant host allocation (scale1g: ~500M
    members x 12 bytes on top of the per-contig copies pushed host RSS
    past the reference's <25 GB envelope); the per-contig int32 members
    are kept as-is and sliced per reference chunk with searchsorted.

    per_contig entries are (cid, pos, mem int32 contig-relative, gid);
    pid_bases[i] is the number of peaks before entry i. Same stream
    contents and order as _member_pair_batches."""
    import jax.numpy as jnp

    total = len(contigs.codes)
    starts = [int(contigs.offsets[e[0] - 1]) for e in per_contig]
    for base in range(0, max(total, 1), MAP_BUILD_CHUNK):
        end = base + MAP_BUILD_CHUNK
        # member (chunk-relative pos, pid) pieces from contigs overlapping
        # this chunk; contigs are ordered by offset
        i0 = np.searchsorted(starts, base, side="right") - 1
        gp_list, pd_list = [], []
        for i in range(max(i0, 0), len(per_contig)):
            cid, pos, mem, gid = per_contig[i]
            off = starts[i]
            if off >= end:
                break
            ln = contigs.length_of(cid)
            if off + ln <= base or not len(mem):
                continue
            # k-mers only exist for positions <= len-k (add_peak bounds
            # check, cpp:247,262)
            lo = int(np.searchsorted(mem, base - off))
            hi = int(np.searchsorted(mem, min(end - off, ln - k + 1)))
            if hi <= lo:
                continue
            gp_list.append((mem[lo:hi].astype(np.int64) + off - base)
                           .astype(np.int32))
            pd_list.append(gid[lo:hi].astype(np.int32)
                           + np.int32(pid_bases[i] + 1))
        if not gp_list:
            continue
        gp = np.concatenate(gp_list)
        pd = np.concatenate(pd_list)
        codes_chunk = np.full(MAP_BUILD_CHUNK + k, 4, np.uint8)
        avail = contigs.codes[base : base + MAP_BUILD_CHUNK + k]
        codes_chunk[: len(avail)] = avail
        h, v = _hash_ref_chunk(jnp.asarray(codes_chunk), masks_j, k=k)
        for s in range(0, len(gp), MEMBER_SUB):
            e = min(len(gp), s + MEMBER_SUB)
            gp_p = np.zeros(MEMBER_SUB, np.int32)
            gp_p[: e - s] = gp[s:e]
            pd_p = np.zeros(MEMBER_SUB, np.int32)
            pd_p[: e - s] = pd[s:e]
            yield _member_batch(h, v, tables, jnp.asarray(gp_p),
                                jnp.asarray(pd_p))


def build_hash_peakset(per_contig, contigs, tables, masks, k: int,
                       tables_box: list | None = None):
    """Device-first peakset build for k > 30 (where the 2^k direct map does
    not fit HBM): member hashing, count filtering AND the map build all
    run on device — the member stream (GBs at reference scale) never
    crosses to the host, and the finished map is already device-resident
    for the vote.

    Default map: the 2-gather CuckooMap (collect the filtered pair stream
    device-side, free the count tables via `tables_box` — [tables] whose
    slot the caller cleared — then place). Falls back to the streaming
    RankMap build when the key set is too large for cuckoo load or
    placement fails."""
    import jax.numpy as jnp

    # peak table (small) + per-entry pid bases; the member stream walks
    # the per-contig int32 arrays directly (_member_pair_batches_pc) so
    # the flat int64 (gpos, pids) arrays are never materialized — at
    # scale1g they alone were ~10 GB of host RSS
    pcontig = [np.zeros(1, np.int32)]
    ppos = [np.zeros(1, np.int64)]
    pid_bases = []
    pid_base = 0
    n_members = 0
    for cid, pos, mem, gid in per_contig:
        pid_bases.append(pid_base)
        pcontig.append(np.full(len(pos), cid, np.int32))
        ppos.append(np.asarray(pos, np.int64))
        pid_base += len(pos)
        n_members += len(mem)
    pcontig = np.concatenate(pcontig)
    ppos = np.concatenate(ppos)
    masks_j = jnp.asarray(masks)
    n_peaks = len(pcontig) - 1

    def stream():
        t = tables_box[0] if tables_box is not None else tables
        return _member_pair_batches_pc(per_contig, pid_bases, contigs, t,
                                       masks_j, k)

    import os as _os

    cmap = None
    cbits = min(CUCKOO_BITS, k - 4)  # >= 4 tag bits per table
    # EXPERIMENTAL, default OFF: the 2-gather lookup works (equivalence
    # tests pass) but the batch-parallel placement stalls on real key
    # sets — displaced keys retry their single fixed alternate slot, so
    # eviction chains collide and ~40k keys circulate indefinitely
    # (uniform slot histograms rule out key clustering; the fix is a
    # BFS-matching build, not more damping). With the build fallback the
    # net cost exceeds the vote savings, so RankMap stays the default.
    use_cuckoo = (_os.environ.get("LHT_VOTE_CUCKOO", "0") == "1"
                  and cbits >= 8
                  and n_peaks + 1 < (1 << cbits)
                  and n_members * 3 < min(CUCKOO_MAX_KEYS,
                                          int(0.45 * (2 << cbits))))
    pair_replay = None  # device-resident pair stream once collected
    if use_cuckoo:
        kbatches, vbatches = [], []
        for kk, vv in stream():
            kbatches.append(kk)
            vbatches.append(vv)
        if tables_box is not None:
            tables_box[0] = None  # free the 3 x 2 GB count tables now
        if kbatches:
            total = sum(int(b.shape[0]) for b in kbatches)
            cap = 1 << max(total - 1, 1).bit_length()  # stable round shapes
            pad = cap - total
            if pad:
                kbatches.append(jnp.full(pad, 0xFFFFFFFF, jnp.uint32))
                vbatches.append(jnp.zeros(pad, jnp.int32))
            keys_all = jnp.concatenate(kbatches)
            pids_all = jnp.concatenate(vbatches)
            del kbatches, vbatches
            cmap = build_cuckoo_device(keys_all, pids_all, k, bits=cbits)
            if cmap is None:
                # fallback must NOT re-stream (the count tables are gone):
                # replay the collected device-resident pairs instead
                def pair_replay(keys_all=keys_all, pids_all=pids_all):
                    CH = 1 << 22
                    for lo in range(0, int(keys_all.shape[0]), CH):
                        yield keys_all[lo : lo + CH], pids_all[lo : lo + CH]
            del keys_all, pids_all
    if cmap is not None:
        per_contig.clear()  # free the member arrays (host)
        return PeakSet(
            contig=pcontig, pos=ppos,
            sorted_hash=np.zeros(0, np.uint32),
            sorted_peak=np.zeros(0, np.int32),
            cmap=cmap,
        )
    rmap = build_rankmap_device(
        (lambda: pair_replay()) if pair_replay is not None else stream, k)
    per_contig.clear()  # free the member arrays (host)
    return PeakSet(
        contig=pcontig, pos=ppos,
        sorted_hash=np.zeros(0, np.uint32), sorted_peak=np.zeros(0, np.int32),
        rmap=rmap,
    )


@partial(jax.jit, static_argnames=("k", "mode", "kw", "min_hits"))
def pair_candidate_count_mask(codes1, len1, codes2, len2, accept, masks,
                              probe, k: int, mode: str, kw: int,
                              min_hits: int):
    """Exact vote prefilter: bool [B] — False iff the pair can NEVER vote.

    A vote requires check_split's gate (cpp:161-202): >= 2 genomes each
    with >= min_base_num counted bases. Every counted base is a position
    where >= 1 coder found a peak-map candidate (judge_base's `do`), and
    each such position credits exactly one genome, so a voting pair needs
    at least 2*min_base_num candidate positions across both mates. This
    probe counts candidate positions with ONE membership gather per query
    (the RankMap's presence bitmap wp[0::2], or the direct map itself) —
    no pids gather, no greedy — and keeps only pairs reaching that bound.
    Skipping the rest leaves the vote bit-identical
    (tests/test_vote.py::test_vote_prefilter_identity).

    mode: "rank" (probe = rank wp int32 [2*W]) or "map" (probe = direct
    int32 [2^k]). min_hits = 2 * min_base_num (static).
    """
    import jax.numpy as jnp

    bit_lut = jnp.asarray([1 << b for b in range(32)], jnp.uint32)

    def count_one(codes, lengths):
        h, v = encode.canonical_hashes(jnp, codes, masks, k)  # [C,B,L]
        L = codes.shape[-1]
        if kw and kw < L:
            h = h[:, :, :kw]
            v = v[:, :kw]
            L = kw
        inwin = (jnp.arange(L, dtype=jnp.int32)[None, :]
                 <= (lengths[:, None] - k))
        ok = v[None, :, :] & inwin[None, :, :] & (h != 0)
        if mode == "rank":
            wi = (h >> jnp.uint32(5)).astype(jnp.int32)
            word = probe[2 * wi].astype(jnp.uint32)
            present = (word & bit_lut[(h & jnp.uint32(31))
                                      .astype(jnp.int32)]) != 0
        else:  # "map": candidate iff pid != 0, the lookup itself
            present = probe[h.astype(jnp.int32)] != 0
        return jnp.sum(jnp.any(ok & present, axis=0).astype(jnp.int32),
                       axis=1)

    n = count_one(codes1, len1) + count_one(codes2, len2)
    return accept & (n >= min_hits)


@jax.jit
def gather_pair_rows(c1, l1, c2, l2, idx):
    """Device row-gather of a compacted vote sub-batch (both mates)."""
    return c1[idx], l1[idx], c2[idx], l2[idx]


@partial(jax.jit,
         static_argnames=("k", "use_map", "use_rank", "use_cuckoo", "kw",
                          "cuckoo_bits"))
def _vote_candidates(codes, lengths, masks, sorted_hash, sorted_peak,
                     rank_wp, rank_pids, cuckoo_t1, cuckoo_t2,
                     k: int, use_map: bool, use_rank: bool,
                     use_cuckoo: bool, kw: int,
                     cuckoo_bits: int = CUCKOO_BITS):
    import jax.numpy as jnp

    h, v = encode.canonical_hashes(jnp, codes, masks, k)  # [C,B,L]
    L = codes.shape[-1]
    if kw and kw < L:
        h = h[:, :, :kw]
        v = v[:, :kw]
        L = kw
    inwin = jnp.arange(L, dtype=jnp.int32)[None, :] <= (lengths[:, None] - k)
    return _candidates_from_h(h, v & inwin, sorted_hash, sorted_peak,
                              use_map, rank_wp, rank_pids, use_rank,
                              cuckoo_t1, cuckoo_t2, use_cuckoo,
                              cuckoo_bits)


def split_vote_batch(
    peak_filter,
    codes1, len1, codes2, len2, accept,
    masks, sorted_hash, sorted_peak, peak_contig,
    k: int, min_base_num: int = 6, n_slots: int = 8, use_map: bool = False,
    rank_wp=None, rank_pids=None, use_rank: bool = False, kw: int = 0,
    cuckoo_t1=None, cuckoo_t2=None, use_cuckoo: bool = False,
    cuckoo_bits: int = CUCKOO_BITS,
):
    """One device step of the split-read vote (slide_reads, cpp:313-506).

    Args:
        peak_filter: int32 [P+1] vote counts (index 0 = sentinel).
        codes1/codes2: uint8 [B, L] mate code batches.
        accept: bool [B] down-sampling mask (same stream as counting).
        kw: static crop of the k-mer start axis (max_len - k + 1, bucketed)
            — positions past it are invalid anyway, and the map lookups +
            greedy scan are the vote's whole cost (~1/3 saved at 150-bp
            reads in 192-wide batches).
    Returns updated peak_filter.

    Deliberately NOT one fused jit: the candidate lookup (per mate) and the
    greedy vote + filter scatter are separate dispatches, so XLA does not
    schedule the [C, B, 2*kw] candidate tensors through re-materialized
    fusions of one large program. Whether fusing pays on a GPU is not yet
    measured.
    """
    import os as _os

    if _os.environ.get("LHT_VOTE_DEBUG"):
        import time as _time

        from localhgt_tpu.utils import metrics

        t0 = _time.perf_counter()
        pk1 = jax.block_until_ready(_vote_candidates(
            codes1, len1, masks, sorted_hash, sorted_peak,
            rank_wp, rank_pids, cuckoo_t1, cuckoo_t2,
            k, use_map, use_rank, use_cuckoo, kw, cuckoo_bits))
        pk2 = jax.block_until_ready(_vote_candidates(
            codes2, len2, masks, sorted_hash, sorted_peak,
            rank_wp, rank_pids, cuckoo_t1, cuckoo_t2,
            k, use_map, use_rank, use_cuckoo, kw, cuckoo_bits))
        metrics.record("vote_lookup_s", _time.perf_counter() - t0)
        t0 = _time.perf_counter()
        out = jax.block_until_ready(_vote_core_jit(
            peak_filter, pk1, pk2, peak_contig, accept,
            min_base_num, n_slots))
        metrics.record("vote_core_s", _time.perf_counter() - t0)
        return out
    pk1 = _vote_candidates(codes1, len1, masks, sorted_hash, sorted_peak,
                           rank_wp, rank_pids, cuckoo_t1, cuckoo_t2,
                           k, use_map, use_rank, use_cuckoo, kw, cuckoo_bits)
    pk2 = _vote_candidates(codes2, len2, masks, sorted_hash, sorted_peak,
                           rank_wp, rank_pids, cuckoo_t1, cuckoo_t2,
                           k, use_map, use_rank, use_cuckoo, kw, cuckoo_bits)
    return _vote_core_jit(peak_filter, pk1, pk2, peak_contig, accept,
                          min_base_num, n_slots)


@partial(jax.jit, static_argnames=("min_base_num", "n_slots"))
def _vote_core_jit(peak_filter, pk1, pk2, peak_contig, accept,
                   min_base_num: int, n_slots: int):
    return _vote_core(peak_filter, pk1, pk2, peak_contig, accept,
                      min_base_num, n_slots)


def _candidates_from_h(h, v, sorted_hash, sorted_peak,
                       use_map: bool,
                       rank_wp=None, rank_pids=None, use_rank: bool = False,
                       cuckoo_t1=None, cuckoo_t2=None,
                       use_cuckoo: bool = False,
                       cuckoo_bits: int = CUCKOO_BITS):
    """Peak-candidate lookup from canonical hashes — direct map (k <= 30
    default), cuckoo map (k > 30 default, 2 gathers), rank-select map
    (k > 30 fallback, 3 gathers), or plain binary search (the oracle
    fallback for host-built peaksets / tests).

    Hash 0 is excluded on every path (the degenerate all-zeros k-mer code;
    the direct-map build drops it, so the search paths must too for the
    lookup modes to agree — read_index cpp:936-941 treats it as unusable)."""
    import jax.numpy as jnp

    if use_map:
        pk = sorted_hash[h.astype(jnp.int32)]
        return jnp.where(v[None, :, :] & (h != 0), pk, 0)
    K = sorted_hash.shape[0]
    ok0 = v[None, :, :] & (h != 0)
    if use_cuckoo and cuckoo_t1 is not None:
        return jnp.where(
            ok0, cuckoo_lookup(cuckoo_t1, cuckoo_t2, h, cuckoo_bits), 0)
    if use_rank and rank_wp is not None:
        return jnp.where(ok0, rank_lookup(rank_wp, rank_pids, h), 0)
    idx = jnp.clip(jnp.searchsorted(sorted_hash, h), 0, max(K - 1, 0))
    found = (sorted_hash[idx] == h) if K else jnp.zeros_like(h, bool)
    pk = sorted_peak[idx] if K else jnp.zeros(h.shape, jnp.int32)
    return jnp.where(found & ok0, pk, 0)


def _vote_core(peak_filter, pk1, pk2, peak_contig, accept,
               min_base_num: int, n_slots: int):
    import jax.numpy as jnp

    pk = jnp.concatenate([pk1, pk2], axis=2)          # [C, B, P]
    genome = peak_contig[pk]                           # [C, B, P] (0 sentinel)
    if jax.default_backend() == "gpu":
        # the whole sequential greedy runs in one Pallas kernel with the
        # register state held on chip (ops.pallas_vote)
        from localhgt_tpu.ops import pallas_vote

        state = pallas_vote.vote_state(genome, pk, n_slots=n_slots)
    else:
        state = vote_state_scan(genome, pk, n_slots)
    return _vote_tail(peak_filter, *state, accept, min_base_num)


def vote_state_scan(genome, pk, n_slots: int):
    """The greedy genome-register scan as a lax.scan over read positions,
    vectorized over pairs: the plain reference of ops.pallas_vote.vote_state
    (same arguments and results)."""
    import jax.numpy as jnp

    B = pk.shape[1]
    # pad position axis to a multiple of UNROLL, then scan over position
    # blocks with the sequential greedy unrolled inside the step body — the
    # per-position work is tiny, so fewer, fatter scan steps
    UNROLL = 8
    P = pk.shape[-1]
    pad = (-P) % UNROLL
    if pad:
        z = jnp.zeros(pk.shape[:2] + (pad,), pk.dtype)
        pk = jnp.concatenate([pk, z], axis=2)
        genome = jnp.concatenate([genome, z], axis=2)
    nblk = pk.shape[-1] // UNROLL
    # [nblk, UNROLL, B, C]
    pk = jnp.transpose(pk, (2, 1, 0)).reshape(nblk, UNROLL, B, -1)
    genome = jnp.transpose(genome, (2, 1, 0)).reshape(nblk, UNROLL, B, -1)

    G = n_slots
    C = pk.shape[-1]

    def one_position(state, cg, cp, t):
        slots_g, slots_c, slots_p, slots_t, hits = state
        sel_g = jnp.zeros(B, jnp.int32)
        sel_cnt = jnp.zeros(B, jnp.int32)
        sel_p = jnp.zeros(B, jnp.int32)
        for c in range(C):
            g = cg[:, c]
            p = cp[:, c]
            is_cand = p != 0
            match = slots_g == g[:, None]              # [B, G]
            seen = jnp.any(match & (slots_g != 0), axis=1)
            cnt = jnp.max(jnp.where(match, slots_c, 0), axis=1)
            take_seen = is_cand & seen & (cnt >= sel_cnt)
            take_new = is_cand & ~seen & (sel_p == 0)
            take = take_seen | take_new
            sel_g = jnp.where(take, g, sel_g)
            sel_cnt = jnp.where(take_seen, cnt, jnp.where(take_new, 0, sel_cnt))
            sel_p = jnp.where(take, p, sel_p)
        do = sel_p != 0
        match = slots_g == sel_g[:, None]
        have = jnp.any(match & (slots_g != 0), axis=1)
        inc = match & (slots_g != 0) & do[:, None]
        slots_c = slots_c + inc.astype(jnp.int32)
        # insert at the first empty slot; when the register is full, evict
        # the MOST-RECENTLY-INSERTED count-1 slot. The reference's genome
        # map is UNBOUNDED (std::map, judge_base cpp:118-159); a fixed
        # register that never evicts loses real genomes behind spurious
        # single-hit k-mer collisions, which at production peak-map density
        # fill all G slots (the round-2 big-fixture recall loss). Evicting
        # the NEWEST count-1 occupant (per-slot insertion stamp slots_t)
        # means a sparse real genome inserted earlier survives any number
        # of interleaved spurious single-hit insertions until its own next
        # hit — first-count-1 eviction could churn it forever (r3 ADVICE
        # low #2). Bit-identical to the reference whenever <= G genomes
        # appear (the species20 A/B regime). At most one insert happens
        # per position, so stamps of live slots are distinct and the
        # cumsum tie-break below is only a safety net.
        empty = slots_g == 0
        count1 = (slots_g != 0) & (slots_c == 1)
        has_empty = jnp.any(empty, axis=1, keepdims=True)
        first_empty = empty & (jnp.cumsum(empty.astype(jnp.int32), axis=1) == 1)
        tc1 = jnp.where(count1, slots_t, -1)
        mru = count1 & (tc1 == jnp.max(tc1, axis=1, keepdims=True))
        first_mru = mru & (jnp.cumsum(mru.astype(jnp.int32), axis=1) == 1)
        victim = jnp.where(has_empty, first_empty, first_mru)
        ins = victim & (do & ~have)[:, None]
        slots_g = jnp.where(ins, sel_g[:, None], slots_g)
        slots_c = jnp.where(ins, 1, slots_c)
        slots_p = jnp.where(ins, sel_p[:, None], slots_p)
        slots_t = jnp.where(ins, t, slots_t)
        hits = hits + do.astype(jnp.int32)
        return (slots_g, slots_c, slots_p, slots_t, hits)

    def step(state, inp):
        cg_blk, cp_blk, blk = inp  # [UNROLL, B, C], scalar block index
        for u in range(UNROLL):
            state = one_position(state, cg_blk[u], cp_blk[u],
                                 blk * UNROLL + (u + 1))
        return state, None

    init = (
        jnp.zeros((B, G), jnp.int32),
        jnp.zeros((B, G), jnp.int32),
        jnp.zeros((B, G), jnp.int32),
        jnp.zeros((B, G), jnp.int32),
        jnp.zeros(B, jnp.int32),
    )
    (slots_g, slots_c, slots_p, _, hits), _ = jax.lax.scan(
        step, init, (genome, pk, jnp.arange(nblk, dtype=jnp.int32)))
    return slots_g, slots_c, slots_p, hits


def _vote_tail(peak_filter, slots_g, slots_c, slots_p, hits, accept,
               min_base_num: int):
    """check_split's top-2-genome gate + the peak_filter bump
    (cpp:161-202,498-505), from the final register state [B, G]."""
    import jax.numpy as jnp

    qual = (slots_c >= min_base_num) & (slots_g != 0)
    nq = jnp.sum(qual, axis=1)
    gate = accept & (hits >= min_base_num) & (nq >= 2)
    counts = jnp.where(qual, slots_c, 0)
    largest = jnp.max(counts, axis=1)
    n_largest = jnp.sum(counts == largest[:, None], axis=1)
    second_cand = jnp.max(jnp.where(counts == largest[:, None], 0, counts), axis=1)
    second = jnp.where(n_largest > 1, largest, second_cand)
    vote = qual & ((counts == largest[:, None]) | (counts == second[:, None])) \
        & gate[:, None]
    ids = jnp.where(vote, slots_p, 0).reshape(-1)
    return peak_filter.at[ids].add(1)
