"""Split-read vote kernel: a pair bridging two genomes' peak k-mers votes for
both; pure single-genome pairs vote for none (check_split requires >= 2
genomes with >= MIN_BASE_NUM voting bases, cpp:161-202)."""

import numpy as np
import pytest

from localhgt_tpu.ops import encode
from localhgt_tpu.pipeline import peaks as pm


def _mk(k=16):
    rng = np.random.default_rng(0)
    gA = rng.integers(0, 4, 400).astype(np.uint8)
    gB = rng.integers(0, 4, 400).astype(np.uint8)
    masks, _ = encode.hasher_for(k, 3, seed=1)

    # peaks: one on each genome; register all k-mers of each genome's window
    def kmers(codes):
        h, v = encode.canonical_hashes(np, codes, masks, k)
        return h[:, v].reshape(3, -1)

    hA = kmers(gA[100:200]).reshape(-1)
    hB = kmers(gB[100:200]).reshape(-1)
    hashes = np.concatenate([hA, hB]).astype(np.uint32)
    pids = np.concatenate([np.full(len(hA), 1), np.full(len(hB), 2)]).astype(np.int32)
    order = np.argsort(hashes, kind="stable")
    hashes, pids = hashes[order], pids[order]
    last = np.ones(len(hashes), bool)
    last[:-1] = hashes[1:] != hashes[:-1]
    pset = pm.PeakSet(
        contig=np.array([0, 1, 2], np.int32),
        pos=np.array([0, 150, 150], np.int64),
        sorted_hash=hashes[last],
        sorted_peak=pids[last],
    )
    return gA, gB, masks, pset, k


def _vote(pset, masks, k, m1, m2, accept=None):
    import jax.numpy as jnp

    B = m1.shape[0]
    pf = jnp.zeros(pset.n + 1, jnp.int32)
    acc = np.ones(B, bool) if accept is None else accept
    pf = pm.split_vote_batch(
        pf,
        jnp.asarray(m1), jnp.full(B, m1.shape[1], jnp.int32),
        jnp.asarray(m2), jnp.full(B, m2.shape[1], jnp.int32),
        jnp.asarray(acc),
        jnp.asarray(masks), jnp.asarray(pset.sorted_hash),
        jnp.asarray(pset.sorted_peak),
        jnp.asarray(pset.contig.astype(np.int32)),
        k=k,
    )
    return np.asarray(pf)


def test_bridging_pair_votes_both_peaks():
    gA, gB, masks, pset, k = _mk()
    chimera = np.concatenate([gA[120:180], gB[120:180]])[None, :]
    mate = gB[110:170][None, :]
    pf = _vote(pset, masks, k, chimera, mate)
    assert pf[1] >= 1 and pf[2] >= 1, pf


def test_pure_pair_votes_nothing():
    gA, gB, masks, pset, k = _mk()
    m1 = gA[110:170][None, :]
    m2 = gA[130:190][None, :]
    pf = _vote(pset, masks, k, m1, m2)
    assert pf[1] == 0 and pf[2] == 0, pf


def test_downsample_gates_votes():
    gA, gB, masks, pset, k = _mk()
    chimera = np.concatenate([gA[120:180], gB[120:180]])[None, :]
    mate = gB[110:170][None, :]
    pf = _vote(pset, masks, k, chimera, mate, accept=np.zeros(1, bool))
    assert pf[1:].sum() == 0


def test_direct_map_matches_searchsorted():
    """The direct-map candidates path must vote identically to the
    sorted-table binary-search path."""
    import jax.numpy as jnp

    gA, gB, masks, pset, k = _mk()
    dm = np.zeros(1 << k, np.int32)
    dm[pset.sorted_hash.astype(np.int64)] = pset.sorted_peak
    chimera = np.concatenate([gA[120:180], gB[120:180]])[None, :]
    mate = gB[110:170][None, :]
    B = 1
    pf0 = jnp.zeros(pset.n + 1, jnp.int32)
    args = (
        jnp.asarray(chimera), jnp.full(B, chimera.shape[1], jnp.int32),
        jnp.asarray(mate), jnp.full(B, mate.shape[1], jnp.int32),
        jnp.asarray(np.ones(B, bool)), jnp.asarray(masks),
    )
    pc = jnp.asarray(pset.contig.astype(np.int32))
    ref = pm.split_vote_batch(
        pf0, *args, jnp.asarray(pset.sorted_hash),
        jnp.asarray(pset.sorted_peak), pc, k=k)
    got = pm.split_vote_batch(
        pf0, *args, jnp.asarray(dm), jnp.zeros(1, jnp.int32), pc,
        k=k, use_map=True)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_build_direct_map_device():
    """Device map build == host peakset build on a small reference."""
    import jax.numpy as jnp

    from localhgt_tpu.io import fasta as fasta_mod
    from localhgt_tpu.ops import count as count_mod

    k = 16
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    contigs = fasta_mod.Contigs(
        names=["c1"], lengths=np.array([3000]), offsets=np.array([0]),
        codes=codes).finalize()
    masks, _ = encode.hasher_for(k, 3, seed=1)
    tables = tuple(count_mod.make_table(k) for _ in range(3))
    # count the reference's own 100..200 window so lookups are nonzero
    h, v = encode.canonical_hashes(np, codes[None, 100:220], masks, k)
    t_new = []
    for i, t in enumerate(tables):
        arr = np.zeros(1 << k, np.int8)
        arr[h[i][v].astype(np.int64)] = 3
        t_new.append(jnp.asarray(arr.reshape(t.shape)))
    tables = tuple(t_new)
    per_contig = [(1, np.array([150], np.int64),
                   np.arange(120, 180, dtype=np.int64),
                   np.zeros(60, np.int32))]
    pset = pm.build_direct_map(list(per_contig), contigs, tables, masks, k)
    dm = np.asarray(pset.direct_map)
    # every registered hash must be a valid k-mer of the window with count>0
    set_hashes = np.flatnonzero(dm)
    assert len(set_hashes) > 0
    assert np.all(dm[set_hashes] == 1)
    # compare against the host build
    def count_lookup(i, hashes):
        return np.asarray(tables[i]).reshape(-1)[hashes.astype(np.int64)]
    pset_host = pm.build_peakset(
        per_contig, lambda cid: contigs.contig_codes(cid), count_lookup,
        masks, k)
    dm_host = np.zeros(1 << k, np.int32)
    dm_host[pset_host.sorted_hash.astype(np.int64)] = pset_host.sorted_peak
    np.testing.assert_array_equal(dm, dm_host)


def _kernel_and_scan(genome, pk, n_slots=8):
    import jax.numpy as jnp

    from localhgt_tpu.ops import pallas_vote

    got = pallas_vote.vote_state(jnp.asarray(genome), jnp.asarray(pk),
                                 n_slots=n_slots, interpret=True)
    want = pm.vote_state_scan(jnp.asarray(genome), jnp.asarray(pk), n_slots)
    return [np.asarray(x) for x in got], [np.asarray(x) for x in want]


def test_pallas_vote_state_matches_scan():
    """The Pallas greedy-scan kernel (interpret mode on CPU) must produce
    the identical final register state as the lax.scan path."""
    rng = np.random.default_rng(9)
    C, B, P = 3, 6, 40
    # sparse candidates over 4 genomes / 12 peaks
    pk = (rng.integers(0, 13, (C, B, P)) *
          (rng.random((C, B, P)) < 0.3)).astype(np.int32)
    peak_contig = np.array([0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4], np.int32)
    got, want = _kernel_and_scan(peak_contig[pk], pk)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("C,B,P,n_genomes,density,n_slots", [
    (3, 6, 40, 4, 0.3, 8),       # fewer genomes than slots
    (3, 40, 64, 30, 0.5, 8),     # register overflow; B past one block
    (3, 17, 256, 60, 0.6, 8),    # production P; overflow
    (2, 33, 7, 5, 0.9, 8),       # P not a multiple of 8
    (1, 3, 12, 3, 0.9, 8),       # one hash function
    (3, 20, 48, 12, 0.7, 4),     # a 4-slot register
    (3, 5, 16, 2, 0.0, 8),       # no candidates at all
])
def test_vote_kernel_cases(C, B, P, n_genomes, density, n_slots):
    rng = np.random.default_rng(C * 1000 + B + P)
    n_peaks = 4 * n_genomes + 1
    peak_contig = np.concatenate(
        [[0], rng.integers(1, n_genomes + 1, n_peaks - 1)]).astype(np.int32)
    pk = (rng.integers(1, n_peaks, (C, B, P)) *
          (rng.random((C, B, P)) < density)).astype(np.int32)
    got, want = _kernel_and_scan(peak_contig[pk], pk, n_slots)
    for name, a, b in zip(("slots_g", "slots_c", "slots_p", "hits"),
                          got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("B,want", [(8, 16), (512, 16), (4096, 16),
                                    (32768, 64), (1 << 20, 64)])
def test_vote_kernel_block_pairs(B, want):
    from localhgt_tpu.ops import pallas_vote

    assert pallas_vote.block_pairs(B) == want


@pytest.mark.gpu
def test_vote_kernel_compiled_on_gpu():
    import jax.numpy as jnp

    from localhgt_tpu.ops import pallas_vote

    rng = np.random.default_rng(3)
    C, B, P = 3, 4096, 256
    peak_contig = np.concatenate(
        [[0], rng.integers(1, 200, 999)]).astype(np.int32)
    pk = (rng.integers(1, 1000, (C, B, P)) *
          (rng.random((C, B, P)) < 0.5)).astype(np.int32)
    genome = peak_contig[pk]
    got = pallas_vote.vote_state(jnp.asarray(genome), jnp.asarray(pk))
    want = pm.vote_state_scan(jnp.asarray(genome), jnp.asarray(pk), 8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_register_overflow_evicts_spurious_genomes():
    """A bridging pair must still vote when MORE genomes than register
    slots appear (production peak maps give ~1 spurious single-hit genome
    per ~25 positions; the reference's genome map is unbounded,
    judge_base cpp:118-159). Count-1 eviction keeps the dense real genomes;
    the pre-fix register dropped them once 8 slots filled."""
    import jax.numpy as jnp

    from localhgt_tpu.pipeline import peaks as pm_mod

    C, B, G = 1, 1, 8
    # positions: 10 spurious genomes (ids 100..109, one position each)
    # FIRST, then the two real genomes (ids 1, 2) with 8 positions each
    genomes = [100 + i for i in range(10)] + [1] * 8 + [2] * 8
    P = len(genomes)
    pk = np.arange(1, P + 1, dtype=np.int32).reshape(1, 1, P)
    peak_contig = np.zeros(P + 1, np.int32)
    peak_contig[1:] = genomes
    gn = peak_contig[pk]
    pf = pm_mod._vote_core(
        jnp.zeros(P + 1, jnp.int32), jnp.asarray(pk[:, :, : P // 2]),
        jnp.asarray(pk[:, :, P // 2:]), jnp.asarray(peak_contig),
        jnp.asarray(np.ones(B, bool)), min_base_num=6, n_slots=G)
    assert np.asarray(pf)[1:].sum() >= 2, (
        "real genomes lost to register overflow")


def test_sparse_real_genome_survives_interleaved_spurious():
    """Adversarial ordering (r3 ADVICE low #2): a SPARSE real genome whose
    hits interleave with spurious single-hit genomes. Between its own hits
    the real genome is itself a count-1 occupant; evicting the FIRST
    count-1 slot would churn it out before every one of its hits (it sits
    in a low slot), so it never accumulates. Evicting the MOST-RECENTLY-
    INSERTED count-1 slot sacrifices the newest spurious occupant instead,
    and the real genome reaches min_base_num — matching the reference's
    unbounded map (judge_base cpp:118-159), where both real genomes
    accumulate regardless of interleaving."""
    import jax.numpy as jnp

    from localhgt_tpu.ops import pallas_vote
    from localhgt_tpu.pipeline import peaks as pm_mod

    C, B, G = 1, 1, 4
    # dense genome 2 first (3 hits), then sparse genome 1's first hit,
    # fillers 21/22 fill the register, then spurious 23/24/25 interleave
    # with genome 1's remaining hits
    genomes = [2, 2, 2, 1, 21, 22, 23, 1, 24, 1, 25, 1]
    P = len(genomes)
    pk = np.arange(1, P + 1, dtype=np.int32).reshape(1, 1, P)
    peak_contig = np.zeros(P + 1, np.int32)
    peak_contig[1:] = genomes
    pf = pm_mod._vote_core(
        jnp.zeros(P + 1, jnp.int32), jnp.asarray(pk[:, :, : P // 2]),
        jnp.asarray(pk[:, :, P // 2:]), jnp.asarray(peak_contig),
        jnp.asarray(np.ones(B, bool)), min_base_num=3, n_slots=G)
    pf = np.asarray(pf)
    # first-seen peaks of genome 2 (pid 1) and genome 1 (pid 4) get votes
    assert pf[1] == 1 and pf[4] == 1, pf
    assert pf[1:].sum() == 2, pf

    # Pallas kernel (interpret mode) must agree bit-for-bit
    gn = peak_contig[pk]
    got = pallas_vote.vote_state(jnp.asarray(gn), jnp.asarray(pk),
                                 n_slots=G, interpret=True)
    pal = pm_mod._vote_tail(
        jnp.zeros(P + 1, jnp.int32),
        *[jnp.asarray(np.asarray(x)) for x in got],
        jnp.asarray(np.ones(B, bool)), 3)
    np.testing.assert_array_equal(pf, np.asarray(pal))


def test_rankmap_matches_searchsorted():
    """The rank-select-map candidates path (the k > 30 default) must vote
    identically to the sorted-table binary-search path."""
    import jax.numpy as jnp

    gA, gB, masks, pset, k = _mk()
    rmap = pm.build_rankmap_host(pset.sorted_hash, pset.sorted_peak, k)
    chimera = np.concatenate([gA[120:180], gB[120:180]])[None, :]
    mate = gB[110:170][None, :]
    B = 1
    pf0 = jnp.zeros(pset.n + 1, jnp.int32)
    args = (
        jnp.asarray(chimera), jnp.full(B, chimera.shape[1], jnp.int32),
        jnp.asarray(mate), jnp.full(B, mate.shape[1], jnp.int32),
        jnp.asarray(np.ones(B, bool)), jnp.asarray(masks),
    )
    pc = jnp.asarray(pset.contig.astype(np.int32))
    sh = jnp.asarray(pset.sorted_hash)
    sp = jnp.asarray(pset.sorted_peak)
    ref = pm.split_vote_batch(pf0, *args, sh, sp, pc, k=k)
    got = pm.split_vote_batch(
        pf0, *args, sh, sp, pc, k=k,
        rank_wp=jnp.asarray(rmap.wp), rank_pids=jnp.asarray(rmap.pids),
        use_rank=True)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))


def test_rankmap_roundtrip_and_misses():
    """Every stored key must return its pid; absent keys (including
    neighbors of stored keys) must return 0; duplicate (hash, pid) pairs
    must resolve to the MAX pid (the reference's last-writer overwrite)."""
    import jax.numpy as jnp

    k = 20
    rng = np.random.default_rng(5)
    hs = np.unique(rng.integers(1, 1 << k, 5000).astype(np.uint32))
    ps = np.arange(1, len(hs) + 1, dtype=np.int32)
    # inject duplicates with lower pids — the max must win
    dup = rng.choice(len(hs), 500, replace=False)
    hs_all = np.concatenate([hs[dup], hs])
    ps_all = np.concatenate([np.zeros(500, np.int32) + 1, ps])
    rmap = pm.build_rankmap_host(hs_all, ps_all, k)
    got = np.asarray(pm.rank_lookup(jnp.asarray(rmap.wp),
                                    jnp.asarray(rmap.pids),
                                    jnp.asarray(hs)))
    np.testing.assert_array_equal(got, np.maximum(ps, 0))
    # absent neighbors miss
    stored = set(hs.tolist())
    probes = np.array([h for h in range(1, 4000) if h not in stored],
                      np.uint32)
    miss = np.asarray(pm.rank_lookup(jnp.asarray(rmap.wp),
                                     jnp.asarray(rmap.pids),
                                     jnp.asarray(probes)))
    assert not miss.any()


def test_rankmap_device_build_matches_host():
    """The device streaming-scatter build (bitmap passes + pid scatter-max)
    must equal the host sort-based build, including duplicate resolution
    and sentinel rows, across multiple batches."""
    import jax.numpy as jnp

    k = 18
    rng = np.random.default_rng(11)
    SEN = np.uint32(0xFFFFFFFF)
    batches = []
    all_k, all_v = [], []
    for i in range(3):
        kk = rng.integers(1, 1 << k, 4096).astype(np.uint32)
        vv = rng.integers(1, 1 << 20, 4096).astype(np.int32)
        kk[rng.random(4096) < 0.3] = SEN  # interleaved sentinel rows
        vv[kk == SEN] = 0
        batches.append((jnp.asarray(kk), jnp.asarray(vv)))
        all_k.append(kk[kk != SEN])
        all_v.append(vv[kk != SEN])
    rm_dev = pm.build_rankmap_device(lambda: iter(batches), k)
    rm_host = pm.build_rankmap_host(np.concatenate(all_k),
                                    np.concatenate(all_v), k)
    np.testing.assert_array_equal(np.asarray(rm_dev.wp), rm_host.wp)
    np.testing.assert_array_equal(np.asarray(rm_dev.pids), rm_host.pids)


def test_build_hash_peakset_matches_host_build():
    """Device-chunked (hash, peak) collection + rank-map build == the host
    oracle build."""
    import jax
    import jax.numpy as jnp

    from localhgt_tpu.io import fasta as fasta_mod

    k = 16
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    contigs = fasta_mod.Contigs(
        names=["c1"], lengths=np.array([3000]), offsets=np.array([0]),
        codes=codes).finalize()
    masks, _ = encode.hasher_for(k, 3, seed=1)
    h, v = encode.canonical_hashes(np, codes[None, 100:220], masks, k)
    tables = []
    for i in range(3):
        arr = np.zeros(1 << k, np.int8)
        arr[h[i][v].astype(np.int64)] = 3
        tables.append(jnp.asarray(arr))
    tables = tuple(tables)
    per_contig = [(1, np.array([150], np.int64),
                   np.arange(120, 180, dtype=np.int64),
                   np.zeros(60, np.int32))]
    pset_dev = pm.build_hash_peakset(list(per_contig), contigs, tables,
                                 masks, k)
    assert pset_dev.rmap is not None  # RankMap is the default build

    def count_lookup(i, hashes):
        return np.asarray(tables[i]).reshape(-1)[hashes.astype(np.int64)]

    pset_host = pm.build_peakset(
        per_contig, lambda cid: contigs.contig_codes(cid), count_lookup,
        masks, k)
    # the experimental cuckoo build (LHT_VOTE_CUCKOO=1) must agree too
    import os

    os.environ["LHT_VOTE_CUCKOO"] = "1"
    try:
        pset_ck = pm.build_hash_peakset(list(per_contig), contigs, tables,
                                        masks, k)
    finally:
        del os.environ["LHT_VOTE_CUCKOO"]
    assert pset_ck.cmap is not None
    got_ck = np.asarray(jax.jit(
        lambda t1, t2, h: pm.cuckoo_lookup(t1, t2, h, pset_ck.cmap.bits))(
        pset_ck.cmap.t1, pset_ck.cmap.t2,
        jnp.asarray(pset_host.sorted_hash)))
    np.testing.assert_array_equal(got_ck, pset_host.sorted_peak)
    np.testing.assert_array_equal(np.asarray(pset_dev.rmap.wp),
                                  pset_host.rmap.wp)
    np.testing.assert_array_equal(np.asarray(pset_dev.rmap.pids),
                                  pset_host.rmap.pids)
    # lookups of every stored hash return the host's (max-pid) winner
    got = np.asarray(pm.rank_lookup(
        jnp.asarray(np.asarray(pset_dev.rmap.wp)),
        jnp.asarray(np.asarray(pset_dev.rmap.pids)),
        jnp.asarray(pset_host.sorted_hash)))
    np.testing.assert_array_equal(got, pset_host.sorted_peak)


def test_vote_prefilter_identity():
    """pair_candidate_count_mask is exact: pairs it drops can never vote,
    so voting only the kept (compacted) pairs is bit-identical to voting
    everything — on both the rank-map and direct-map probe paths."""
    import jax.numpy as jnp

    gA, gB, masks, pset, k = _mk()
    rng = np.random.default_rng(7)
    B, L = 64, 60
    m1 = rng.integers(0, 4, (B, L)).astype(np.uint8)
    m2 = rng.integers(0, 4, (B, L)).astype(np.uint8)
    # a few genuine bridging pairs in the batch
    for b in (3, 17, 40):
        m1[b] = np.concatenate([gA[120:150], gB[150:180]])
        m2[b] = gB[110:170]
    # and a few single-genome pairs (candidates but no 2-genome vote)
    for b in (5, 22):
        m1[b] = gA[110:170]
        m2[b] = gA[120:180]
    accept = np.ones(B, bool)
    accept[17] = False  # down-sampled bridging pair must stay gated
    lens = np.full(B, L, np.int32)
    masks_j = jnp.asarray(masks)
    pc = jnp.asarray(pset.contig.astype(np.int32))
    min_base = 6

    rmap = pm.build_rankmap_host(pset.sorted_hash, pset.sorted_peak, k)
    dm = np.zeros(1 << k, np.int32)
    dm[pset.sorted_hash.astype(np.int64)] = pset.sorted_peak

    for mode in ("rank", "map"):
        if mode == "rank":
            kw = dict(rank_wp=jnp.asarray(rmap.wp),
                      rank_pids=jnp.asarray(rmap.pids), use_rank=True)
            sh, sp = jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.int32)
            probe = kw["rank_wp"]
        else:
            kw = dict(use_map=True)
            sh, sp = jnp.asarray(dm), jnp.zeros(1, jnp.int32)
            probe = sh
        pf0 = jnp.zeros(pset.n + 1, jnp.int32)
        full = np.asarray(pm.split_vote_batch(
            pf0, jnp.asarray(m1), jnp.asarray(lens),
            jnp.asarray(m2), jnp.asarray(lens), jnp.asarray(accept),
            masks_j, sh, sp, pc, k=k, min_base_num=min_base, **kw))
        mask = np.asarray(pm.pair_candidate_count_mask(
            jnp.asarray(m1), jnp.asarray(lens),
            jnp.asarray(m2), jnp.asarray(lens), jnp.asarray(accept),
            masks_j, probe, k=k, mode=mode, kw=0,
            min_hits=2 * min_base))
        idx = np.flatnonzero(mask)
        assert 0 < len(idx) < B           # something kept, something dropped
        assert not mask[17]               # accept=False is dropped
        bucket = max(8, 1 << (len(idx) - 1).bit_length())
        idxp = np.zeros(bucket, np.int32)
        idxp[: len(idx)] = idx
        accp = np.zeros(bucket, bool)
        accp[: len(idx)] = True
        c1s, l1s, c2s, l2s = pm.gather_pair_rows(
            jnp.asarray(m1), jnp.asarray(lens),
            jnp.asarray(m2), jnp.asarray(lens), jnp.asarray(idxp))
        compact = np.asarray(pm.split_vote_batch(
            pf0, c1s, l1s, c2s, l2s, jnp.asarray(accp),
            masks_j, sh, sp, pc, k=k, min_base_num=min_base, **kw))
        # index 0 is the sentinel slot (absorbs non-voting scatters) and
        # legitimately differs with batch size; real peaks must match
        np.testing.assert_array_equal(full[1:], compact[1:])
        assert full[1] >= 1 and full[2] >= 1  # the bridging pairs voted


def test_cuckoo_build_and_lookup_matches_oracle():
    """Device cuckoo placement + lookup == the direct dict oracle, with
    duplicate keys resolving to the MAX pid (reference last-writer
    semantics) and misses returning 0."""
    import jax
    import jax.numpy as jnp

    bits = 16
    rng = np.random.default_rng(9)
    n = 20_000  # ~0.15 load over 2*2^16 slots
    keys = rng.choice(np.arange(1, 1 << 20, dtype=np.uint32), size=n,
                      replace=False).astype(np.uint32)
    # spread over the full 32-bit space (canonical hashes are ~uniform;
    # forcing e.g. odd keys would halve T1's reachable slots and create
    # genuinely infeasible components)
    keys = keys * np.uint32(2654435761)
    keys = np.unique(keys[keys != 0])
    pids = rng.integers(1, 1 << bits, size=len(keys)).astype(np.int32)
    # add duplicates with different pids: max must win
    dup = rng.choice(len(keys), size=500, replace=False)
    dkeys = keys[dup]
    dpids = np.minimum(pids[dup] + 7, (1 << bits) - 1).astype(np.int32)
    allk = np.concatenate([keys, dkeys,
                           np.full(37, 0xFFFFFFFF, np.uint32)])  # sentinels
    allp = np.concatenate([pids, dpids, np.zeros(37, np.int32)])
    sh = rng.permutation(len(allk))
    cm = pm.build_cuckoo_device(allk[sh], allp[sh], k=32, bits=bits)
    assert cm is not None, "placement must converge at 0.15 load"
    oracle = {}
    for kk, pp in zip(allk, allp):
        if kk != 0xFFFFFFFF:
            oracle[int(kk)] = max(oracle.get(int(kk), 0), int(pp))
    # query stored keys + random misses
    misses = rng.integers(1, 0xFFFFFFF0, size=5000, dtype=np.uint64)\
        .astype(np.uint32)
    q = np.concatenate([keys, misses])
    got = np.asarray(jax.jit(
        lambda t1, t2, h: pm.cuckoo_lookup(t1, t2, h, bits))(
        cm.t1, cm.t2, jnp.asarray(q)))
    want = np.array([oracle.get(int(x), 0) for x in q], np.int32)
    np.testing.assert_array_equal(got, want)


def test_cuckoo_vote_matches_rank_vote():
    """split_vote_batch through a CuckooMap == through the RankMap (and
    the searchsorted oracle) on the shared fixture."""
    import jax
    import jax.numpy as jnp

    gA, gB, masks, pset, k = _mk()   # k = 16
    rmap = pm.build_rankmap_host(pset.sorted_hash, pset.sorted_peak, k)
    cm = pm.build_cuckoo_device(
        pset.sorted_hash.astype(np.uint32),
        pset.sorted_peak.astype(np.int32), k=k, bits=12)
    assert cm is not None
    chimera = np.concatenate([gA[120:180], gB[120:180]])[None, :]
    mate = gB[110:170][None, :]
    B = 1
    pf0 = jnp.zeros(pset.n + 1, jnp.int32)
    args = (
        jnp.asarray(chimera), jnp.full(B, chimera.shape[1], jnp.int32),
        jnp.asarray(mate), jnp.full(B, mate.shape[1], jnp.int32),
        jnp.asarray(np.ones(B, bool)), jnp.asarray(masks),
    )
    pc = jnp.asarray(pset.contig.astype(np.int32))
    zh, zp = jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.int32)
    ref = pm.split_vote_batch(
        pf0, *args, jnp.asarray(pset.sorted_hash),
        jnp.asarray(pset.sorted_peak), pc, k=k)
    via_rank = pm.split_vote_batch(
        pf0, *args, zh, zp, pc, k=k,
        rank_wp=jnp.asarray(rmap.wp), rank_pids=jnp.asarray(rmap.pids),
        use_rank=True)
    via_cuckoo = pm.split_vote_batch(
        pf0, *args, zh, zp, pc, k=k,
        cuckoo_t1=cm.t1, cuckoo_t2=cm.t2, use_cuckoo=True, cuckoo_bits=12)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(via_rank))
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(via_cuckoo))
    assert np.asarray(ref)[1] >= 1
