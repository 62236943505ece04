"""Pallas (Triton) kernel for the split-read vote's sequential greedy scan.

The vote (Split_reads::judge_base/check_split,
src/extract_ref_normal_peak.cpp:118-202) walks read positions left to right
keeping a small register of already-seen genomes; each position's candidate
(one per hash function) prefers a genome that is already ahead. The
left-to-right dependence forces a sequential loop over positions. As an XLA
`lax.scan` (pipeline/peaks.py `_vote_core`) every step reads and writes four
[B, G] state arrays in device memory, although each pair's state is only
4 x G int32.

Here one program owns a block of pairs and runs the whole position loop with
that state in registers: pairs on the block axis, the G slots as the minor
axis, and each position's C candidate rows loaded once, contiguous along
pairs from a position-major [(P*C), B] layout. The first-victim pick is a
min-over-iota reduction (Triton lowers neither `cummax` nor concatenate).

Semantics are bit-identical to the `lax.scan` path; tests compare the two in
interpret mode on the CPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def block_pairs(B: int) -> int:
    """Pairs per program: a power of two small enough that a bucket still
    spreads over every SM (>= ~2 programs per SM of an H100 at B=4096),
    large enough that a program's warps are full."""
    tb = 16
    while tb < 64 and B // (2 * tb) >= 264:
        tb *= 2
    return tb


def _kernel(cg_ref, cp_ref, og_ref, oc_ref, op_ref, oh_ref, *, C: int,
            G: int, P: int, TB: int):
    cols = pl.ds(pl.program_id(0) * TB, TB)
    slot = jax.lax.broadcasted_iota(jnp.int32, (TB, G), 1)
    zero = jnp.zeros((TB,), jnp.int32)

    def position(t, carry):
        sg, sc, sp, st, hits = carry
        sel_g = sel_cnt = sel_p = zero
        for c in range(C):
            g = cg_ref[t * C + c, cols]
            p = cp_ref[t * C + c, cols]
            is_cand = p != 0
            match = sg == g[:, None]
            seen = jnp.max(jnp.where(match & (sg != 0), 1, 0), axis=1) == 1
            cnt = jnp.max(jnp.where(match, sc, 0), axis=1)
            take_seen = is_cand & seen & (cnt >= sel_cnt)
            take_new = is_cand & ~seen & (sel_p == 0)
            take = take_seen | take_new
            sel_g = jnp.where(take, g, sel_g)
            sel_cnt = jnp.where(take_seen, cnt,
                                jnp.where(take_new, 0, sel_cnt))
            sel_p = jnp.where(take, p, sel_p)
        do = sel_p != 0
        live = sg != 0
        match = (sg == sel_g[:, None]) & live
        have = jnp.max(jnp.where(match, 1, 0), axis=1) == 1
        sc = sc + jnp.where(match & do[:, None], 1, 0)
        # victim: the first empty slot, or (register full) the first of the
        # most-recently-inserted count-1 slots — _vote_core's policy
        empty = ~live
        count1 = live & (sc == 1)
        has_empty = jnp.max(jnp.where(empty, 1, 0), axis=1) == 1
        tc1 = jnp.where(count1, st, -1)
        mru = count1 & (tc1 == jnp.max(tc1, axis=1)[:, None])
        victim = jnp.where(has_empty[:, None], empty, mru)
        first = jnp.min(jnp.where(victim, slot, G), axis=1)
        ins = (slot == first[:, None]) & (do & ~have)[:, None]
        sg = jnp.where(ins, sel_g[:, None], sg)
        sc = jnp.where(ins, 1, sc)
        sp = jnp.where(ins, sel_p[:, None], sp)
        st = jnp.where(ins, t + 1, st)
        hits = hits + jnp.where(do, 1, 0)
        return sg, sc, sp, st, hits

    z = jnp.zeros((TB, G), jnp.int32)
    sg, sc, sp, _, hits = jax.lax.fori_loop(0, P, position,
                                            (z, z, z, z, zero))
    og_ref[cols, :] = sg
    oc_ref[cols, :] = sc
    op_ref[cols, :] = sp
    oh_ref[cols] = hits


@functools.partial(jax.jit, static_argnames=("n_slots", "interpret"))
def vote_state(genome, pk, n_slots: int = 8, interpret: bool = False):
    """Run the greedy genome-register scan for a batch of pairs.

    Args:
        genome, pk: int32 [C, B, P] candidate genome / peak id per hash
            function, pair and concatenated mate position (0 = none).

    Returns (slots_g, slots_c, slots_p int32 [B, G], hits int32 [B]).
    """
    C, B, P = pk.shape
    G = n_slots
    TB = block_pairs(B)
    Bp = -(-B // TB) * TB
    if Bp != B:
        pad = ((0, 0), (0, Bp - B), (0, 0))
        genome = jnp.pad(genome, pad)
        pk = jnp.pad(pk, pad)
    # [C, B, P] -> [P, C, B] -> [(P*C), B]: position-major, hash-fn inner
    cg = jnp.transpose(genome, (2, 0, 1)).reshape(P * C, Bp)
    cp = jnp.transpose(pk, (2, 0, 1)).reshape(P * C, Bp)
    slots = jax.ShapeDtypeStruct((Bp, G), jnp.int32)
    og, oc, op, oh = pl.pallas_call(
        functools.partial(_kernel, C=C, G=G, P=P, TB=TB),
        grid=(Bp // TB,),
        out_shape=[slots, slots, slots,
                   jax.ShapeDtypeStruct((Bp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=max(1, TB // 32),
                                             num_stages=1),
        interpret=interpret,
        name="vote_greedy",
    )(cg, cp)
    return og[:B], oc[:B], op[:B], oh[:B]
