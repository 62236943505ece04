"""Pallas (Triton) kernel for batched local alignment with span recovery.

The plain `ops.sw.sw_align` runs its row loop as a `lax.scan` that writes
two [M, B, N] int32 tensors (H and the packed origin) to device memory only
to `argmax` them afterwards. This kernel keeps what the DP needs and nothing
more: one program owns a block of pairs (pairs on the block axis), walks the
M x N cells in order, and carries the running best, so the full matrices
never exist.

Recurrence: the sequential Gotoh form of `sw_align`'s, with the
gap-in-query term E as a running register along j,

    H1 = max(max(0, Hdiag + sub), F)     F = Mf[j] + open + i*ext
    E  = max_{j' < j}(H1[j'] - j'*ext) + open + j*ext
    H  = max(H1, E)                      Mf[j] = max(Mf[j], H - i*ext)

with a packed origin i*(N+1) + j threaded through every max decision
(strictly greater wins, so ties keep the earlier operand exactly as
`sw._maxpair` does). The previous row (H, origin) and the column state
(Mf, origin) live in per-program buffers of [N, TB], read and written once
per cell. The best cell is the first maximum in row-major order, the
`argmax` rule of `sw_align`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

NEG = -(1 << 28)
TB = 32      # pairs per program (one warp)
UNROLL = 8   # cells per loop step; their loads are issued together


def _kernel(q_ref, r_ref, h_ref, o_ref, f_ref, fo_ref, out_ref, *, M, N,
            match, mismatch, gap_open, gap_ext):
    cols = pl.ds(pl.program_id(0) * TB, TB)
    zero = jnp.zeros((TB,), jnp.int32)
    neg = jnp.full((TB,), NEG, jnp.int32)
    Np1 = N + 1

    def clear(j, c):
        h_ref[j, cols] = zero
        o_ref[j, cols] = zero
        f_ref[j, cols] = neg
        fo_ref[j, cols] = zero
        return c

    jax.lax.fori_loop(0, N, clear, 0)

    def row(i, best):
        qi = q_ref[i, cols]
        q_ok = qi < 4
        F_off = gap_open + i * gap_ext
        Mf_off = i * gap_ext

        def cells(j0, n, carry):
            Hd, Od, Tm, TmO, rH, rO, rJ = carry
            js = [j0 + u for u in range(n)]
            rj = [r_ref[j, cols] for j in js]
            Hp = [h_ref[j, cols] for j in js]
            Op = [o_ref[j, cols] for j in js]
            Mf = [f_ref[j, cols] for j in js]
            MfO = [fo_ref[j, cols] for j in js]
            for u, j in enumerate(js):
                sub = jnp.where((rj[u] == qi) & (rj[u] < 4) & q_ok,
                                match, mismatch)
                diag = Hd + sub
                diagO = jnp.where(Hd > 0, Od, i * Np1 + j)
                H0 = jnp.maximum(diag, 0)
                F = Mf[u] + F_off
                take = F > H0
                H1 = jnp.where(take, F, H0)
                O1 = jnp.where(take, MfO[u], diagO)
                E = Tm + (gap_open + j * gap_ext)
                take = E > H1
                H = jnp.maximum(jnp.where(take, E, H1), 0)
                O = jnp.where(take, TmO, O1)
                Hm = H - Mf_off
                take = Hm > Mf[u]
                f_ref[j, cols] = jnp.where(take, Hm, Mf[u])
                fo_ref[j, cols] = jnp.where(take, O, MfO[u])
                h_ref[j, cols] = H
                o_ref[j, cols] = O
                T = H1 - j * gap_ext
                take = T > Tm
                Tm = jnp.where(take, T, Tm)
                TmO = jnp.where(take, O1, TmO)
                take = H > rH
                rH = jnp.where(take, H, rH)
                rO = jnp.where(take, O, rO)
                rJ = jnp.where(take, j, rJ)
                Hd, Od = Hp[u], Op[u]
            return Hd, Od, Tm, TmO, rH, rO, rJ

        carry = (zero, zero, neg, zero, zero, zero, zero)
        carry = jax.lax.fori_loop(
            0, N // UNROLL,
            lambda b, c: cells(b * UNROLL, UNROLL, c), carry)
        if N % UNROLL:
            carry = cells((N // UNROLL) * UNROLL, N % UNROLL, carry)
        rH, rO, rJ = carry[4:]
        bH, bO, bI, bJ = best
        take = rH > bH
        return (jnp.where(take, rH, bH), jnp.where(take, rO, bO),
                jnp.where(take, i, bI), jnp.where(take, rJ, bJ))

    bH, bO, bI, bJ = jax.lax.fori_loop(0, M, row, (zero, zero, zero, zero))
    hit = bH > 0
    qstart = bO // Np1
    out_ref[0, cols] = bH
    out_ref[1, cols] = jnp.where(hit, qstart, 0)
    out_ref[2, cols] = jnp.where(hit, bI, 0)
    out_ref[3, cols] = jnp.where(hit, bO - qstart * Np1, 0)
    out_ref[4, cols] = jnp.where(hit, bJ, 0)


@functools.partial(
    jax.jit,
    static_argnames=("match", "mismatch", "gap_open", "gap_ext", "interpret"),
)
def sw_align_pallas(query, ref, match=1, mismatch=-4, gap_open=-6,
                    gap_ext=-1, interpret=False):
    """Batched SW with full span recovery.

    query: uint8 [B, M]; ref: uint8 [B, N] (code 4 = N/pad, never matches).
    Returns int32 [5, B]: score, qstart, qend, rstart, rend (the field order
    of ops.sw._FIELDS), bit-identical to ops.sw.sw_align."""
    B, M = query.shape
    N = ref.shape[1]
    Bp = -(-B // TB) * TB
    q = jnp.full((M, Bp), 4, jnp.int32).at[:, :B].set(query.T)
    r = jnp.full((N, Bp), 4, jnp.int32).at[:, :B].set(ref.T)
    col = jax.ShapeDtypeStruct((N, Bp), jnp.int32)
    kernel = functools.partial(
        _kernel, M=M, N=N, match=match, mismatch=mismatch,
        gap_open=gap_open, gap_ext=gap_ext)
    *_, out = pl.pallas_call(
        kernel,
        grid=(Bp // TB,),
        out_shape=[col, col, col, col,
                   jax.ShapeDtypeStruct((5, Bp), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="sw_align",
    )(q, r)
    return out[:, :B]
