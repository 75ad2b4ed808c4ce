"""Pallas kernel (Triton route) for the CI pairwise head phase.

The head phase tests, for every defect voxel (center) against every defect
voxel (witness), whether the first `ns` balls already fail the >= 50%
defect-fraction rule: fail_j <=> count(dmin2 <= r_j^2) < T_j, where dmin2
is the min-over-alias-combos squared scaled distance (ci_pairwise.py).

The XLA head evaluates every alias combo for every center x witness pair
and materializes [row_chunk, K] distances between its fusions.  This
kernel keeps the whole pair loop on chip and skips work the XLA head
cannot: per witness block it tests, from the blocks' coordinate ranges,
which alias combos can place any pair inside the rmax box, and skips the
infeasible combos -- and whole far-apart block pairs -- outright.  Severe
disease is where that pays: K reaches 4096-8192 and the head's work grows
with K^2, but clustered defects leave most block pairs out of reach.

Layout: one program per block of `_RB` centers; it loops over the
witnesses in blocks of `_WB`, so each (center, witness) tile has exactly
one pair per thread and the `ns` per-radius hit counts stay in registers
as [_RB, _WB] partial sums, reduced once after the loop.  The program
returns the first failing head ball per center (ns = none), which is all
the engine reads from the counts.

Exactness: the same f32 expression per combo as the XLA head, and counts
are exact integers, so results are bit-equal (tests/test_ci_pallas.py).
The box check of the XLA head is implied: scale >= 1 means d2 <= r_ns^2
<= r_last^2 bounds every |offset| by rmax.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ventjax.ops.ci_pairwise import SENTINEL

_RB = 32            # centers per program
_WB = 4             # witnesses per loop step
_NUM_WARPS = 4      # 128 threads = one pair of the [_RB, _WB] tile each
# Padded witnesses sit far from every center (real or sentinel), so they
# never count; padded centers are sentinels, and sliced off.
_WPAD = -(1 << 21)


def _head_kernel(ci_ref, cj_ref, ck_ref, wi_ref, wj_ref, wk_ref,
                 wim_ref, wix_ref, wjm_ref, wjx_ref, out_ref, *,
                 combos, scale, r2, t_head, rmax, n_wblocks):
    ci = ci_ref[...][:, None]
    cj = cj_ref[...][:, None]
    ck = ck_ref[...][:, None]
    vim, vix = jnp.min(ci), jnp.max(ci)
    vjm, vjx = jnp.min(cj), jnp.max(cj)
    s0, s1, s2 = (jnp.float32(s) for s in scale)
    ns = len(r2)

    def witness_block(jb, accs):
        wim, wix = wim_ref[jb], wix_ref[jb]
        wjm, wjx = wjm_ref[jb], wjx_ref[jb]
        # oi = wi - ci + p spans [wim - vix + p, wix - vim + p]; a combo
        # can hit only if that interval meets [-rmax, rmax] (same for j;
        # sentinels only widen the intervals, so the test is conservative).
        feasible = [
            (wim - vix + p <= rmax) & (wix - vim + p >= -rmax)
            & (wjm - vjx + q <= rmax) & (wjx - vjm + q >= -rmax)
            for (p, q, _) in combos
        ]
        live = functools.reduce(jnp.logical_or, feasible)

        def count(accs):
            sl = pl.ds(jb * _WB, _WB)
            wi = wi_ref[sl][None, :]
            wj = wj_ref[sl][None, :]
            wk = wk_ref[sl][None, :]
            dmin = jnp.full((_RB, _WB), jnp.inf, jnp.float32)
            for (p, q, s), feas in zip(combos, feasible):
                def combo(d, p=p, q=q, s=s):
                    fx = ((wi - ci) + p).astype(jnp.float32) * s0
                    fy = ((wj - cj) + q).astype(jnp.float32) * s1
                    fz = ((wk - ck) + s).astype(jnp.float32) * s2
                    return jnp.minimum(d, fx * fx + fy * fy + fz * fz)
                dmin = jax.lax.cond(feas, combo, lambda d: d, dmin)
            return tuple(a + (dmin <= jnp.float32(r)).astype(jnp.int32)
                         for a, r in zip(accs, r2))

        return jax.lax.cond(live, count, lambda a: a, accs)

    zero = (jnp.zeros((_RB, _WB), jnp.int32),) * ns
    # A block of sentinel centers (invalid lanes: all i >= SENTINEL) is
    # padding whose head result no caller reads; skip its witness loop.
    accs = jax.lax.cond(
        vim >= SENTINEL, lambda a: a,
        lambda a: jax.lax.fori_loop(0, n_wblocks, witness_block, a), zero)
    first = jnp.full((_RB,), ns, jnp.int32)
    for j in reversed(range(ns)):
        fail = jnp.sum(accs[j], axis=1) < t_head[j]
        first = jnp.where(fail, j, first)
    out_ref[...] = first


@functools.partial(
    jax.jit,
    static_argnames=("combos", "scale", "r2", "t_head", "rmax", "interpret"),
)
def head_first_fail_pallas(
    ci: jnp.ndarray, cj: jnp.ndarray, ck: jnp.ndarray,
    wi: jnp.ndarray, wj: jnp.ndarray, wk: jnp.ndarray,
    *,
    combos: Tuple[Tuple[int, int, int], ...],
    scale: Tuple[float, float, float],
    r2: Tuple[float, ...],
    t_head: Tuple[int, ...],
    rmax: int,
    interpret: bool = False,
) -> jnp.ndarray:
    """[K] int32 index of the first head ball that fails, len(r2) if none.

    ci/cj/ck: [K] int32 center coordinates; wi/wj/wk: [Kw] int32 witness
    coordinates (either may hold sentinel-padded lanes; rows of sentinel
    centers come back with arbitrary values, and callers mask them).
    r2/t_head are the head's squared float32 radii and hit thresholds,
    static because they are geometry constants.  ``interpret`` runs the kernel in the
    Pallas interpreter (tests on the CPU); production never sets it.
    """
    K = ci.shape[0]
    Kw = wi.shape[0]
    kp = -(-K // _RB) * _RB
    kwp = -(-Kw // _WB) * _WB
    cpad = lambda x: jnp.pad(x.astype(jnp.int32), (0, kp - K),
                             constant_values=SENTINEL)
    wpad = lambda x: jnp.pad(x.astype(jnp.int32), (0, kwp - Kw),
                             constant_values=_WPAD)
    ci, cj, ck = cpad(ci), cpad(cj), cpad(ck)
    wi, wj, wk = wpad(wi), wpad(wj), wpad(wk)
    n_wblocks = kwp // _WB
    # Per-witness-block coordinate ranges for the combo-skip tests
    # (compaction emits voxels in ascending flat order, so blocks are
    # spatially coherent and the ranges are tight).
    wib, wjb = wi.reshape(n_wblocks, _WB), wj.reshape(n_wblocks, _WB)
    ranges = (wib.min(1), wib.max(1), wjb.min(1), wjb.max(1))

    kernel = functools.partial(
        _head_kernel, combos=tuple(combos), scale=tuple(scale),
        r2=tuple(r2), t_head=tuple(t_head), rmax=int(rmax),
        n_wblocks=n_wblocks,
    )
    cspec = pl.BlockSpec((_RB,), lambda i: (i,))
    whole = pl.BlockSpec((kwp,), lambda i: (0,))
    rspec = pl.BlockSpec((n_wblocks,), lambda i: (0,))
    out = pl.pallas_call(
        kernel,
        grid=(kp // _RB,),
        in_specs=[cspec] * 3 + [whole] * 3 + [rspec] * 4,
        out_specs=cspec,
        out_shape=jax.ShapeDtypeStruct((kp,), jnp.int32),
        compiler_params=pltriton.CompilerParams(
            num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="ci_head_first_fail",
    )(ci, cj, ck, wi, wj, wk, *ranges)
    return out[:K]
