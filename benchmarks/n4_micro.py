"""Micro-bench of N4's internal phases: sharpen vs B-spline fit vs setup.

Each phase runs under a lax.fori_loop whose body feeds its output back into
its input (so XLA cannot hoist or CSE the work), batch-vmapped like the
pipeline.  Reported as ms per iteration per batch — multiply by ~49
(observed convergence) for the per-call cost.

Usage: python benchmarks/n4_micro.py [--batch 16] [--loop 25]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, args, reps=3, chain=4):
    """Best of `reps`: `chain` chained dispatches, one wait, divided out
    (amortizes per-call host overhead)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(chain)]
        jax.block_until_ready(outs[-1])
        best = min(best, (time.perf_counter() - t0) / chain)
    return best


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--loop", type=int, default=100)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from ventjax.io.phantom import make_cohort
    from ventjax.ops.basic import sort_compact_masked
    from ventjax.ops.n4 import _bspline_rows, _sharpen_vec
    from ventjax.oracle.n4_oracle import _next_pow2_padded

    B, L = args.batch, args.loop
    shape = (128, 128, 16)
    H, W, D = shape
    V = int(np.prod(shape))
    hp_np, mask_np, _ = make_cohort(B, shape=shape, vox=(1.5, 1.5, 10.0),
                                    seed=0)
    hp = jnp.asarray(hp_np)
    mask = jnp.asarray(mask_np)
    max_mask = int((mask_np > 0).sum(axis=(1, 2, 3)).max())
    P = min(V, -(-max_mask // 8192) * 8192)
    bins, fwhm, wiener = 200, 0.15, 0.01
    padded = _next_pow2_padded(bins)
    offset = (padded - bins) // 2

    @jax.jit
    @jax.vmap
    def compact(h, m):
        return sort_compact_masked(h.reshape(-1), m.reshape(-1) > 0, P)

    idx, vals, n_mask = compact(hp, mask)
    wv = (jnp.arange(P)[None, :] < n_mask[:, None]).astype(jnp.float32)
    logv = jnp.log(jnp.maximum(vals, 1e-30)) * wv
    hc = (idx // (W * D)).astype(jnp.int32)
    wc = ((idx // D) % W).astype(jnp.int32)
    sc = (idx % D).astype(jnp.int32)

    rows = {}
    rows["compaction_ms_per_vol"] = (
        timed(lambda h, m: compact(h, m)[1], (hp, mask)) / B * 1e3
    )

    # --- sharpen phase --------------------------------------------------
    @jax.jit
    @jax.vmap
    def sharpen_loop(logu0, w):
        def body(_, lu):
            s = _sharpen_vec(lu, w, bins, fwhm, wiener, padded, offset)
            return lu - 1e-6 * s

        return jax.lax.fori_loop(0, L, body, logu0)

    rows["sharpen_ms_per_iter_batch"] = (
        timed(sharpen_loop, (logv, wv)) / L * 1e3
    )

    # --- fit phase (level 3, ncp=11 — the largest) -----------------------
    level = 3
    n_elements = 1 * 2 ** level
    ncp = n_elements + 3
    dtype = jnp.float32

    @jax.jit
    @jax.vmap
    def fit_loop(residual0, w, hcv, wcv, scv):
        brv = _bspline_rows(hcv, H, n_elements, dtype)
        bcv = _bspline_rows(wcv, W, n_elements, dtype)
        bsv = _bspline_rows(scv, D, n_elements, dtype)
        sv = (brv ** 2).sum(1) * (bcv ** 2).sum(1) * (bsv ** 2).sum(1)
        bo = (bcv[:, :, None] * bsv[:, None, :]).reshape(P, ncp * ncp)
        bo3 = (bcv[:, :, None] ** 3 * bsv[:, None, :] ** 3).reshape(
            P, ncp * ncp)
        bo2 = (bcv[:, :, None] ** 2 * bsv[:, None, :] ** 2).reshape(
            P, ncp * ncp)
        brv3 = brv ** 3
        bo_h = bo.astype(jnp.bfloat16)
        bo3_h = bo3.astype(jnp.bfloat16)
        hi = jax.lax.Precision.HIGH
        den = jnp.einsum("pc,pf->cf", w[:, None] * brv ** 2, bo2,
                         precision=hi)

        def body(_, residual):
            a_v = residual / jnp.maximum(sv, 1e-30)
            num = jnp.einsum(
                "pc,pf->cf", (a_v[:, None] * brv3).astype(jnp.bfloat16),
                bo3_h, preferred_element_type=jnp.float32)
            phi = jnp.where(den != 0.0,
                            num / jnp.where(den != 0.0, den, 1.0), 0.0)
            g = jnp.einsum("pf,cf->pc", bo_h, phi.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32)
            delta = jnp.sum(brv * g, axis=1) * w
            return residual - 1e-6 * delta

        return jax.lax.fori_loop(0, L, body, residual0)

    rows["fit_ncp11_ms_per_iter_batch"] = (
        timed(fit_loop, (logv, wv, hc, wc, sc)) / L * 1e3
    )

    # --- convergence reduction phase -------------------------------------
    @jax.jit
    @jax.vmap
    def conv_loop(delta0, w):
        def body(_, delta):
            ed = jnp.exp(-delta)
            nmask = jnp.sum(w)
            mu = jnp.sum(ed * w) / nmask
            sd = jnp.sqrt(jnp.sum(w * (ed - mu) ** 2) / nmask)
            return delta + 1e-9 * (sd / mu)

        return jax.lax.fori_loop(0, L, body, delta0)

    rows["convergence_ms_per_iter_batch"] = (
        timed(conv_loop, (logv * 1e-3, wv)) / L * 1e3
    )

    for k, v in rows.items():
        print(json.dumps({"phase": k, "ms": round(v, 4)}))


if __name__ == "__main__":
    main()
