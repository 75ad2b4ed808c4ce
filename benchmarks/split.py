"""Differential component-split bench: where does the fused ms/vol go?

The split is measured differentially: standalone jitted pieces, chained
dispatches, one wait at the end.  Numbers are ms/volume at the given
batch.  (A profiler trace gives the same split per fusion; this script
needs no trace reader.)

Usage: python benchmarks/split.py [--batch 16] [--iters 30]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, args, iters, batch):
    import jax

    jax.block_until_ready(fn(*args))  # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        outs = fn(*args)
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters / batch * 1e3


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from ventjax.config import DEFAULT_CONFIG
    from ventjax.io.phantom import make_cohort
    from ventjax.ops import (
        calculate_snr,
        n4_bias_correction,
        vdp_kmeans,
        vdp_linear_binning,
        vdp_mean_anchored,
    )
    from ventjax.ops.basic import sort_compact_masked
    from ventjax.ops.ci_pairwise import calculate_ci_pairwise
    from ventjax.pipeline.analyze import analyze_cohort, build_geometry

    B = args.batch
    shape = (128, 128, 16)
    vox = (1.5, 1.5, 10.0)
    V = int(np.prod(shape))
    c = DEFAULT_CONFIG
    hp_np, mask_np, _ = make_cohort(B, shape=shape, vox=vox, seed=0)
    hp = jnp.asarray(hp_np)
    mask = jnp.asarray(mask_np)
    max_mask = int((mask_np > 0).sum(axis=(1, 2, 3)).max())
    P = min(V, -(-max_mask // 8192) * 8192)

    # sizing pass for the defect pad
    cfg0 = c.replace(ci_max_defect_voxels=8192, n4_mask_pad=P)
    geom0 = build_geometry(vox, shape, cfg0)
    res0 = jax.jit(lambda h, m: analyze_cohort(h, m, geom0, cfg0))(hp, mask)
    defect = jnp.asarray(np.asarray(res0.defect))
    n_def = int(np.asarray(res0.defect).sum(axis=(1, 2, 3)).max())
    K = max(256, 1 << int(np.ceil(np.log2(max(n_def, 1)))))
    cfg = c.replace(ci_max_defect_voxels=K, n4_mask_pad=P)
    geom = build_geometry(vox, shape, cfg)

    rows = {}

    rows["full_pipeline"] = timed(
        jax.jit(lambda h, m: analyze_cohort(h, m, geom, cfg)),
        (hp, mask), args.iters, B,
    )

    rows["compaction_sort"] = timed(
        jax.jit(jax.vmap(
            lambda h, m: sort_compact_masked(
                h.reshape(-1), m.reshape(-1) > 0, P
            )[1]
        )),
        (hp, mask), args.iters, B,
    )

    rows["n4"] = timed(
        jax.jit(jax.vmap(lambda h, m: n4_bias_correction(
            h, m, mask_pad=P,
            fitting_levels=c.n4_fitting_levels, max_iters=c.n4_max_iters,
            convergence_threshold=c.n4_convergence_threshold,
            bins=c.n4_histogram_bins, fwhm=c.n4_bias_fwhm,
            wiener_noise=c.n4_wiener_noise,
            control_points=c.n4_control_points,
        ))),
        (hp, mask), args.iters, B,
    )

    rows["snr"] = timed(
        jax.jit(jax.vmap(
            lambda h, m: calculate_snr(h, m, c.snr_fov_buffer)
        )),
        (hp, mask), args.iters, B,
    )

    rows["vdp_mean_anchored"] = timed(
        jax.jit(jax.vmap(
            lambda h, m: vdp_mean_anchored(h, m, c.vdp_thresh)[1]
        )),
        (hp, mask), args.iters, B,
    )

    rows["vdp_lb"] = timed(
        jax.jit(jax.vmap(lambda h, m: vdp_linear_binning(
            h, m, c.lb_edges, c.lb_percentile
        )[1])),
        (hp, mask), args.iters, B,
    )

    rows["kmeans_own_compaction"] = timed(
        jax.jit(jax.vmap(lambda h, m: vdp_kmeans(
            h, m, c.kmeans_clusters, c.kmeans_iters,
            c.kmeans_defect_clusters, mask_pad=P,
        )[1])),
        (hp, mask), args.iters, B,
    )

    rows[f"ci_K{K}"] = timed(
        jax.jit(jax.vmap(
            lambda d: calculate_ci_pairwise(d, geom, K)[0]
        )),
        (defect,), args.iters, B,
    )

    for k, v in rows.items():
        print(json.dumps({"component": k, "ms_per_vol": round(v, 4)}))


if __name__ == "__main__":
    main()
