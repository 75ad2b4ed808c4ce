"""Benchmark harness for the five BASELINE.json configs.

Each config measures steady-state device throughput (volumes/sec/chip) for
one slice of the reference pipeline, using the same methodology as the
headline bench.py: compile + warm up, then chained dispatches with ONE wait
at the end (block_until_ready; the cohort driver reads results off the
critical path, so a per-iteration wait is not part of the pipeline).

Configs (BASELINE.json "configs"):
  1. mean-anchored + linear-binning VDP on a single 128x128x16 volume
     (the reference CPU path is Vent_Analysis.py:244-257)
  2. config 1 with N4 bias correction + 99th-pct normalization prepended
     (Vent_Analysis.py:316-334, 254-257)
  3. k-means VDP on the full-resolution 3-D volume (the reference's stub,
     Vent_Analysis.py:259-261, made real)
  4. CI defect-cluster-index map with the 1.5x1.5x10.0mm kernel
     (CI.py:107-145)
  5. batched cohort: 256 subjects, full N4+VDP+CI pipeline, shard_map over
     the available device mesh (on a single-device runner the mesh has 1
     device and the number reported is per device — the sharding path
     itself is validated on a fake 8-device CPU mesh by tests/test_dist.py
     and __graft_entry__.dryrun_multichip, and on four GPUs by
     chip_smoke.py --four)
  6. severe-disease worst case: clustered ~3.5k-voxel defect loads at
     pad 4096 (the block-skip head kernel's regime) — tracked headline
  7. oversize-volume CI: 256x256x64 through the slice-sharded halo
     program (ventjax.dist.halo) AND the unsharded engine, bit-equality
     asserted on the device

Usage:
  python benchmarks/run.py                 # all configs, one JSON line each
  python benchmarks/run.py --configs 1 4   # subset
  python benchmarks/run.py --write-results # also refresh benchmarks/RESULTS.md
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _throughput(fn, args, n_vols: int, iters: int, probe) -> float:
    """volumes/sec: `iters` chained dispatches, one wait at the end."""
    import jax

    jax.block_until_ready(probe(fn(*args)))  # warmup/compile
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(iters)]
    jax.block_until_ready(probe(outs[-1]))
    dt = time.perf_counter() - t0
    return n_vols * iters / dt


def make_severe_defects(batch: int, shape, vox, seed: int = 11) -> np.ndarray:
    """Clustered severe-disease defect volumes: dense ellipsoids planted
    inside the phantom lungs until ~3.4-3.8k defect voxels per volume
    (the K=4096 adaptive-bucket regime a severe CF/COPD cohort hits)."""
    from ventjax.io.phantom import make_phantom

    rng = np.random.default_rng(seed)
    defects = np.zeros((batch, *shape), np.float32)
    H, W, D = shape
    for b in range(batch):
        ph = make_phantom(shape=shape, vox=vox, seed=100 + b)
        m = np.asarray(ph.mask) > 0
        d = np.zeros(shape, np.float32)
        for _ in range(300):
            cc = np.array([rng.integers(H // 4, 3 * H // 4),
                           rng.integers(W // 4, 3 * W // 4),
                           rng.integers(3, max(4, D - 3))])
            rr = np.array([rng.integers(5, 12), rng.integers(5, 12),
                           rng.integers(2, 4)])
            ii, jj, kk = np.ogrid[:H, :W, :D]
            ell = (((ii - cc[0]) / rr[0]) ** 2 + ((jj - cc[1]) / rr[1]) ** 2
                   + ((kk - cc[2]) / rr[2]) ** 2) <= 1
            cand = d.copy()
            cand[ell & m] = 1
            if cand.sum() > 3800:
                continue
            d = cand
            if d.sum() > 3400:
                break
        defects[b] = d
    return defects


def make_inputs(batch: int, shape, vox, seed: int = 0):
    import jax.numpy as jnp

    from ventjax.io.phantom import make_cohort

    hp, mask, _ = make_cohort(batch, shape=shape, vox=vox, seed=seed)
    return jnp.asarray(hp), jnp.asarray(mask)


def bench_config(
    n: int, batch: int, iters: int, shape=(128, 128, 16), vox=(1.5, 1.5, 10.0)
) -> dict:
    import jax
    import jax.numpy as jnp

    from ventjax.config import DEFAULT_CONFIG
    from ventjax.ops import (
        n4_bias_correction,
        vdp_kmeans,
        vdp_linear_binning,
        vdp_mean_anchored,
    )
    from ventjax.pipeline.analyze import analyze_cohort, build_geometry

    hp, mask = make_inputs(batch, shape, vox)
    c = DEFAULT_CONFIG
    V = int(np.prod(shape))
    max_mask = int(np.asarray((mask > 0).sum(axis=(1, 2, 3))).max())
    n4_pad = min(V, -(-max_mask // 8192) * 8192)

    if n == 1:
        def f(h, m):
            d, vdp = vdp_mean_anchored(h, m, c.vdp_thresh)
            _, vdp_lb = vdp_linear_binning(h, m, c.lb_edges, c.lb_percentile)
            return vdp + vdp_lb

        fn = jax.jit(jax.vmap(f))
        args = (hp, mask)
        probe = lambda r: r
        label = "vdp_mean_anchored+linear_binning"
    elif n == 2:
        def f(h, m):
            n4 = n4_bias_correction(
                h, m, mask_pad=n4_pad,
                fitting_levels=c.n4_fitting_levels, max_iters=c.n4_max_iters,
                convergence_threshold=c.n4_convergence_threshold,
                bins=c.n4_histogram_bins, fwhm=c.n4_bias_fwhm,
                wiener_noise=c.n4_wiener_noise,
                control_points=c.n4_control_points,
            )
            d, vdp = vdp_mean_anchored(n4, m, c.vdp_thresh)
            _, vdp_lb = vdp_linear_binning(n4, m, c.lb_edges, c.lb_percentile)
            return vdp + vdp_lb

        fn = jax.jit(jax.vmap(f))
        args = (hp, mask)
        probe = lambda r: r
        label = "n4+99pct_norm+vdp"
    elif n == 3:
        def f(h, m):
            _, vdp_km = vdp_kmeans(
                h, m, c.kmeans_clusters, c.kmeans_iters,
                c.kmeans_defect_clusters, mask_pad=n4_pad,
            )
            return vdp_km

        fn = jax.jit(jax.vmap(f))
        args = (hp, mask)
        probe = lambda r: r
        label = "kmeans_vdp"
    elif n == 4:
        from ventjax.ops.ci import calculate_ci_staged
        from ventjax.ops.ci_pairwise import (
            CIPairwiseGeometry,
            calculate_ci_pairwise,
        )

        # Defect arrays from the real pipeline (sizing pass, not timed).
        cfg0 = c.replace(ci_max_defect_voxels=8192, n4_mask_pad=n4_pad)
        geom0 = build_geometry(vox, shape, cfg0)
        res0 = jax.jit(lambda h, m: analyze_cohort(h, m, geom0, cfg0))(
            hp, mask
        )
        defect = jnp.asarray(np.asarray(res0.defect))
        n_def = int(np.asarray(res0.defect).sum(axis=(1, 2, 3)).max())
        K = max(256, 1 << int(np.ceil(np.log2(max(n_def, 1)))))
        geom = build_geometry(vox, shape, c.replace(ci_max_defect_voxels=K))
        if isinstance(geom, CIPairwiseGeometry):
            ci_one = lambda d: calculate_ci_pairwise(d, geom, K)[0]
        else:
            ci_one = lambda d: calculate_ci_staged(d, geom, K)[0]

        fn = jax.jit(jax.vmap(ci_one))
        args = (defect,)
        probe = lambda r: r
        label = f"ci_map_1.5x1.5x10.0 (defect pad {K})"
    elif n == 5:
        from ventjax.dist import make_batch_mesh, shard_cohort_fn

        cohort = 256
        hp, mask = make_inputs(cohort, shape, vox)
        max_mask = int(np.asarray((mask > 0).sum(axis=(1, 2, 3))).max())
        n4_pad = min(V, -(-max_mask // 8192) * 8192)
        cfg0 = c.replace(ci_max_defect_voxels=8192, n4_mask_pad=n4_pad)
        geom0 = build_geometry(vox, shape, cfg0)
        res0 = jax.jit(lambda h, m: analyze_cohort(h, m, geom0, cfg0))(
            hp[:16], mask[:16]
        )
        n_def = int(np.asarray(res0.defect).sum(axis=(1, 2, 3)).max())
        K = max(256, 1 << int(np.ceil(np.log2(max(n_def, 1)))))
        cfg = c.replace(ci_max_defect_voxels=2 * K, n4_mask_pad=n4_pad)
        geom = build_geometry(vox, shape, cfg)

        from ventjax.pipeline.analyze import analyze_cohort_grouped

        mesh = make_batch_mesh()
        # Grouped execution (lax.map over 16-lane groups, one jit): each
        # group keeps its own N4 convergence exit instead of paying the
        # 256-lane cohort-max iteration count — see analyze_cohort_grouped.
        fn = jax.jit(shard_cohort_fn(
            lambda h, m: analyze_cohort_grouped(
                h, m, geom, cfg, group_size=batch
            ),
            mesh,
        ))
        args = (hp, mask)
        probe = lambda r: r.metrics.vdp
        n_dev = mesh.devices.size
        res = fn(*args)
        assert not bool(np.asarray(res.metrics.ci_overflow).any())
        vols = _throughput(fn, args, cohort, max(2, 64 // (cohort // 16)), probe)
        return {
            "config": 5,
            "label": f"cohort256_full_pipeline ({n_dev} device(s))",
            "volumes_per_sec_per_chip": round(vols / n_dev, 3),
            "batch": cohort,
        }
    elif n == 6:
        # Severe-disease worst case: clustered defect loads (~3.5k
        # voxels/volume over several dense ellipsoids) grow the adaptive
        # bucket to K=4096 — the block-skip head kernel's regime.  The friendly config-4 row sizes K from the phantom's
        # natural sparse defects; this row is the number a severe CF/COPD
        # cohort actually sees.
        from ventjax.ops.ci import calculate_ci_staged
        from ventjax.ops.ci_pairwise import (
            CIPairwiseGeometry,
            calculate_ci_pairwise,
        )

        defect = jnp.asarray(make_severe_defects(batch, shape, vox))
        n_def = int(np.asarray(defect).sum(axis=(1, 2, 3)).max())
        K = 4096
        assert n_def <= K, n_def
        geom = build_geometry(vox, shape, c.replace(ci_max_defect_voxels=K))
        if isinstance(geom, CIPairwiseGeometry):
            ci_one = lambda d: calculate_ci_pairwise(d, geom, K)
        else:
            ci_one = lambda d: calculate_ci_staged(d, geom, K)[:3]

        fn = jax.jit(jax.vmap(lambda d: ci_one(d)[0]))
        ovf = jax.jit(jax.vmap(lambda d: ci_one(d)[2]))(defect)
        assert not bool(np.asarray(ovf).any()), \
            "severe bench overflowed its pads — not a valid measurement"
        args = (defect,)
        probe = lambda r: r
        label = (f"ci_map_severe_disease (defect ~{n_def}, pad {K}, "
                 f"target >=100)")
    elif n == 7:
        # Oversize-volume CI: 256x256x64 —
        # 64x the voxel count of the standard geometry, the regime
        # `analyze --shard-slices` exists for.  Times BOTH product paths
        # on the visible devices: the unsharded single-chip engine and the
        # slice-sharded halo program (n_shards = all visible devices,
        # capped by the 8-slice halo; on one device the row quantifies
        # the halo program's overhead vs unsharded — multi-shard
        # bit-equality is validated on the fake 8-device mesh by
        # tests/test_dist.py and on four GPUs by chip_smoke.py --four).
        # The two warmup results are asserted bit-equal on the device.
        import jax

        from ventjax.dist.halo import calculate_ci_sharded, halo_width
        from ventjax.ops.ci_pairwise import (
            build_ci_pairwise_geometry,
            calculate_ci_pairwise,
        )

        oshape = (256, 256, 64)
        defect = jnp.asarray(make_severe_defects(1, oshape, vox)[0])
        n_def = int(np.asarray(defect).sum())
        K = 4096
        assert n_def <= K, n_def
        geom = build_ci_pairwise_geometry(vox, oshape, 50, "wrap")
        n_shards = min(len(jax.devices()), oshape[2] // halo_width(geom))

        fn_u = jax.jit(lambda d: calculate_ci_pairwise(d, geom, K))
        fn_s = lambda d: calculate_ci_sharded(
            d, geom, n_shards=n_shards, max_defect_voxels=K
        )
        ci_u, _, ovf_u = fn_u(defect)
        ci_s, _, ovf_s = fn_s(defect)
        assert not bool(np.asarray(ovf_u)) and not bool(np.asarray(ovf_s)), \
            "oversize bench overflowed its pads — not a valid measurement"
        assert np.array_equal(np.asarray(ci_u), np.asarray(ci_s)), \
            "halo program != unsharded engine on the device"
        vols_u = _throughput(fn_u, (defect,), 1, iters, lambda r: r[0])
        vols_s = _throughput(fn_s, (defect,), 1, iters, lambda r: r[0])
        return {
            "config": 7,
            "label": (f"ci_map_oversize_256x256x64 (defect ~{n_def}, pad "
                      f"{K}, halo x{n_shards} shard(s); unsharded "
                      f"{round(vols_u, 1)} vol/s)"),
            "volumes_per_sec_per_chip": round(vols_s / max(n_shards, 1), 3),
            "batch": 1,
        }
    else:
        raise ValueError(n)

    vols = _throughput(fn, args, batch, iters, probe)
    return {
        "config": n,
        "label": label,
        "volumes_per_sec_per_chip": round(vols, 3),
        "batch": batch,
    }


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--configs", type=int, nargs="*",
                   default=[1, 2, 3, 4, 5, 6, 7])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--write-results", action="store_true")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    # Persistent compile cache: the timed loops never compile, so
    # steady-state numbers are unaffected.  VENTJAX_NO_CACHE=1 disables.
    from ventjax.utils.profiling import enable_compile_cache

    enable_compile_cache()

    rows = []
    for n in args.configs:
        row = bench_config(n, args.batch, args.iters)
        rows.append(row)
        print(json.dumps(row))

    if args.write_results:
        import jax

        dev = jax.devices()[0]
        lines = [
            "# Benchmark results (BASELINE.json configs)",
            "",
            f"Device: {dev.platform} ({dev.device_kind}); "
            "128x128x16 volumes, vox 1.5x1.5x10.0mm, synthetic phantoms.",
            "Methodology: chained dispatches, one wait (see run.py).",
            "",
            "| # | Config | volumes/sec/chip |",
            "|---|---|---|",
        ]
        for r in rows:
            lines.append(
                f"| {r['config']} | {r['label']} | "
                f"{r['volumes_per_sec_per_chip']} |"
            )
        lines.append("")
        lines.append(
            "The reference CPU pipeline runs ~1 subject/min (its own "
            "timing prints: seconds for N4, minutes for CI — BASELINE.md)."
        )
        # Preserve sections other tools maintain (e.g. the serving-latency
        # table from benchmarks/latency.py): keep everything from the first
        # "## " heading of the existing file onward.
        try:
            with open("benchmarks/RESULTS.md") as f:
                old = f.read()
            cut = old.find("\n## ")
            if cut != -1:
                lines.append(old[cut:].rstrip("\n"))
        except FileNotFoundError:
            pass
        with open("benchmarks/RESULTS.md", "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
