"""The fused study pipeline: one jitted program per (shape, vox, config).

analyze_study fuses the reference's calculate_VDP + calculate_CI call stacks
(Vent_Analysis.py:239-271) into a single XLA program: SNR -> N4 ->
mean-anchored VDP -> linear-binning VDP -> k-means VDP -> CI map -> metrics.
analyze_cohort vmaps it over a [N,H,W,D] batch; ventjax.dist shards that
batch axis over a device mesh.

Per-subject error isolation (SURVEY.md §5): a subject with an empty mask
produces NaN metrics and valid=False instead of poisoning the batch.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ventjax.config import DEFAULT_CONFIG, VentConfig
from ventjax.ops import (
    calculate_ci,
    calculate_snr,
    gradient_border,
    masked_sorted_index,
    n4_bias_correction,
    vdp_kmeans,
    vdp_linear_binning,
    vdp_mean_anchored,
)
from ventjax.ops.ci import CIGeometry, build_ci_geometry
from ventjax.ops.ci_pairwise import (
    CIPairwiseGeometry,
    build_ci_pairwise_geometry,
    calculate_ci_pairwise,
)
from ventjax.pipeline.result import StudyMetrics, VentResult
from ventjax.utils.profiling import stage


def analyze_study(
    hp: jnp.ndarray,
    mask: jnp.ndarray,
    geom: CIGeometry,
    config: VentConfig = DEFAULT_CONFIG,
    export_compact: bool = False,
) -> VentResult:
    """Full analysis of one [H,W,D] study.  Pure; jit/vmap freely.

    export_compact=True additionally fills VentResult.export with the
    compact-transfer pack (masked n4 values + defect flags at the shared
    mask-compaction indices, plus the B-spline lattice vector) — two [P]
    gathers and a tiny concat, so the cohort driver can ship ~0.15 MB per
    subject instead of two dense volumes.
    """
    c = config
    hp = hp.astype(jnp.float32)
    mask = mask.astype(jnp.float32)
    n_mask = jnp.sum(mask > 0)
    valid = n_mask > 0
    # Guard: an all-empty mask must not produce infs that slow CPU paths or
    # NaN-poison reductions inside ops; substitute a trivial mask and
    # invalidate the metrics afterwards.
    safe_mask = jnp.where(valid, mask, jnp.ones_like(mask))

    with stage("snr"):
        snr = calculate_snr(hp, safe_mask, c.snr_fov_buffer)
    with stage("n4"):
        # One mask compaction, shared by N4 (which sub-masks img > 0 via
        # weights) and k-means (which consumes N4's compacted output).
        from ventjax.ops.basic import sort_compact_masked

        V = int(np.prod(hp.shape))
        P = V if c.n4_mask_pad is None else min(int(c.n4_mask_pad), V)
        comp = sort_compact_masked(hp.reshape(-1), safe_mask.reshape(-1) > 0, P)
        n4_out = n4_bias_correction(
            hp,
            safe_mask,
            fitting_levels=c.n4_fitting_levels,
            max_iters=c.n4_max_iters,
            convergence_threshold=c.n4_convergence_threshold,
            bins=c.n4_histogram_bins,
            fwhm=c.n4_bias_fwhm,
            wiener_noise=c.n4_wiener_noise,
            control_points=c.n4_control_points,
            mask_pad=c.n4_mask_pad,
            return_overflow=True,
            return_phi=export_compact,
            return_compacted=True,
            compacted=comp,
        )
        if export_compact:
            n4, n4_overflow, n4_phi, n4_comp = n4_out
        else:
            n4, n4_overflow, n4_comp = n4_out
    with stage("vdp_mean_anchored"):
        defect, vdp = vdp_mean_anchored(n4, safe_mask, c.vdp_thresh)
        defect_border = (gradient_border(defect) == 1).astype(jnp.float32)
    with stage("vdp_linear_binning"):
        defect_lb, vdp_lb = vdp_linear_binning(
            n4, safe_mask, c.lb_edges, c.lb_percentile
        )
    with stage("vdp_kmeans"):
        _, n4_vals_c, wv_c = n4_comp
        defect_km, vdp_km = vdp_kmeans(
            n4, safe_mask, c.kmeans_clusters, c.kmeans_iters,
            c.kmeans_defect_clusters, mask_pad=c.n4_mask_pad,
            compacted=(n4_vals_c, wv_c),
        )
    with stage("ci"):
        if isinstance(geom, CIPairwiseGeometry):
            ci_map, n_saturated, ci_overflow = calculate_ci_pairwise(
                defect, geom, c.ci_max_defect_voxels, tail_k=c.ci_tail_k
            )
        else:
            from ventjax.ops.ci import calculate_ci_staged

            ci_map, n_saturated, ci_overflow, stage_ovf = calculate_ci_staged(
                defect, geom, c.ci_max_defect_voxels
            )
            ci_overflow = ci_overflow | (stage_ovf > 0)

    # Subject CI: sorted CI over defect voxels at floor-index percentile
    # (Vent_Analysis.py:268-270).  NaN when there are no defect voxels
    # (the reference would raise an IndexError there).
    has_defect = jnp.sum(defect) > 0
    ci_val = jnp.where(
        has_defect,
        masked_sorted_index(ci_map, defect, c.ci_percentile),
        jnp.nan,
    )

    vox_cc = float(np.prod(geom.vox) / 1000.0)  # mm^3 -> cc (static)
    lung_volume = jnp.sum(mask == 1) * vox_cc / 1000.0        # liters
    defect_volume = jnp.sum(defect == 1) * vox_cc / 1000.0

    nanify = lambda x: jnp.where(valid, x, jnp.nan)
    metrics = StudyMetrics(
        snr=nanify(snr),
        vdp=nanify(vdp),
        vdp_lb=nanify(vdp_lb),
        vdp_km=nanify(vdp_km),
        lung_volume=lung_volume,
        defect_volume=nanify(defect_volume),
        ci=nanify(ci_val),
        ci_saturated=n_saturated,
        ci_overflow=ci_overflow,
        n4_overflow=n4_overflow,
        valid=valid,
    )
    export = None
    if export_compact:
        # Compact-transfer pack: the DENSE n4 gathered at the shared
        # mask-compaction indices (comp[0] — ascending flat order, so the
        # host's np.flatnonzero(mask) reproduces them exactly), plus the
        # lattice vector that regenerates the bias field off-mask.  Masked
        # voxels — the only ones any metric touches — rebuild bit-exactly;
        # see pipeline/cohort._rebuild_compact_pack for the host side.
        # (defect travels as its own compaction indices in the cohort pack:
        # the 3x3 median can switch ON boundary voxels OUTSIDE the mask, so
        # defect is NOT reconstructible from mask-index flags.)
        export = {
            "n4_cv": n4.reshape(-1)[comp[0]],
            "phi": n4_phi,
        }
    return VentResult(
        n4=n4,
        defect=defect,
        defect_lb=defect_lb,
        defect_km=defect_km,
        defect_border=defect_border,
        ci_map=ci_map,
        metrics=metrics,
        export=export,
    )


def analyze_cohort(
    hp: jnp.ndarray,
    mask: jnp.ndarray,
    geom: CIGeometry,
    config: VentConfig = DEFAULT_CONFIG,
    export_compact: bool = False,
) -> VentResult:
    """vmap of analyze_study over a [N,H,W,D] cohort."""
    return jax.vmap(
        lambda h, m: analyze_study(h, m, geom, config, export_compact)
    )(hp, mask)


def analyze_cohort_grouped(
    hp: jnp.ndarray,
    mask: jnp.ndarray,
    geom: CIGeometry,
    config: VentConfig = DEFAULT_CONFIG,
    group_size: int = 16,
    export_compact: bool = False,
) -> VentResult:
    """analyze_cohort over a large [N,H,W,D] cohort, executed as sequential
    ``group_size``-lane groups inside ONE jitted program (lax.map).

    Why not a single N-lane vmap: every lane of a vmapped while_loop runs
    until the LAST lane converges (converged lanes freeze via their done
    flag but still occupy device time), so a 256-lane N4 pays the cohort-max
    iteration count on all lanes.  Grouping
    restores each 16-lane group's own convergence exit — and its own
    adaptive defect compaction occupancy — while keeping one dispatch and
    one compiled program.  Lanes are computationally independent (the same
    property that makes the shard_map path bit-identical, tests/test_dist),
    so results are bitwise equal to the ungrouped vmap.

    N not divisible by group_size (or N <= group_size) falls back to the
    plain vmap.  Composes with ventjax.dist.shard_cohort_fn: shard first,
    then each device maps over its N/ndev/group_size groups.
    """
    B = hp.shape[0]
    if B <= group_size or B % group_size != 0:
        return analyze_cohort(hp, mask, geom, config, export_compact)
    G = B // group_size
    gh = hp.reshape(G, group_size, *hp.shape[1:])
    gm = mask.reshape(G, group_size, *mask.shape[1:])
    res = jax.lax.map(
        lambda t: analyze_cohort(t[0], t[1], geom, config, export_compact),
        (gh, gm),
    )
    return jax.tree_util.tree_map(
        lambda x: x.reshape(B, *x.shape[2:]), res
    )


def build_geometry(
    vox: Tuple[float, float, float],
    shape: Tuple[int, int, int],
    config: VentConfig = DEFAULT_CONFIG,
):
    """CI geometry for the configured engine (host-cached per vox/shape).

    The pairwise engine proves its float32 distance binning exact for the
    geometry at build time; geometries that fail the proof (rare voxel-size
    combinations whose shell boundaries collide within float32 resolution)
    fall back to the gather-ladder engine automatically — slower, same
    results.
    """
    if config.ci_engine == "pairwise":
        try:
            return build_ci_pairwise_geometry(
                tuple(vox), tuple(shape), config.ci_rmax, config.ci_border_mode
            )
        except ValueError:
            pass
    return build_ci_geometry(
        tuple(vox), tuple(shape), config.ci_rmax, config.ci_border_mode
    )


@functools.lru_cache(maxsize=8)
def make_analyze_fn(
    vox: Tuple[float, float, float],
    shape: Tuple[int, int, int],
    config: VentConfig = DEFAULT_CONFIG,
    batched: bool = False,
):
    """Build and jit the pipeline for a fixed (vox, volume shape, config)."""
    geom = build_geometry(vox, shape, config)
    fn = analyze_cohort if batched else analyze_study
    return jax.jit(lambda hp, mask: fn(hp, mask, geom, config))
