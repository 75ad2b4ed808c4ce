"""K-means VDP [Kirby 2012] — jit-compiled Lloyd's iterations on device.

The reference imports sklearn.cluster.KMeans but leaves the computation
commented out (Vent_Analysis.py:19,259-261) with a declared-but-never-filled
metadata key 'VDP_km' (line 90).  This op implements it for real, with
deterministic quantile initialization so device and oracle
(ventjax.oracle.reference.vdp_kmeans) agree exactly.

Device mapping: Lloyd's iterations run on a *compacted* padded vector of masked
voxels (lungs are ~15-20% of the volume), like the N4 fit — the pipeline
passes the same static `mask_pad`, so the StudyMetrics.n4_overflow flag
covers both ops' truncation.  Only the final cluster assignment touches the
full volume (once, outside the loop).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _masked_quantiles(vals: jnp.ndarray, m: jnp.ndarray, k: int) -> jnp.ndarray:
    """np.quantile(vals[m>0], (arange(k)+0.5)/k) with static shapes
    (linear interpolation convention), via one shared-read multi-rank
    bitspace selection."""
    from ventjax.ops.basic import masked_kth_smallest_multi

    n = jnp.sum(m > 0)
    qs = (jnp.arange(k) + 0.5) / k
    pos = qs * (n - 1).astype(vals.dtype)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.ceil(pos).astype(jnp.int32)
    f = (pos - lo).astype(vals.dtype)
    sel = masked_kth_smallest_multi(vals, m, jnp.concatenate([lo, hi]))
    return (1 - f) * sel[:k] + f * sel[k:]


def vdp_kmeans(
    n4: jnp.ndarray,
    mask: jnp.ndarray,
    k: int = 4,
    iters: int = 30,
    defect_clusters: int = 1,
    mask_pad: Optional[int] = None,
    compacted=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lloyd's k-means on masked intensities; lowest cluster(s) = defect.

    mask_pad statically bounds the masked-voxel count for the compacted
    iteration (None = full volume, always safe); excess voxels are ignored
    by the center fit — the pipeline passes its n4_mask_pad, whose overflow
    flag covers this op too.  `compacted` optionally supplies
    (vals, wv) already compacted over mask > 0 (the pipeline reuses N4's
    compaction, saving this op's sort).  Returns (defect array 0/1 floats,
    VDP_km percent).
    """
    dtype = jnp.float64 if n4.dtype == jnp.float64 else jnp.float32
    flat = n4.reshape(-1).astype(dtype)
    flat_m = mask.reshape(-1) > 0
    V = flat.shape[0]
    P = V if mask_pad is None else min(int(mask_pad), V)

    from ventjax.ops.basic import sort_compact_masked

    if compacted is None:
        _, vals, n_m = sort_compact_masked(flat, flat_m, P)
        wv = (jnp.arange(P) < n_m).astype(dtype)
    else:
        vals, wv = compacted
        vals = vals.astype(dtype)
        wv = wv.astype(dtype)

    centers0 = _masked_quantiles(vals, wv, k)

    def _assign_first_min(flat_vals, centers):
        """argmin_j |v - c_j| with first-of-ties semantics, built from
        elementwise passes only (k is tiny, so no [N, k] distance matrix
        is materialized): the running min, then the lowest index
        attaining it."""
        ds = [jnp.abs(flat_vals - centers[j]) for j in range(k)]
        dmin = ds[0]
        for j in range(1, k):
            dmin = jnp.minimum(dmin, ds[j])
        assign = jnp.full(flat_vals.shape, k - 1, jnp.int32)
        for j in range(k - 1, -1, -1):
            assign = jnp.where(ds[j] == dmin, j, assign)
        return assign

    def body(carry):
        i, centers, _ = carry
        assign = _assign_first_min(vals, centers)
        # per-cluster masked reductions (k fused [P] passes, no one-hot)
        sums = jnp.stack([
            jnp.sum(jnp.where(assign == j, wv * vals, 0.0))
            for j in range(k)
        ])
        counts = jnp.stack([
            jnp.sum(jnp.where(assign == j, wv, 0.0)) for j in range(k)
        ])
        new = jnp.where(counts > 0, sums / jnp.where(counts > 0, counts, 1.0),
                        centers)
        # Early stop when centers are exactly unchanged: further iterations
        # would be no-ops, so the result is identical to fixed-count Lloyd's.
        return i + 1, new, jnp.all(new == centers)

    _, centers, _ = jax.lax.while_loop(
        lambda c: (c[0] < iters) & ~c[2],
        body,
        (jnp.asarray(0), centers0, jnp.asarray(False)),
    )

    # Final assignment over the full volume (once): defect = membership in
    # the defect_clusters lowest-mean clusters.  Summing equality tests
    # against the sorted-order original indices avoids a [V] gather.
    assign_full = _assign_first_min(flat, centers)
    order = jnp.argsort(centers)
    defect_flat = jnp.zeros(V, n4.dtype)
    for i in range(int(defect_clusters)):
        defect_flat = defect_flat + (assign_full == order[i]).astype(n4.dtype)
    defect = (defect_flat * flat_m.astype(n4.dtype)).reshape(n4.shape)
    vdp_km = 100.0 * jnp.sum(defect) / jnp.sum(mask)
    return defect, vdp_km
