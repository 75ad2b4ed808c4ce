"""Slice-axis (D) sharded CI via halo exchange — the stencil analog of
sequence parallelism (SURVEY.md §5 long-context).

For volumes whose slice axis is sharded over a mesh axis, each device
computes CI for the defect voxels of its local slab.  The pairwise engine
only needs *witness* defect voxels within the sphere reach — a reach of
ceil(r_last/scale_z)+1 slices (one slab of slack covers the wrap-alias
candidates, which shift dk by at most 1) — so each device compacts its
slab's defect coordinates once and ppermutes fixed-size boundary
COORDINATE buffers with its neighbors (sparse halo: ~3*halo_pad ints vs
a dense H*W*hz slab), then runs the exact two-phase engine on (local
centers, local+halo witnesses).  Results are bit-identical to the
unsharded engine (tests/test_dist.py, tests/test_models.py).

Product surface: ``calculate_ci_sharded`` pads the slice axis to the mesh,
builds/caches the jitted program, and returns the same (ci_map, n_saturated,
overflow) triple as ``calculate_ci_pairwise`` — reachable from the CLI via
``analyze --shard-slices`` (config ``ci_shard_slices``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ventjax.ops.ci_pairwise import (
    SENTINEL,
    CIPairwiseGeometry,
    resolve_balls_two_phase,
)


def halo_width(geom: CIPairwiseGeometry) -> int:
    """Slabs of witness context needed on each side of a shard."""
    reach = int(np.floor(np.sqrt(geom.r2_last) / geom.scale[2]))
    return reach + 1  # +1: wrap-alias candidates shift dk by +-1


def padded_depth_for(depth: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= depth (zero-padding the slice axis
    adds no defect voxels and — with the geometry kept at the ORIGINAL
    shape — no alias images, so results stay bit-identical)."""
    return -(-depth // n_shards) * n_shards


def make_sliced_ci_fn(
    geom: CIPairwiseGeometry,
    mesh: Mesh,
    axis_name: str = "space",
    max_defect_per_shard: int = 2048,
    halo_pad: Optional[int] = None,
    padded_depth: Optional[int] = None,
    head_balls: int = 128,
    tail_k: Optional[int] = None,
    use_pallas: Optional[bool] = None,
    interpret: bool = False,
):
    """Build a jitted fn: defect [H,W,Dp] (Dp sharded) -> (ci_map, n_saturated,
    overflow) with the same semantics as calculate_ci_pairwise.

    ``padded_depth`` (default: geom depth D) is the physical array depth Dp;
    it must be a multiple of the mesh axis and >= D.  The CI geometry —
    including the reference's wrap-alias images — is always that of the
    ORIGINAL (H, W, D) volume; pad slices are dead space holding no centers
    and no witnesses, so a zero-padded call is bit-identical to the
    unsharded engine on the unpadded volume.

    The halo exchange is SPARSE: each shard compacts its local slab once
    (defect coordinates, [K] lanes), selects the boundary defects within
    the hz-slice halo reach from that compacted list, and ppermutes
    fixed-size ``halo_pad``-lane coordinate buffers (+1-encoded so the
    zeros edge devices receive decode as empty) instead of dense boundary
    slabs.  That makes the per-shard compaction cost scale with V/n_shards
    and shrinks the ICI payload from H*W*hz floats to 3*halo_pad ints
    (~50x for 256x256 slabs); the dense-slab design measured 2.3x slower
    than the unsharded engine at one shard from its two full slab+halo
    compactions (benchmarks config 7).

    Each shard then runs the same two-phase engine as the unsharded path
    (head compare-reduce, then a compacted order-statistics tail over
    ``tail_k`` lanes, default max(256, K//8) per shard): centers are the
    local slab, witnesses the local compaction + both received halo
    buffers (K + 2*halo_pad lanes; ``halo_pad`` defaults to K//2).
    ``use_pallas``/``interpret`` choose the head exactly as in
    ``calculate_ci_pairwise``.  Per-shard center/halo/tail overflow
    saturates those rows and sets the psum'd overflow flag (never
    silently wrong).
    """
    H, W, D = geom.shape
    n_shards = mesh.shape[axis_name]
    Dp = D if padded_depth is None else int(padded_depth)
    if Dp < D:
        raise ValueError(f"padded_depth {Dp} is smaller than the volume depth {D}")
    if Dp % n_shards != 0:
        raise ValueError(
            f"slice axis must divide the mesh: pad the volume to "
            f"{padded_depth_for(Dp, n_shards)} slices "
            f"(ventjax.dist.halo.padded_depth_for) or use calculate_ci_sharded, "
            f"which pads automatically"
        )
    dl = Dp // n_shards
    hz = halo_width(geom)
    if hz > dl:
        n_max = Dp // hz
        hint = (f"use at most {n_max} shards" if n_max >= 2 else
                "this volume is too thin to shard — run without "
                "--shard-slices")
        raise ValueError(
            f"halo width {hz} slices exceeds the {dl}-slice shard depth for "
            f"{n_shards} shards; {hint}, or use a smaller ci_rmax (the halo "
            f"is the sphere reach along the slice axis)"
        )
    M = geom.n_balls
    K = max_defect_per_shard
    HP = K // 2 if halo_pad is None else int(halo_pad)
    SENT = jnp.int32(SENTINEL)

    from ventjax.ops.basic import compact_mask_indices

    def body(defect_local):
        idx = jax.lax.axis_index(axis_name)
        n = jax.lax.axis_size(axis_name)
        d01 = defect_local != 0

        # centers: ONE compaction over the local slab ([H*W*dl] lanes).
        cidx, nc = compact_mask_indices(d01.reshape(-1), K)
        cvalid = jnp.arange(K) < nc
        vi = jnp.where(cvalid, (cidx // (W * dl)).astype(jnp.int32), SENT)
        vj = jnp.where(cvalid, ((cidx // dl) % W).astype(jnp.int32), -SENT)
        vkl = (cidx % dl).astype(jnp.int32)           # local slice index
        vk = jnp.where(cvalid, vkl + idx.astype(jnp.int32) * dl, SENT)

        if n_shards == 1:
            # Degenerate mesh: no neighbors, the slab is the volume.  Skip
            # the pack/ppermute/concat entirely so the engine scans K
            # witness lanes, not K + 2*HP of guaranteed-empty halo.
            wi, wj, wk = vi, vj, vk
            halo_ovf = jnp.bool_(False)
        else:
            # boundary defects as fixed [3, HP] coordinate buffers,
            # selected from the compacted lanes (cheap [K]-lane ops).
            # +1 encoding: edge devices receive zeros from ppermute, which
            # must decode as "no witnesses", not as voxel (0, 0, 0).
            def pack(sel):
                (lane,) = jnp.nonzero(sel, size=HP, fill_value=K)
                ok = lane < K
                lc = jnp.minimum(lane, K - 1)
                return jnp.stack([
                    jnp.where(ok, vi[lc] + 1, 0),
                    jnp.where(ok, vj[lc] + 1, 0),
                    jnp.where(ok, vk[lc] + 1, 0),
                ]), jnp.sum(sel)

            def unpack(msg):
                ok = msg[0] > 0
                return (jnp.where(ok, msg[0] - 1, SENT),
                        jnp.where(ok, msg[1] - 1, -SENT),
                        jnp.where(ok, msg[2] - 1, SENT))

            # halo below comes from the left neighbor's TOP boundary
            # defects, halo above from the right neighbor's BOTTOM ones.
            top_msg, n_top = pack(cvalid & (vkl >= dl - hz))
            bot_msg, n_bot = pack(cvalid & (vkl < hz))
            lo = unpack(jax.lax.ppermute(
                top_msg, axis_name, [(i, i + 1) for i in range(n - 1)]))
            hi = unpack(jax.lax.ppermute(
                bot_msg, axis_name, [(i + 1, i) for i in range(n - 1)]))

            # witnesses: local compaction + both halos, global coordinates.
            wi = jnp.concatenate([vi, lo[0], hi[0]])
            wj = jnp.concatenate([vj, lo[1], hi[1]])
            wk = jnp.concatenate([vk, lo[2], hi[2]])
            # A truncated buffer only loses witnesses someone RECEIVES:
            # the last shard's top buffer and shard 0's bottom buffer have
            # no ppermute destination, so their counts must not flag.
            halo_ovf = (((n_top > HP) & (idx < n - 1))
                        | ((n_bot > HP) & (idx > 0)))

        jballs, tail_ovf = resolve_balls_two_phase(
            (vi, vj, vk), (wi, wj, wk), geom,
            head_balls=head_balls, tail_k=tail_k, use_pallas=use_pallas,
            valid=cvalid, interpret=interpret,
        )
        saturated = (jballs >= M - 1) & cvalid
        cv = jnp.asarray(geom.radii32)[jballs] * geom.min_vox
        ci_flat = jnp.zeros(H * W * dl, jnp.float32)
        scatter_idx = jnp.where(cvalid, cidx, H * W * dl)
        ci_flat = ci_flat.at[scatter_idx].set(cv, mode="drop")
        overflow = (nc > K) | halo_ovf | tail_ovf
        return (
            ci_flat.reshape(H, W, dl),
            jax.lax.psum(jnp.sum(saturated), axis_name),
            jax.lax.psum(overflow.astype(jnp.int32), axis_name) > 0,
        )

    spec = P(None, None, axis_name)
    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(spec,),
        out_specs=(spec, P(), P()),
        check_vma=False,
    ))


# One compiled program per (geometry key, mesh devices, pads); the geometry
# builder is itself lru-cached on the same key, so identity matches.
_FN_CACHE: dict = {}


def calculate_ci_sharded(
    defect: jnp.ndarray,
    geom: CIPairwiseGeometry,
    mesh: Optional[Mesh] = None,
    axis_name: str = "space",
    n_shards: Optional[int] = None,
    max_defect_voxels: int = 8192,
    halo_pad: Optional[int] = None,
    head_balls: int = 128,
    tail_k: Optional[int] = None,
    use_pallas: Optional[bool] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Oversize-volume CI, slice-sharded over devices — the product surface.

    Same contract as ``calculate_ci_pairwise`` (bit-identical results,
    (ci_map, n_saturated, overflow) triple); the volume's slice axis is
    zero-padded to the mesh automatically.  ``max_defect_voxels`` is the
    per-shard center budget (a safe upper bound is the whole-volume defect
    count); ``halo_pad`` is the per-side boundary coordinate-buffer size
    (default K//2 — see ``make_sliced_ci_fn``).

    Raises ValueError with an actionable message when the geometry cannot
    shard (non-pairwise geometry, or more shards than the halo allows).
    """
    if not isinstance(geom, CIPairwiseGeometry):
        raise ValueError(
            "slice-sharded CI requires the pairwise engine, but this voxel "
            "geometry failed its float32 exactness proof and fell back to "
            "the gather-ladder engine (see pipeline.analyze.build_geometry). "
            "Run unsharded, or change vox/ci_rmax to a geometry the pairwise "
            "engine accepts."
        )
    H, W, D = geom.shape
    if defect.shape != (H, W, D):
        raise ValueError(f"defect shape {defect.shape} != geometry {geom.shape}")
    if mesh is None:
        devices = jax.devices()
        n = n_shards or len(devices)
        if n > len(devices):
            raise ValueError(
                f"--shard-slices {n} exceeds the {len(devices)} visible "
                f"device(s); use at most {len(devices)} shards"
            )
        mesh = Mesh(np.asarray(devices[:n]), (axis_name,))
    n = mesh.shape[axis_name]
    Dp = padded_depth_for(D, n)
    hpad = int(halo_pad) if halo_pad is not None else int(max_defect_voxels) // 2

    key = (geom.vox, geom.shape, geom.rmax, geom.border_mode,
           tuple(d.id for d in mesh.devices.flat), axis_name,
           int(max_defect_voxels), hpad, Dp,
           int(head_balls), tail_k if tail_k is None else int(tail_k),
           use_pallas, interpret)
    fn = _FN_CACHE.get(key)
    if fn is None:
        fn = make_sliced_ci_fn(
            geom, mesh, axis_name,
            max_defect_per_shard=int(max_defect_voxels),
            halo_pad=hpad, padded_depth=Dp,
            head_balls=int(head_balls), tail_k=tail_k,
            use_pallas=use_pallas, interpret=interpret,
        )
        _FN_CACHE[key] = fn
    padded = defect
    if Dp != D:
        padded = jnp.pad(defect, ((0, 0), (0, 0), (0, Dp - D)))
    ci, nsat, ovf = fn(padded)
    return ci[:, :, :D], nsat, ovf
