"""Pairwise-distance CI engine — the default CI engine (zero gathers).

Reformulation.  The defect mask is sparse (n_def voxels), so ball hit counts
are pairwise statements between defect voxels:

    hits_ball_j(v) = #{ defect w : offset (w - v) lies in ball_j }

and the reference's first-crossing rule "first ball whose defect fraction
drops below 0.5" (CI.py:94-105) becomes an order-statistics test:

    fail_j  <=>  cumcount_j < T_j,  T_j = (rows_j + 1) // 2 (static)
            <=>  (T_j-th smallest pair distance^2) > r_j^2

so per defect voxel the whole radius scan collapses to: one row of pairwise
squared distances, one sort, and a compare against a STATIC threshold vector
thr[t] = r^2 at the first ball whose T_j-1 == t.  No gathers, no LUT on
device — just broadcasted integer arithmetic, a [K,K] sort, and VPU compares.

Exactness (guarded at geometry-build time, tests in tests/test_ci.py):
- ball membership == (d^2 <= r_j^2) with shell = searchsorted(r^2, d^2):
  verified against the golden LUTs (the 4 float-boundary duplicate rows per
  LUT are second occurrences; min-shell semantics reproduces intersect1d
  uniqueness, and denominators keep the duplicate-inclusive row counts);
- float32 device arithmetic assigns every possible box offset to the same
  shell as the float64 oracle (checked exhaustively per geometry; build
  raises if a geometry ever violates it).

Border modes:
- "pad": natural offset only (geometrically correct zero padding).
- "wrap": the reference's linear-index aliasing.  delta(o) = o_i + o_j*H +
  o_k*H*W collides for exactly the offsets o = (di+p, dj+q, dk+s) with
  p + q*H + s*H*W = 0; with |o_i| <= 50 < H this has the nine closed-form
  solutions enumerated below, so aliased membership = min shell over nine
  candidate offsets — still pure vector math.

Auto-fail: balls needing T_j > n_def hits always fail; pairs beyond n_def
sort to +inf and trigger the same comparison, so padding is semantically
free.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


from ventjax.oracle.ci_oracle import shell_structure, sphere_pixels

# Far-away coordinate of padded (invalid) center and witness lanes: it
# fails every box check against a real voxel.
SENTINEL = 1 << 20
# Defect pad (K) from which auto mode runs the head phase in the
# block-skip kernel (ventjax.ops.ci_pallas) instead of the XLA head.
HEAD_KERNEL_MIN_K = 1024


@dataclasses.dataclass(frozen=True)
class CIPairwiseGeometry:
    vox: Tuple[float, float, float]
    rmax: int
    shape: Tuple[int, int, int]
    border_mode: str
    scale: Tuple[float, float, float]   # vox / min(vox), float32-exact
    radii32: np.ndarray                 # [M] float32 ball radii
    r2_32: np.ndarray                   # [M] float32 squared radii
    rows_ball: np.ndarray               # [M] int64 duplicate-inclusive rows
    r2_last: float                      # float32 largest shell r^2
    min_vox: float
    n_balls: int


@functools.lru_cache(maxsize=16)
def build_ci_pairwise_geometry(
    vox: Tuple[float, float, float],
    shape: Tuple[int, int, int],
    rmax: int = 50,
    border_mode: str = "wrap",
) -> CIPairwiseGeometry:
    vox = tuple(float(v) for v in vox)
    px = sphere_pixels(vox, rmax)
    radii, sizes, _ = shell_structure(px)
    rows_ball = np.cumsum(sizes).astype(np.int64)
    scale64 = np.asarray(vox) / np.min(vox)
    scale32 = scale64.astype(np.float32)
    r2_64 = radii ** 2
    r2_32 = r2_64.astype(np.float32)

    # --- Exactness guards (host, one-time per geometry) -------------------
    # (a) LUT row shells equal searchsorted(r^2, d^2) except second
    #     occurrences of float-boundary duplicate offsets.
    shell_of_row = np.repeat(np.arange(len(radii)), sizes)
    d2row = ((px[:, 1] * scale64[0]) ** 2 + (px[:, 2] * scale64[1]) ** 2
             + (px[:, 3] * scale64[2]) ** 2)
    pred = np.searchsorted(r2_64, d2row, side="left")
    off = px[:, 1:].astype(np.int64)
    key = ((off[:, 0] + rmax) * (2 * rmax + 1) + (off[:, 1] + rmax)) \
        * (2 * rmax + 1) + (off[:, 2] + rmax)
    _, first_idx = np.unique(key, return_index=True)
    is_first = np.zeros(len(key), bool)
    is_first[first_idx] = True
    if not np.array_equal(pred[is_first], shell_of_row[is_first]):
        raise ValueError(
            "CI pairwise engine: ball membership != d^2<=r^2 for this "
            "geometry; use the gather-ladder engine instead."
        )
    # (b) float32 device arithmetic is bin-exact over every box offset.
    rng = np.arange(-rmax, rmax + 1)
    X, Y, Z = np.meshgrid(rng, rng, rng, indexing="ij")
    d2_64 = ((X * scale64[0]) ** 2 + (Y * scale64[1]) ** 2
             + (Z * scale64[2]) ** 2).ravel()
    dx = X.astype(np.float32) * scale32[0]
    dy = Y.astype(np.float32) * scale32[1]
    dz = Z.astype(np.float32) * scale32[2]
    d2f = (dx * dx + dy * dy + dz * dz).ravel().astype(np.float64)
    if not np.array_equal(
        np.searchsorted(r2_64, d2_64, side="left"),
        np.searchsorted(r2_32.astype(np.float64), d2f, side="left"),
    ):
        raise ValueError(
            "CI pairwise engine: float32 distance binning is not exact for "
            "this geometry; use the gather-ladder engine instead."
        )

    return CIPairwiseGeometry(
        vox=vox,
        rmax=int(rmax),
        shape=tuple(int(s) for s in shape),
        border_mode=border_mode,
        scale=tuple(float(s) for s in scale32),
        radii32=radii.astype(np.float32),
        r2_32=r2_32,
        rows_ball=rows_ball,
        r2_last=float(r2_32[-1]),
        min_vox=float(np.min(np.asarray(vox))),
        n_balls=int(len(radii)),
    )


def _alias_combos(geom: CIPairwiseGeometry):
    """(p, q, s) with p + q*H + s*H*W = 0 and |p| <= H (CI.py:65-68 map)."""
    H, W, _ = geom.shape
    if geom.border_mode == "pad":
        return [(0, 0, 0)]
    return [
        (0, 0, 0),
        (0, W, -1), (0, -W, 1),
        (H, -1, 0), (H, W - 1, -1), (H, -W - 1, 1),
        (-H, 1, 0), (-H, 1 - W, 1), (-H, 1 + W, -1),
    ]


def _threshold_tables(geom: CIPairwiseGeometry, K: int):
    """Static (thr[t], j_lo[t], j_cap) for the order-statistics test."""
    M = geom.n_balls
    T = (geom.rows_ball + 1) // 2          # fail_j <=> cumcount_j < T_j
    tested = np.arange(M - 1)              # last ball never tested
    t_idx = T[tested] - 1                  # sorted position probed by ball j
    thr = np.full(K, np.inf, np.float32)
    j_lo = np.full(K, M - 1, np.int32)
    # first (smallest) ball for each probed position
    for j in tested[::-1]:
        t = t_idx[j]
        if t < K:
            thr[t] = geom.r2_32[j]
            j_lo[t] = j
    over = tested[T[tested] > K]
    j_cap = int(over[0]) if len(over) else M - 1
    return jnp.asarray(thr), jnp.asarray(j_lo), j_cap


def _alias_min_d2(vc, witnesses, geom: CIPairwiseGeometry) -> jnp.ndarray:
    """[centers, witnesses] min-over-alias squared distances (inf = no LUT
    offset relates the pair)."""
    vi, vj, vk = vc
    wi, wj, wk = witnesses
    s0, s1, s2 = geom.scale
    inf = jnp.float32(jnp.inf)
    dmin2 = jnp.full((vi.shape[0], wi.shape[0]), inf)
    for (p, q, s) in _alias_combos(geom):
        oi = (wi[None, :] - vi[:, None]) + p
        oj = (wj[None, :] - vj[:, None]) + q
        ok_ = (wk[None, :] - vk[:, None]) + s
        inbox = (
            (jnp.abs(oi) <= geom.rmax)
            & (jnp.abs(oj) <= geom.rmax)
            & (jnp.abs(ok_) <= geom.rmax)
        )
        fx = oi.astype(jnp.float32) * s0
        fy = oj.astype(jnp.float32) * s1
        fz = ok_.astype(jnp.float32) * s2
        d2 = fx * fx + fy * fy + fz * fz
        hit = inbox & (d2 <= geom.r2_last)
        dmin2 = jnp.minimum(dmin2, jnp.where(hit, d2, inf))
    return dmin2


def ci_pairwise_balls(
    centers: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    witnesses: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    geom: CIPairwiseGeometry,
    row_chunk: int = 1024,
) -> jnp.ndarray:
    """First-failing-ball index per center voxel (M-1 sentinel = saturated),
    by full order statistics (row sort vs static thresholds).

    centers/witnesses are padded int32 coordinate triples; padded slots use
    far-away sentinel coordinates (|coord| huge) so they miss every box
    check.  Separating the two sets enables slice-sharded (halo-exchange)
    execution: centers = local shard, witnesses = shard + halo.
    """
    vi_all, vj_all, vk_all = centers
    wi, wj, wk = witnesses
    K = vi_all.shape[0]
    nw = wi.shape[0]
    M = geom.n_balls
    thr, j_lo, j_cap = _threshold_tables(geom, nw)

    def row_block(vc):
        dmin2 = _alias_min_d2(vc, (wi, wj, wk), geom)
        srt = jnp.sort(dmin2, axis=1)
        failing = srt > thr[None, :]
        any_f = jnp.any(failing, axis=1)
        tstar = jnp.argmax(failing, axis=1)
        j = jnp.where(any_f, j_lo[tstar], M - 1)
        return jnp.minimum(j, j_cap)

    n_chunks = -(-K // row_chunk)
    kpad = n_chunks * row_chunk
    # Chunk-pad rows get sentinel coordinates so they resolve in stage 1
    # (zero counts -> immediate fail) and never trigger the sort fallback.
    pad = lambda x: jnp.full((kpad,), SENTINEL, x.dtype).at[:K].set(x)
    return jax.lax.map(
        row_block,
        (
            pad(vi_all).reshape(n_chunks, row_chunk),
            pad(vj_all).reshape(n_chunks, row_chunk),
            pad(vk_all).reshape(n_chunks, row_chunk),
        ),
    ).reshape(-1)[:K]


def resolve_balls_two_phase(
    centers: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    witnesses: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    geom: CIPairwiseGeometry,
    *,
    head_balls: int = 128,
    tail_k: Optional[int] = None,
    row_chunk: int = 1024,
    use_pallas: Optional[bool] = None,
    valid: Optional[jnp.ndarray] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """First-failing-ball index per center via the two-phase engine.

    Bit-equal to ``ci_pairwise_balls(centers, witnesses, geom)`` on valid
    rows at a fraction of its sort cost: phase A checks the first
    `head_balls` balls by direct compare-reduce counts (fused XLA blocks,
    or the block-skip kernel of ``ventjax.ops.ci_pallas``); rows with no
    head crossing are compacted to `tail_k` lanes and finished by the full
    order-statistics sort.  Shared by the unsharded engine
    (`calculate_ci_pairwise`, where witnesses == centers) and the
    slice-sharded halo engine (`ventjax.dist.halo`, where witnesses =
    shard + halo slabs).

    centers/witnesses are sentinel-padded int32 coordinate triples.
    Sentinel centers sit at zero distance from sentinel WITNESSES (both
    pads use the same far-away coordinates), so padded rows never cross in
    the head and land in the tail — harmless for values (they saturate and
    the caller masks them), but they must not count toward tail overflow:
    pass ``valid`` (the real-row mask) so overflow counts real rows only.
    Compaction emits valid rows first, and the stable tail compaction
    keeps that order, so valid unresolved rows always win tail lanes over
    padding.

    use_pallas: None picks the head kernel on a GPU backend once K
    reaches HEAD_KERNEL_MIN_K; True/False force it or the XLA head.
    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests).

    Returns ``(jballs [K] int32, tail_overflow bool)``; overflowed rows
    keep the M-1 saturation sentinel (never silently wrong).
    """
    ii, jj, kk = centers
    wi, wj, wk = witnesses
    K = ii.shape[0]
    M = geom.n_balls

    ns = min(int(head_balls), M - 1)
    if use_pallas is None:
        use_pallas = (jax.default_backend() == "gpu"
                      and K >= HEAD_KERNEL_MIN_K)

    if use_pallas:
        from ventjax.ops.ci_pallas import head_first_fail_pallas

        first = head_first_fail_pallas(
            ii, jj, kk, wi, wj, wk,
            combos=tuple(_alias_combos(geom)),
            scale=geom.scale,
            r2=tuple(float(r) for r in geom.r2_32[:ns]),
            t_head=tuple(int(t) for t in ((geom.rows_ball + 1) // 2)[:ns]),
            rmax=geom.rmax,
            interpret=interpret,
        )
        resolved = first < ns
        j_head = first
    else:
        r2 = jnp.asarray(geom.r2_32)
        t_head = jnp.asarray(
            ((geom.rows_ball + 1) // 2)[:ns].astype(np.float32))

        def head_block(vc):
            dmin2 = _alias_min_d2(vc, (wi, wj, wk), geom)
            fails = []
            # 32-cutoff blocks keep each compare-reduce inside XLA's fusion
            # budget (wider blocks materialize the [rows, nw, cuts] tensor).
            for a in range(0, ns, 32):
                b = min(a + 32, ns)
                counts = jnp.sum(
                    (dmin2[:, :, None] <= r2[a:b][None, None, :]).astype(
                        jnp.float32),
                    axis=1,
                )
                fails.append(counts < t_head[a:b][None, :])
            fail_head = jnp.concatenate(fails, axis=1)
            return jnp.any(fail_head, axis=1), jnp.argmax(fail_head, axis=1)

        n_chunks = -(-K // row_chunk)
        kpad = n_chunks * row_chunk
        pad = lambda x: jnp.full((kpad,), SENTINEL, x.dtype).at[:K].set(x)
        resolved, j_head = jax.lax.map(
            head_block,
            (
                pad(ii).reshape(n_chunks, row_chunk),
                pad(jj).reshape(n_chunks, row_chunk),
                pad(kk).reshape(n_chunks, row_chunk),
            ),
        )
        resolved = resolved.reshape(-1)[:K]
        j_head = j_head.reshape(-1)[:K].astype(jnp.int32)
    jballs = jnp.where(resolved, j_head, M - 1)

    # Phase B: compact unresolved rows (stable sort: unresolved first).
    SENT = jnp.int32(SENTINEL)
    K2 = int(tail_k) if tail_k is not None else max(256, K // 8)
    K2 = min(K2, K)
    sel = jnp.argsort(resolved, stable=True)[:K2]
    live = ~resolved[sel]
    tail_coords = tuple(
        jnp.where(live, c[sel], SENT) for c in (ii, jj, kk)
    )
    j_tail = ci_pairwise_balls(
        tail_coords, (wi, wj, wk), geom, row_chunk=min(K2, 512)
    )
    jballs = jballs.at[sel].set(jnp.where(live, j_tail, jballs[sel]))
    unresolved = ~resolved if valid is None else (~resolved & valid)
    tail_overflow = jnp.sum(unresolved) > K2
    return jballs, tail_overflow


def calculate_ci_pairwise(
    defect: jnp.ndarray,
    geom: CIPairwiseGeometry,
    max_defect_voxels: int = 8192,
    row_chunk: int = 1024,
    head_balls: int = 128,
    tail_k: Optional[int] = None,
    use_pallas: Optional[bool] = None,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """CI map via the pairwise engine; returns (ci_map, n_saturated, overflow).

    Two exact phases.  Phase A checks the first `head_balls` balls directly
    (fail_j <=> count(d^2 <= r_j^2) < T_j) — no sort; ball 96 already
    corresponds to CI ~17mm, past the crossing of essentially every real
    defect voxel, and the default 128 keeps the tail of clustered severe
    loads (~3.5k defects at K=4096) inside its budget.  Rows with no head
    crossing are compacted to `tail_k` lanes and finished by the full
    order-statistics engine.  Compaction overflow is reported in the
    overflow flag (excess rows saturate — never silently wrong).

    use_pallas / interpret: the head phase's kernel choice, as in
    ``resolve_balls_two_phase``.
    """
    H, W, D = geom.shape
    K = max_defect_voxels
    M = geom.n_balls
    d01 = defect != 0

    from ventjax.ops.basic import compact_mask_indices

    flat_c = d01.reshape(-1)
    cidx, n_def = compact_mask_indices(flat_c, K)
    valid = jnp.arange(K) < n_def
    SENT = jnp.int32(SENTINEL)
    ii = jnp.where(valid, (cidx // (W * D)).astype(jnp.int32), SENT)
    jj = jnp.where(valid, ((cidx // D) % W).astype(jnp.int32), -SENT)
    kk = jnp.where(valid, (cidx % D).astype(jnp.int32), SENT)

    jballs, tail_overflow = resolve_balls_two_phase(
        (ii, jj, kk), (ii, jj, kk), geom,
        head_balls=head_balls, tail_k=tail_k,
        row_chunk=row_chunk, use_pallas=use_pallas, valid=valid,
        interpret=interpret,
    )

    saturated = (jballs >= M - 1) & valid
    cv = jnp.asarray(geom.radii32)[jballs] * geom.min_vox

    V = H * W * D
    with jax.named_scope("ci_densify"):
        scatter_idx = jnp.where(valid, cidx, V)
        ci_flat = jnp.zeros(V, jnp.float32).at[scatter_idx].set(
            cv, mode="drop")
    return (
        ci_flat.reshape(H, W, D),
        jnp.sum(saturated),
        (n_def > K) | tail_overflow,
    )
