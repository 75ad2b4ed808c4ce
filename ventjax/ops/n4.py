"""N4 bias-field correction as a jit-compiled JAX op.

Same algorithm and parameters as ventjax.oracle.n4_oracle (from-scratch N4,
ITK defaults; the reference reaches it through SimpleITK C++ at
Vent_Analysis.py:316-334).

Device mapping (three ideas):
1. Only masked voxels participate in every iteration (histogram, sharpening,
   residual, and the B-spline fit's nonzero contributions), and the mask is
   iteration-invariant — so the loop runs on a *compacted* padded vector of
   masked voxels (~2-10% of the volume) with per-voxel analytic B-spline
   basis rows; the full-grid field is reconstructed once at the end.
2. The fractional histogram and expectation-table lookup are one-hot
   contractions (linear interpolation touches two bins), i.e. small matmuls
   instead of scatters and gathers.
3. The Lee-BA fit is separable basis contractions — small matmuls; the
   per-level lattice accumulates so the final field is one dense evaluation.

Precision: every float32 dot that is not an explicit bf16-operand product
runs at _F32_DOT, because a default-precision float32 dot may run in TF32
(about three decimal digits) on the GPU.

Iteration runs under an early-stopping while_loop with convergence-frozen
updates, matching the oracle's breaking loop exactly.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ventjax.oracle.n4_oracle import _next_pow2_padded, bspline_basis_1d

LOG2 = float(np.log(2.0))
# Full float32 for the sharpening transforms, the one-hot histogram and
# expectation dots, the fit's normalizer and the final field.  They are
# small next to the bf16 fit products; in TF32 the one-hot dots would round
# the expectation table itself to ~1e-3.
_F32_DOT = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=4)
def _dft_mats_np(padded: int):
    """Cos/sin DFT matrices: the 512-pt transforms as dense matmuls.

    The histogram-sharpening chain needs ~6 length-`padded` real transforms
    per iteration; as matmuls they batch over the vmapped lanes and stay
    real-valued inside the while_loop body.
    """
    n = np.arange(padded)
    ang = 2.0 * np.pi / padded * np.outer(n, n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _sharpen_expectation(hist, binmin, slope, bins, fwhm, wiener_noise,
                         padded, offset):
    """(bins+2)-entry local expectation slice from the fractional histogram.

    The Wiener-deconvolution sharpening core of ITK's N4 (tests pin the
    full op against the float64 oracle): Gaussian-blur kernel in the
    padded-DFT domain, deconvolve the histogram, take the conditional
    expectation E[u|v], and slice the entries reachable by masked voxels
    (t+1 in [1, bins] -> slots offset-1 .. offset+bins of the padded
    axis).  All transforms are the 512-pt DFT-as-matmul (_dft_mats_np).
    """
    dtype = hist.dtype
    hiprec = _F32_DOT
    cosm, sinm = _dft_mats_np(padded)
    Fc = jnp.asarray(cosm, dtype)
    Fs = jnp.asarray(sinm, dtype)
    dot = lambda x, M: jnp.einsum("i,ij->j", x, M, precision=hiprec)
    fwd = lambda x: (dot(x, Fc), -dot(x, Fs))            # FFT of a real vector
    inv_real = lambda xr, xi: (dot(xr, Fc) - dot(xi, Fs)) / padded

    v = jnp.zeros(padded, dtype).at[offset:offset + bins].set(hist)
    vr, vi = fwd(v)

    scaled_fwhm = fwhm / slope
    exp_factor = 4.0 * LOG2 / scaled_fwhm ** 2
    scale_factor = 2.0 * jnp.sqrt(LOG2 / jnp.pi) / scaled_fwhm
    n = jnp.arange(padded)
    half = jnp.minimum(n, padded - n).astype(dtype)
    fkernel = scale_factor * jnp.exp(-(half ** 2) * exp_factor)
    fr, fi = fwd(fkernel)

    # Wiener deconvolution gf = conj(ff) / (|ff|^2 + noise).
    gdenom = fr * fr + fi * fi + wiener_noise
    gr = fr / gdenom
    gi = -fi / gdenom
    u = jnp.maximum(inv_real(vr * gr - vi * gi, vr * gi + vi * gr), 0.0)

    bin_u = binmin + (n.astype(dtype) - offset) * slope
    yr, yi = fwd(u * bin_u)
    num = inv_real(yr * fr - yi * fi, yr * fi + yi * fr)
    ur, ui = fwd(u)
    den = inv_real(ur * fr - ui * fi, ur * fi + ui * fr)
    expectation = jnp.where(
        den != 0.0, num / jnp.where(den != 0.0, den, 1.0), 0.0
    )
    return jax.lax.dynamic_slice(expectation, (offset - 1,), (bins + 2,))


def _sharpen_vec(logu, wv, bins, fwhm, wiener_noise, padded, offset):
    """Histogram-sharpen a padded masked-value vector (weights wv in {0,1}).

    Same math as the dense triangular-kernel version (and the float64 oracle,
    ventjax.oracle.n4_oracle.sharpen_log_intensities), restructured as
    matmuls: the fractional histogram's triangle weights relu(1-|t-b|)
    touch only bins floor(t) and floor(t)+1, so splitting the bin index into
    (hi, lo) = divmod(b, 16) turns both the histogram build and the
    expectation interpolation into tiny one-hot matmuls — [G,P]@[P,16] and
    [P,G]@[G,16] — instead of [P,bins] dense broadcasting (which at
    bins=200 is ~10x the elementwise work and materializes in memory).
    """
    dtype = logu.dtype
    hiprec = _F32_DOT
    binmin = jnp.min(jnp.where(wv > 0, logu, jnp.inf))
    binmax = jnp.max(jnp.where(wv > 0, logu, -jnp.inf))
    slope = (binmax - binmin) / (bins - 1)

    t = jnp.clip((logu - binmin) / slope, 0.0, float(bins - 1)) * wv

    GL = 16                          # lo-group width
    NG = -(-(bins + 2) // GL)        # hi groups (covers bins+1 interp slots)
    g_ids = jnp.arange(NG, dtype=jnp.int32)
    l_ids = jnp.arange(GL, dtype=jnp.int32)

    def onehots(idx):
        A = ((idx // GL)[:, None] == g_ids[None, :]).astype(dtype)
        C = ((idx % GL)[:, None] == l_ids[None, :]).astype(dtype)
        return A, C

    # hist[b] = sum_v wv * relu(1 - |t_v - b|): exactly (1-f) at floor(t)
    # plus f at floor(t)+1 (f = frac(t); the f=0 edge contributes only once).
    i0 = jnp.floor(t)
    f = t - i0
    i0 = i0.astype(jnp.int32)
    A0, C0 = onehots(i0)
    A1, C1 = onehots(i0 + 1)
    w0 = wv * (1.0 - f)
    w1 = wv * f
    h2d = (
        jnp.einsum("pg,pl->gl", A0 * w0[:, None], C0, precision=hiprec)
        + jnp.einsum("pg,pl->gl", A1 * w1[:, None], C1, precision=hiprec)
    )
    hist = h2d.reshape(NG * GL)[:bins]
    e_loc = _sharpen_expectation(
        hist, binmin, slope, bins, fwhm, wiener_noise, padded, offset
    )
    # linear interp of E at t+offset: same one-hot split over the
    # (bins+2)-entry slice of E that masked positions can touch.
    E2d = jnp.zeros(NG * GL, dtype).at[:bins + 2].set(e_loc).reshape(NG, GL)
    s = t + 1.0
    j0 = jnp.floor(s)
    fs = s - j0
    j0 = j0.astype(jnp.int32)
    A0s, C0s = onehots(j0)
    A1s, C1s = onehots(j0 + 1)
    v0 = jnp.sum(
        jnp.einsum("pg,gl->pl", A0s, E2d, precision=hiprec) * C0s, axis=1
    )
    v1 = jnp.sum(
        jnp.einsum("pg,gl->pl", A1s, E2d, precision=hiprec) * C1s, axis=1
    )
    return ((1.0 - fs) * v0 + fs * v1) * wv


def _bspline_rows(coords, n, n_elements, dtype):
    """[P, ncp] cubic B-spline basis rows at integer grid coords.

    Analytic cardinal form — basis[h, c] = B(t_h - c + 1) with B the
    cardinal cubic B-spline — instead of gathering rows from the
    bspline_basis_1d table (no per-voxel gather).  Identical to the table,
    including the end clamp: at t = n_elements the clamped (span=ne-1,
    u=1) and unclamped (span=ne, u=0) parameterizations place the same
    weights on the same columns, which is exactly what the continuous
    cardinal form evaluates.
    """
    ncp = n_elements + 3
    t = coords.astype(dtype) * (float(n_elements) / float(max(n - 1, 1)))
    x = jnp.abs(t[:, None] - jnp.arange(ncp, dtype=dtype)[None, :] + 1.0)
    near = (4.0 - 6.0 * x * x + 3.0 * x ** 3) / 6.0
    far = (2.0 - x) ** 3 / 6.0
    return jnp.where(x < 1.0, near, jnp.where(x < 2.0, far, 0.0))


@functools.partial(
    jax.jit,
    static_argnames=(
        "fitting_levels", "max_iters", "bins", "control_points",
        "mask_pad", "return_field", "return_overflow", "return_compacted",
        "return_iters", "return_phi",
    ),
)
def n4_bias_correction(
    image: jnp.ndarray,
    mask: jnp.ndarray,
    fitting_levels: int = 4,
    max_iters: int = 50,
    convergence_threshold: float = 0.001,
    bins: int = 200,
    fwhm: float = 0.15,
    wiener_noise: float = 0.01,
    control_points: int = 4,
    mask_pad: Optional[int] = None,
    return_field: bool = False,
    return_overflow: bool = False,
    return_iters: bool = False,
    return_phi: bool = False,
    return_compacted: bool = False,
    compacted=None,
):
    """N4-corrected image.  mask_pad statically bounds the masked voxel
    count (default: the full volume — always safe); if the mask exceeds it,
    excess voxels are ignored and the overflow flag (return_overflow) is set.

    `compacted` optionally supplies (idx, raw_vals, n_mask) from
    ventjax.ops.basic.sort_compact_masked over the PLAIN mask (mask > 0) of
    the flat image — the pipeline computes it once and shares it here and
    with k-means.  The img > 0 sub-condition is applied through the weight
    vector, so results equal the self-compacted path (all reductions are
    weighted).  `return_compacted` appends (idx, corrected_vals, wv01) —
    the compacted N4 output k-means consumes without its own sort.
    """
    H, W, D = image.shape
    V = H * W * D
    P = V if mask_pad is None else min(int(mask_pad), V)
    dtype = jnp.promote_types(image.dtype, jnp.float32)
    img = image.astype(dtype)

    from ventjax.ops.basic import sort_compact_masked

    if compacted is None:
        m = (mask > 0) & (img > 0)
        idx, raw_vals, n_mask = sort_compact_masked(
            img.reshape(-1), m.reshape(-1), P
        )
        wv = (jnp.arange(P) < n_mask).astype(dtype)
    else:
        idx, raw_vals, n_mask = compacted
        raw_vals = raw_vals.astype(dtype)
        wv = ((jnp.arange(P) < n_mask) & (raw_vals > 0)).astype(dtype)
    overflow = n_mask > P

    vals = jnp.maximum(raw_vals, 1.0e-30)
    logv = jnp.log(jnp.where(wv > 0, vals, 1.0)) * wv
    hc = (idx // (W * D)).astype(jnp.int32)
    wc = ((idx // D) % W).astype(jnp.int32)
    sc = (idx % D).astype(jnp.int32)

    padded = _next_pow2_padded(bins)
    offset = (padded - bins) // 2

    field_v = jnp.zeros(P, dtype)
    phi_totals = []
    level_iters = []
    for level in range(fitting_levels):
        n_elements = (control_points - 3) * 2 ** level
        ncp = n_elements + 3
        # Per-voxel basis rows / normalizers (computed analytically — no
        # table gathers).
        brv = _bspline_rows(hc, H, n_elements, dtype)
        bcv = _bspline_rows(wc, W, n_elements, dtype)
        bsv = _bspline_rows(sc, D, n_elements, dtype)
        sv = ((brv ** 2).sum(1) * (bcv ** 2).sum(1) * (bsv ** 2).sum(1))
        # Fit operands: iteration-invariant outer products
        # BO^k[p, d*ncp+e] = bcv^k[p,d] * bsv^k[p,e]; the 3-way point
        # contraction num[c,d,e] = sum_p a_p br^3_p[c] bc^3_p[d] bs^3_p[e]
        # collapses to the skinny matmul (a*brv^3)^T @ BO3.  The
        # per-iteration operands live in bf16 with f32 accumulation: at
        # [P, ncp^2] they are the dominant memory traffic of every
        # iteration.  Basis values are in [0,1], so bf16 quantization
        # perturbs the *smooth fitted field* at ~1e-3 relative — inside
        # the |dVDP| budget (validated against the float64 oracle in
        # tests/test_n4.py).
        bo = (bcv[:, :, None] * bsv[:, None, :]).reshape(P, ncp * ncp)
        bo3 = (bcv[:, :, None] ** 3 * bsv[:, None, :] ** 3).reshape(
            P, ncp * ncp)
        bo2 = (bcv[:, :, None] ** 2 * bsv[:, None, :] ** 2).reshape(
            P, ncp * ncp)
        den = jnp.einsum(
            "pc,pf->cf", wv[:, None] * brv ** 2, bo2, precision=_F32_DOT
        )

        @jax.named_scope(f"n4_fit_ncp{ncp}")
        def fit_phase(a_v, den=den, brv=brv, brv3=brv ** 3,
                      bo=bo.astype(jnp.bfloat16),
                      bo3=bo3.astype(jnp.bfloat16)):
            num = jnp.einsum(
                "pc,pf->cf",
                (a_v[:, None] * brv3).astype(jnp.bfloat16), bo3,
                preferred_element_type=jnp.float32,
            )
            phi = jnp.where(
                den != 0.0, num / jnp.where(den != 0.0, den, 1.0), 0.0
            )
            # delta_p = sum_c brv[p,c] * (BO @ phi[c,:]^T)[p,c]
            g = jnp.einsum(
                "pf,cf->pc", bo, phi.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32,
            )
            return phi, jnp.sum(brv * g, axis=1)

        def body(carry, fit_phase=fit_phase, sv=sv):
            i, field_v, phi_total, done, itc = carry
            logu = (logv - field_v) * wv
            sharpened = _sharpen_vec(
                logu, wv, bins, fwhm, wiener_noise, padded, offset)
            residual = (logu - sharpened) * wv
            # flush sub-normals (CPU denormal emulation is ~100x slower)
            residual = jnp.where(jnp.abs(residual) < 1e-18, 0.0, residual)
            a_v = residual / jnp.maximum(sv, 1e-30)

            # ITK's convergence measurement: CV of exp(old - new) =
            # exp(-delta) over the mask
            # (itkN4BiasFieldCorrectionImageFilter.hxx).
            nmask = jnp.sum(wv)
            phi, raw = fit_phase(a_v)
            delta = jnp.where(jnp.abs(raw) < 1e-18, 0.0, raw) * wv
            ed = jnp.exp(-delta)
            mu = jnp.sum(ed * wv) / nmask
            sd = jnp.sqrt(jnp.sum(wv * (ed - mu) ** 2) / nmask)
            cv = sd / mu

            new_field = jnp.where(done, field_v, field_v + delta)
            new_phi = jnp.where(done, phi_total, phi_total + phi)
            new_done = done | (cv < convergence_threshold)
            itc = itc + (~done).astype(jnp.int32)
            return i + 1, new_field, new_phi, new_done, itc

        _, field_v, phi_total, _, itc = jax.lax.while_loop(
            lambda c: (c[0] < max_iters) & ~c[3],
            body,
            (jnp.asarray(0), field_v, jnp.zeros((ncp, ncp * ncp), dtype),
             jnp.asarray(False), jnp.asarray(0)),
        )
        level_iters.append(itc)
        phi_totals.append((level, phi_total))

    # Full-grid field: one dense separable evaluation per level (cheap, once).
    total_field = jnp.zeros((H, W, D), dtype)
    for level, phi_total in phi_totals:
        n_elements = (control_points - 3) * 2 ** level
        br = jnp.asarray(bspline_basis_1d(H, n_elements), dtype)
        bc = jnp.asarray(bspline_basis_1d(W, n_elements), dtype)
        bs = jnp.asarray(bspline_basis_1d(D, n_elements), dtype)
        ncp = br.shape[1]
        total_field = total_field + jnp.einsum(
            "hc,wd,se,cde->hws", br, bc, bs,
            phi_total.reshape(ncp, ncp, ncp),
            precision=_F32_DOT,
        )

    corrected = img * jnp.exp(-total_field)
    out = (corrected,)
    if return_field:
        out = out + (total_field,)
    if return_overflow:
        out = out + (overflow,)
    if return_iters:
        # Diagnostic: per-level count of iterations this call was still
        # unconverged (per-lane under vmap — quantifies lock-step waste).
        out = out + (jnp.stack(level_iters),)
    if return_phi:
        # The complete fitted model, flat: the per-level control lattices
        # concatenated in level order (sizes = n4_phi_sizes).  ~1.9k floats
        # at the defaults — the whole dense bias field compressed to the
        # coefficients that generate it.  n4_field_from_phi_np rebuilds the
        # dense field host-side (the cohort export's compact-N4 transfer).
        out = out + (jnp.concatenate(
            [p.reshape(-1).astype(dtype) for _, p in phi_totals]),)
    if return_compacted:
        # Compacted corrected values at the iteration's own field estimate
        # (field_v; bf16-accumulated, ~1e-4 relative of the dense field) —
        # k-means consumes these without re-sorting; its loose tolerances
        # (centers are means over ~50k voxels) absorb the eps.
        corrected_vals = raw_vals * jnp.exp(-field_v)
        wv_mask_only = (jnp.arange(P) < n_mask).astype(dtype)
        out = out + ((idx, corrected_vals, wv_mask_only),)
    return out if len(out) > 1 else out[0]


def n4_phi_sizes(fitting_levels: int = 4, control_points: int = 4):
    """Per-level flat lattice sizes of the return_phi vector."""
    return [((control_points - 3) * 2 ** level + 3) ** 3
            for level in range(fitting_levels)]


def n4_field_from_phi_np(
    phi_flat: np.ndarray,
    shape,
    fitting_levels: int = 4,
    control_points: int = 4,
) -> np.ndarray:
    """Host (numpy, float64) dense log-bias field from the return_phi vector.

    Mirrors the device's final dense evaluation (the per-level separable
    einsum above) but in float64 numpy, so `hp * exp(-field)` reconstructs
    the corrected volume from host-known inputs plus the ~1.9k-float
    lattice vector.  NOT bit-identical to the device's float32
    einsum — agreement is ~1e-6 relative (pinned by
    tests/test_pipeline.py) — which is why the cohort export overwrites
    every masked voxel with device-exact shipped values and uses this only
    for the out-of-mask background, where no metric is ever computed.
    """
    H, W, D = shape
    field = np.zeros((H, W, D), np.float64)
    off = 0
    for level in range(fitting_levels):
        n_elements = (control_points - 3) * 2 ** level
        ncp = n_elements + 3
        k = ncp ** 3
        phi = np.asarray(phi_flat[off:off + k], np.float64).reshape(
            ncp, ncp, ncp)
        off += k
        br = bspline_basis_1d(H, n_elements)
        bc = bspline_basis_1d(W, n_elements)
        bs = bspline_basis_1d(D, n_elements)
        # Separable: contract one axis at a time (never materialize the
        # [H,W,D,ncp^3] broadcast np.einsum would otherwise build).
        t = np.tensordot(br, phi, axes=(1, 0))      # [H, ncp, ncp]
        t = np.tensordot(bc, t, axes=(1, 1))        # [W, H, ncp]
        field += np.tensordot(t, bs, axes=(2, 1)).transpose(1, 0, 2)
    if off != len(phi_flat):
        raise ValueError(
            f"phi vector has {len(phi_flat)} coefficients; levels="
            f"{fitting_levels} control_points={control_points} expects {off}")
    return field
