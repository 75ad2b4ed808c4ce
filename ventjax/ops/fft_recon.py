"""K-space reconstruction for raw (TWIX) data.

Device equivalent of the reference's per-slice loop
(Vent_Analysis.py:537-540): fftshift(fft2(fftshift(k))) per slice, then
transpose (1,0,2) and flip the column axis.  Batched over slices in one
jitted program instead of a Python loop.

Formulation: the centered 2-D DFT is expressed as two dense matmuls per
axis on split real/imaginary planes — `M_H @ X @ M_W^T` with
`M = fftshift . F . fftshift` baked into one matrix per axis — so the
recon is real-valued matmuls (at vent-image sizes an N^2 matmul DFT is
bandwidth-trivial).  Matmuls run at precision=HIGHEST: a default-precision
float32 matmul may run in TF32 on the GPU (about three decimal digits),
which is visible at DFT accuracy scales.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_P = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=16)
def _centered_dft_mats(n: int):
    """Real/imag parts of the combined fftshift.DFT.fftshift matrix.

    Built by applying the exact transform to the identity in float64 on
    host (the transform is linear, so T(I) IS its matrix), then cast to
    f32 for the device matmuls.

    Returns HOST numpy arrays, never device arrays: a jnp constant
    created during one jit trace and memoized here would leak that
    trace's tracer into the next retrace that shares a dimension
    (caught by benchmarks/recon_chip_fidelity.py).  numpy constants
    embed freshly into every trace.
    """
    eye = np.eye(n)
    m = np.fft.fftshift(np.fft.fft(np.fft.fftshift(eye, axes=0), axis=0),
                        axes=0)
    return (m.real.astype(np.float32), m.imag.astype(np.float32))


@functools.partial(jax.jit, static_argnums=())
def _recon_planes(re: jnp.ndarray, im: jnp.ndarray):
    """[H, W, S] real k-space planes -> (re, im) image planes in the
    reference's orientation (transpose + column flip)."""
    h, w = re.shape[0], re.shape[1]
    ch, sh = _centered_dft_mats(h)
    cw, sw = _centered_dft_mats(w)

    def rows(a, b):  # M_H @ (a + ib) along axis 0
        return (jnp.einsum("hk,kws->hws", ch, a, precision=_P)
                - jnp.einsum("hk,kws->hws", sh, b, precision=_P),
                jnp.einsum("hk,kws->hws", ch, b, precision=_P)
                + jnp.einsum("hk,kws->hws", sh, a, precision=_P))

    def cols(a, b):  # (a + ib) @ M_W^T along axis 1
        return (jnp.einsum("hks,wk->hws", a, cw, precision=_P)
                - jnp.einsum("hks,wk->hws", b, sw, precision=_P),
                jnp.einsum("hks,wk->hws", b, cw, precision=_P)
                + jnp.einsum("hks,wk->hws", a, sw, precision=_P))

    a, b = rows(re.astype(jnp.float32), im.astype(jnp.float32))
    a, b = cols(a, b)
    orient = lambda x: jnp.transpose(x, (1, 0, 2))[:, ::-1, :]
    return orient(a), orient(b)


def recon_2d_multislice(kspace) -> np.ndarray:
    """[H, W, S] complex k-space -> complex image stack with the
    reference's orientation (transpose + column flip).

    Host-level wrapper: splits real/imag on host, runs the real-valued
    matmul recon on device, recombines to complex64 on host.
    """
    k = np.asarray(kspace)
    a, b = _recon_planes(jnp.asarray(k.real, jnp.float32),
                         jnp.asarray(k.imag, jnp.float32))
    return np.asarray(a) + 1j * np.asarray(b)


@jax.jit
def _rss_planes(re: jnp.ndarray, im: jnp.ndarray) -> jnp.ndarray:
    a, b = jax.vmap(_recon_planes)(re, im)
    return jnp.sqrt(jnp.sum(a * a + b * b, axis=0))


def recon_2d_multislice_rss(kspace_mc) -> np.ndarray:
    """[C, H, W, S] multi-coil k-space -> root-sum-of-squares magnitude
    image stack (real), in the reference's orientation.

    The reference's process_RAW is single-coil only (its 3-D per-slice loop,
    Vent_Analysis.py:538); this is the standard coil combine for data the
    reference cannot ingest: per-coil recon, then sqrt(sum_c |img_c|^2).
    """
    k = np.asarray(kspace_mc)
    out = _rss_planes(jnp.asarray(k.real, jnp.float32),
                      jnp.asarray(k.imag, jnp.float32))
    return np.asarray(out)
