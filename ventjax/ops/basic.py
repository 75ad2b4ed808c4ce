"""Elementwise / reduction utilities shared across the pipeline.

All functions take and return jnp arrays, run under jit, and use only
static-shape-friendly primitives (masked reductions instead of boolean
indexing, sort-with-sentinel instead of compaction).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def sort_compact_masked(values: jnp.ndarray, m: jnp.ndarray, pad: int):
    """Compact the masked elements of a flat vector to `pad` leading slots.

    Returns (idx, vals, n_mask): row-major flat indices and values of the
    masked elements, padded to static length `pad` (padded idx slots are
    clamped to V-1; mask validity = arange(pad) < n_mask).  One key-value
    sort that carries the values along instead of re-gathering them after
    a jnp.nonzero(size=...), byte-identical in its first n_mask slots:
    ascending index keys reproduce nonzero's row-major order.
    """
    V = values.shape[0]
    key = jnp.where(m, jnp.arange(V, dtype=jnp.int32), jnp.int32(V))
    sk, sv = jax.lax.sort([key, values], num_keys=1)
    return jnp.minimum(sk[:pad], V - 1), sv[:pad], jnp.sum(m)


def compact_mask_indices(m: jnp.ndarray, pad: int):
    """sort_compact_masked without a value payload: (idx, n_mask)."""
    V = m.shape[0]
    key = jnp.where(m, jnp.arange(V, dtype=jnp.int32), jnp.int32(V))
    sk = jax.lax.sort(key)
    return jnp.minimum(sk[:pad], V - 1), jnp.sum(m)


def minmax_normalize(x: jnp.ndarray) -> jnp.ndarray:
    """(x - min) / (max - min) with the reference's zero-range guard
    (Vent_Analysis.py:233-237)."""
    lo = jnp.min(x)
    hi = jnp.max(x)
    rng = hi - lo
    return jnp.where(rng == 0, x, (x - lo) / jnp.where(rng == 0, 1.0, rng))


def gradient_border(a: jnp.ndarray) -> jnp.ndarray:
    """Per-slice gradient border of a binary [H,W,D] volume
    (Vent_Analysis.py:225-231): border = (d/drow != 0) | (d/dcol != 0).

    np.gradient along axes 0/1 of each slice equals the 3-D gradient along
    those axes because slices are independent, so this is fully vectorized.
    """
    a = a.astype(jnp.float32)
    gr = jnp.gradient(a, axis=0)
    gc = jnp.gradient(a, axis=1)
    return ((gr != 0) | (gc != 0)).astype(jnp.float32)


def masked_mean(x: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    w = m.astype(x.dtype)
    return jnp.sum(x * w) / jnp.sum(w)


def masked_std(x: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Population std (ddof=0, like np.std) over the masked voxels."""
    w = m.astype(x.dtype)
    n = jnp.sum(w)
    mu = jnp.sum(x * w) / n
    return jnp.sqrt(jnp.sum(w * (x - mu) ** 2) / n)


def _order_key(x: jnp.ndarray) -> jnp.ndarray:
    """Total-order uint32 key for float32 (IEEE monotone bit trick)."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    neg = bits >> 31 == 1
    return jnp.where(neg, ~bits, bits | jnp.uint32(0x80000000))


def _key_to_float(key: jnp.ndarray) -> jnp.ndarray:
    neg = key >> 31 == 0
    bits = jnp.where(neg, ~key, key & jnp.uint32(0x7FFFFFFF))
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def masked_kth_smallest(x: jnp.ndarray, m: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """Exact (k+1)-th smallest masked float32 value, sort-free.

    Instead of a full jnp.sort of the volume, run a 32-step binary search
    over the IEEE-754 bitspace (floats map to a totally ordered uint32
    key), counting masked values <= pivot with one fused compare-reduce
    per step.
    """
    keys = _order_key(x).reshape(-1)
    w = (m.reshape(-1) > 0)

    def body(_, bounds):
        lo, hi = bounds  # invariant: count(<= lo) <= k < count(<= hi)
        mid = lo + (hi - lo) // 2
        cnt = jnp.sum(w & (keys <= mid))
        return jnp.where(cnt <= k, mid, lo), jnp.where(cnt <= k, hi, mid)

    lo, hi = jax.lax.fori_loop(
        0, 32, body, (jnp.uint32(0), jnp.uint32(0xFFFFFFFF))
    )
    return _key_to_float(hi)


def masked_kth_smallest_multi(
    x: jnp.ndarray, m: jnp.ndarray, ks: jnp.ndarray
) -> jnp.ndarray:
    """masked_kth_smallest for a vector of ranks in one shared-read search.

    All ranks binary-search the same key array simultaneously: each of the
    32 steps reads the keys once and evaluates len(ks) counts, instead of
    len(ks) independent 32-pass searches.
    """
    keys = _order_key(x).reshape(-1)
    w = (m.reshape(-1) > 0)
    nk = ks.shape[0]

    def body(_, bounds):
        lo, hi = bounds  # [nk] each
        mid = lo + (hi - lo) // 2
        cnt = jnp.sum(
            w[:, None] & (keys[:, None] <= mid[None, :]), axis=0
        )
        take = cnt <= ks
        return jnp.where(take, mid, lo), jnp.where(take, hi, mid)

    lo, hi = jax.lax.fori_loop(
        0, 32, body,
        (jnp.zeros(nk, jnp.uint32), jnp.full(nk, 0xFFFFFFFF, jnp.uint32)),
    )
    return _key_to_float(hi)


def masked_sorted_index(x: jnp.ndarray, m: jnp.ndarray, frac: float) -> jnp.ndarray:
    """sorted(x[m>0])[int(count * frac)] with static shapes.

    Mirrors the reference's floor-index percentile convention
    (Vent_Analysis.py:255 `signal_list[int(len(signal_list)*.99)]` and
    :269 `CVlist[int(0.95*len(CVlist))]`), computed by bitspace selection
    instead of a sort.
    """
    count = jnp.sum(m > 0)
    idx = (count * frac).astype(jnp.int32)
    return masked_kth_smallest(x, m, idx)
