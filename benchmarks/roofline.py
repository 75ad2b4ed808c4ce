"""Roofline accounting for the pipeline's top time sinks.

For each hot component, measures on-device time and derives achieved
memory bytes/s and arithmetic FLOP/s from first-principles operation
counts, against the card's peaks, so "structural floor" claims are
auditable numbers instead of assertions.  The point of the table is the
DIAGNOSIS each row supports: a component near the bandwidth roof is
memory-bound (more fusion won't help), one near the FLOP roof is
compute-bound, and one far from BOTH is latency/serialization-bound,
where neither more FLOPs nor more bandwidth is the lever.

Peaks come from PEAKS, keyed by the device_kind JAX reports; a device
that is not in the table is an error.  FLOP fractions are against the
float32 rate outside the tensor cores (the rows count compares, adds and
the f32 dots, not bf16 products).

Operation counts are arithmetic LOWER bounds (documented per row below);
real traffic includes XLA temporaries, so achieved/peak fractions are
conservative (the truth is at least this close to the roof).

Usage: python benchmarks/roofline.py [--reps 30] [--batch 16]
One JSON line per row; markdown table at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published dense peaks per device_kind, taken at the card's full power
# limit (NVIDIA H100 data sheet, SXM part, 700 W): bf16/fp16 and TF32 on
# the tensor cores, float32 outside them, and HBM3 bandwidth.  A card set
# below 700 W (nvidia-smi power.limit) cannot hold these clocks; report
# the limit beside every fraction.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "f32_flops": 67e12,
        "hbm_bps": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Peak table row for a device; unknown devices are an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise SystemExit(
            f"roofline.py: no peak rates for device {device_kind!r}; add "
            "its data-sheet row to PEAKS") from None


def timeit(fn, args, reps, chain=10):
    """Median per-dispatch time with CHAINED dispatches: `chain` async
    dispatches per wait, so per-call host overhead amortizes for ms-scale
    ops.  The device executes in order, so waiting for the last output
    bounds all."""
    import jax

    jax.block_until_ready(fn(*args))  # warm/compile
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = None
        for _ in range(chain):
            out = fn(*args)
        jax.block_until_ready(out)
        lat.append((time.perf_counter() - t0) / chain)
    return statistics.median(lat)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    B = args.batch

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ventjax.ops.basic import sort_compact_masked
    from ventjax.utils.profiling import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"roofline.py: needs a GPU, found {dev.platform}")
    peaks = device_peaks(dev.device_kind)
    print(json.dumps({"device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}), flush=True)
    rows = []

    def emit(name, ms, flop=None, bytes_=None, note=""):
        row = {"component": name, "ms": round(ms * 1e3, 3)}
        if flop is not None:
            row["gflops_achieved"] = round(flop / ms / 1e9, 1)
            row["f32_frac"] = round(flop / ms / peaks["f32_flops"], 4)
        if bytes_ is not None:
            row["gbps_achieved"] = round(bytes_ / ms / 1e9, 1)
            row["hbm_frac"] = round(bytes_ / ms / peaks["hbm_bps"], 4)
        row["note"] = note
        rows.append(row)
        print(json.dumps(row), flush=True)

    V = 128 * 128 * 16          # flagship volume
    rng = np.random.default_rng(0)

    # Representative inputs: REAL phantoms (bias field + planted defects),
    # not random noise — random data converges N4 in one iteration and
    # makes every number a fantasy (first version of this script did).
    from ventjax.io.phantom import make_cohort
    hp_np, mask_np, _ = make_cohort(B, shape=(128, 128, 16),
                                    vox=(1.5, 1.5, 10.0), seed=3)
    hp = jnp.asarray(hp_np)
    mask = jnp.asarray(mask_np)

    # ---- 1. mask compaction (key-value lax.sort over V lanes) ----------
    vals = jnp.asarray(hp_np.reshape(B, V))
    m = jnp.asarray(mask_np.reshape(B, V) > 0)
    # timed fns return SLICES of their outputs, forcing full
    # materialization while keeping the outputs tiny.
    def _sorted_slice(v, mm):
        i, vv, n = sort_compact_masked(v, mm, 32768)
        return i[:8], vv[:8], n
    f_sort = jax.jit(jax.vmap(_sorted_slice))
    ms = timeit(f_sort, (vals, m), args.reps) / B
    # logical traffic LOWER bound: one read + one write of (key,value) =
    # V*8 B each way; the bitonic-class sort network makes ~log2(V)=18
    # passes over the data, so the sequential-work bound is 2*V*8*18.
    emit("mask compaction (kv-sort V=262144)", ms,
         bytes_=2 * V * 8 * 18,
         note="sort-network passes; far from both roofs => "
              "serialization-bound, not HBM-bound")

    # ---- 2. CI dense-map scatter (K values into V zeros) ---------------
    K = 4096
    idx = jnp.asarray(
        np.sort(rng.choice(V, (B, K), replace=False)).astype(np.int32))
    cv = jnp.asarray(rng.random((B, K)).astype(np.float32))
    # exactly the engine's dense-map scatter (calculate_ci_pairwise)
    f_scat = jax.jit(jax.vmap(
        lambda i, c: jnp.zeros(V, jnp.float32)
        .at[i].set(c, mode="drop")[::4096]))
    ms = timeit(f_scat, (idx, cv), args.reps) / B
    emit("CI dense-map scatter (K=4096 -> V)", ms,
         bytes_=V * 4 + K * 8,
         note="write V f32 + read K idx/val; XLA scatter lowering")

    # ---- 3. CI pairwise head (distance compare-reduce blocks) ----------
    from ventjax.ops.ci_pairwise import build_ci_pairwise_geometry
    geom = build_ci_pairwise_geometry(
        (1.5, 1.5, 10.0), (128, 128, 16), 50.0, "wrap")
    from ventjax.ops.ci_pairwise import calculate_ci_pairwise
    defect = np.zeros((B, 128, 128, 16), np.float32)
    for b in range(B):
        # clustered severe-ish load ~2000 voxels
        # clustered load like benchmarks config 6 (scattered singles would
        # push every row into the tail sort — a different operating point)
        r0, c0, s0 = rng.integers(20, 90), rng.integers(20, 90), rng.integers(2, 8)
        defect[b, r0:r0 + 14, c0:c0 + 14, s0:s0 + 6] = 1.0
        ii = rng.choice(V, 500, replace=False)
        defect[b].reshape(-1)[ii] = 1.0
    dj = jnp.asarray(defect)
    f_ci = jax.jit(jax.vmap(
        lambda d: calculate_ci_pairwise(d, geom, K)[0][::16, ::16, :]))
    ms = timeit(f_ci, (dj,), args.reps) / B
    # head arithmetic lower bound: rows*K pairwise d2 (3 mul + 3 add +
    # min-reduce over ~alias combos ~ 9) + 96-ball compare-count (rows*K*
    # 96 cmp+add) — count cmp/add as 1 op each.
    n_rows = int(defect.reshape(B, -1).sum(1).mean())
    flop = n_rows * K * (9 * 3 + 96 * 2)
    emit(f"CI pairwise full op (rows~{n_rows}, K={K})", ms, flop=flop,
         bytes_=(V * 4 * 2 + n_rows * K * 0),  # compaction read + dense write
         note="includes compaction+head+tail+scatter; arithmetic is the "
              "head bound only")

    # ---- 4. N4 (all levels) ---------------------------------------------
    from ventjax.ops.n4 import n4_bias_correction
    def _n4_slice(h, m):
        corr, it = n4_bias_correction(h, m, mask_pad=32768,
                                      return_iters=True)
        return corr[::16, ::16, :], it
    f_n4 = jax.jit(jax.vmap(_n4_slice))
    out = f_n4(hp, mask)
    iters = np.asarray(out[1])          # [B, levels]
    ms = timeit(f_n4, (hp, mask), args.reps) / B
    P = 32768
    # per-iteration arithmetic lower bound at level l (ncp = nl+3):
    #   fit num + delta: 2 * (2*P*ncp^3)   [3-way basis contractions]
    #   sharpen one-hot matmuls: 4 * 2*P*16*16 (hi/lo groups, G~13)
    total_flop = 0.0
    for l in range(iters.shape[1]):
        ncp = (4 - 3) * 2 ** l + 3
        it = float(iters[:, l].mean())
        total_flop += it * (2 * 2 * P * ncp ** 3 + 4 * 2 * P * 13 * 16)
    emit("N4 full op (P=32768, mean iters "
         f"{np.round(iters.mean(axis=0), 1).tolist()})", ms,
         flop=total_flop,
         bytes_=V * 4 * 3,
         note="fit+sharpen arithmetic lower bound over measured iteration "
              "counts")

    # ---- 5. context row: fused pipeline ---------------------------------
    from ventjax.config import DEFAULT_CONFIG
    from ventjax.pipeline.analyze import build_geometry, analyze_cohort
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=4096)
    g2 = build_geometry((1.5, 1.5, 10.0), (128, 128, 16), cfg)
    f_pipe = jax.jit(lambda h, m: analyze_cohort(h, m, g2, cfg).metrics.vdp)
    # (vdp is [B] — already tiny)
    ms = timeit(f_pipe, (hp, mask), args.reps) / B
    emit("fused pipeline (batch 16)", ms,
         note="context: the headline bench.py path")

    print("\n| component | ms/vol | GFLOP/s | f32 frac | GB/s | HBM frac | diagnosis |")
    print("|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['component']} | {r['ms']} | "
              f"{r.get('gflops_achieved','—')} | {r.get('f32_frac','—')} | "
              f"{r.get('gbps_achieved','—')} | {r.get('hbm_frac','—')} | "
              f"{r['note']} |")


if __name__ == "__main__":
    main()
