"""Warm single-study serving latency (the daemon's user-facing metric).

Throughput (bench.py, ~340 vol/s/chip at batch 16) is the cohort number;
the serving daemon's number is *latency*: a study lands in the inbox —
how long until its metrics + exports exist?  The reference's equivalent
is an analyst clicking through the GUI: seconds for N4 + minutes for CI
per subject (BASELINE.md timing prints; /root/reference/Vent_Analysis.py
prints both).

Reported stages (one JSON line each, p50/p95 over --reps):

  device_only   — jitted fused pipeline on a warm program, batch 1
                  (compile excluded; host<->device transfer included)
  scan_e2e      — WatchService.scan_once for one newly-arrived study:
                  discovery + decode + device + NIfTI/JSON export, warm
                  programs (the steady-state serving latency)

Usage: python benchmarks/latency.py [--reps 20] [--shape 128 128 16]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORKDIR = "/tmp/ventjax_latency_bench"


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def bench_device_only(shape, vox, reps):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ventjax.config import DEFAULT_CONFIG
    from ventjax.io.phantom import make_cohort
    from ventjax.pipeline import analyze_cohort
    from ventjax.pipeline.analyze import build_geometry

    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=4096)
    geom = build_geometry(vox, shape, cfg)
    fn = jax.jit(lambda hp, mask: analyze_cohort(hp, mask, geom, cfg))
    hp, mask, _ = make_cohort(1, shape=shape, vox=vox, seed=0)
    hp, mask = jnp.asarray(hp), jnp.asarray(mask)
    # Warm (compile), then time each call to its end on the device.
    jax.block_until_ready(fn(hp, mask))
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(hp, mask))
        lat.append(time.perf_counter() - t0)
    return lat


def bench_scan_e2e(shape, vox, reps):
    from ventjax.io.synthetic import write_study
    from ventjax.pipeline.serve import WatchService

    if os.path.exists(WORKDIR):
        shutil.rmtree(WORKDIR)
    inbox = os.path.join(WORKDIR, "inbox")
    out = os.path.join(WORKDIR, "out")
    os.makedirs(inbox)
    svc = WatchService(inbox, out, use_mesh=False, min_age=0.0)
    # Warm scan: pays compile once (persistent XLA cache usually makes
    # this seconds, not minutes).
    write_study(os.path.join(inbox, "warm"), shape=shape, vox=vox, seed=999,
                with_proton=False)
    svc.scan_once()
    lat = []
    for i in range(reps):
        write_study(os.path.join(inbox, f"s{i:03d}"), shape=shape, vox=vox,
                    seed=i, with_proton=False)
        t0 = time.perf_counter()
        rep = svc.scan_once()
        lat.append(time.perf_counter() - t0)
        assert rep.analyzed == 1, rep
    return lat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shape", type=int, nargs=3, default=[128, 128, 16])
    args = ap.parse_args()
    shape = tuple(args.shape)
    vox = (1.5, 1.5, 10.0)

    from ventjax.utils.profiling import enable_compile_cache

    enable_compile_cache()

    for name, fn in (("device_only", bench_device_only),
                     ("scan_e2e", bench_scan_e2e)):
        lat = fn(shape, vox, args.reps)
        print(json.dumps({
            "metric": f"latency_{name}",
            "p50_ms": round(pct(lat, 50) * 1e3, 2),
            "p95_ms": round(pct(lat, 95) * 1e3, 2),
            "mean_ms": round(statistics.mean(lat) * 1e3, 2),
            "reps": args.reps,
            "shape": list(shape),
        }), flush=True)


if __name__ == "__main__":
    main()
