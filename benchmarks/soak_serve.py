"""Serve-daemon soak: many scans with bursty arrivals, bounded memory.

The serving claims (warm programs, O(batch) memory, exactly-once) are
individually tested; this harness exercises them TOGETHER over a long run
and reports what an operator would watch: per-scan latency percentiles
over time, cumulative counters, and host RSS growth after warmup (a leak
in the runner jit caches, the retry bookkeeping, or the export pool shows
up here as monotonic RSS).

Arrival pattern per scan: mostly idle scans (the daemon's steady state),
with single arrivals and occasional bursts (tests the adaptive-pad size
ladder staying within its {1,2,4,8} compile set).

Usage: python benchmarks/soak_serve.py [--scans 60] [--shape 64 64 8]
One JSON line per phase; exits nonzero if RSS growth exceeds --rss-mb.
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

WORKDIR = "/tmp/ventjax_soak_serve"


def rss_mb() -> float:
    """CURRENT resident set (VmRSS), not ru_maxrss — the peak-only maxrss
    permanently registers every transient compile spike and cannot detect
    a plateau."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    raise RuntimeError("VmRSS not found")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=60)
    ap.add_argument("--shape", type=int, nargs=3, default=[64, 64, 8])
    ap.add_argument("--rss-mb", type=float, default=200.0,
                    help="max allowed RSS growth after warmup (measured "
                    "4.8 MB over 60 scans / 70 subjects, 2026-08-20 — "
                    "the bound leaves room for allocator noise, not for "
                    "a real leak)")
    args = ap.parse_args()
    shape = tuple(args.shape)
    vox = (1.5, 1.5, 10.0)

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # pin the platform through the config API too, as the tests do
        import jax

        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from ventjax.io.synthetic import write_study
    from ventjax.pipeline.serve import WatchService

    if os.path.exists(WORKDIR):
        shutil.rmtree(WORKDIR)
    inbox = os.path.join(WORKDIR, "inbox")
    os.makedirs(inbox)
    svc = WatchService(inbox, os.path.join(WORKDIR, "out"),
                       use_mesh=False, min_age=0.0)

    # Warmup: compile EVERY adaptive rung the soak can hit (1, 2, 4, 8),
    # so soak-phase RSS growth isolates leaks from legitimate one-time
    # jit-cache growth.
    w = 0
    for burst in (1, 2, 4, 8):
        for _ in range(burst):
            write_study(os.path.join(inbox, f"w{w:03d}"), shape=shape,
                        vox=vox, seed=900 + w)
            w += 1
        svc.scan_once()
    rss0 = rss_mb()
    print(json.dumps({"phase": "warmup", "rss_mb": round(rss0, 1)}),
          flush=True)

    rng = np.random.default_rng(0)
    lat, analyzed = [], 0
    sid = 0
    for k in range(args.scans):
        r = rng.random()
        n_new = 0 if r < 0.4 else (1 if r < 0.85 else int(rng.integers(2, 9)))
        for _ in range(n_new):
            write_study(os.path.join(inbox, f"s{sid:04d}"), shape=shape,
                        vox=vox, seed=1000 + sid)
            sid += 1
        t0 = time.perf_counter()
        rep = svc.scan_once()
        lat.append(time.perf_counter() - t0)
        analyzed += rep.analyzed
        assert rep.failed == 0, rep
    lat_ms = sorted(x * 1e3 for x in lat)
    pct = lambda p: lat_ms[min(len(lat_ms) - 1,
                               int(round(p / 100 * (len(lat_ms) - 1))))]
    growth = rss_mb() - rss0
    print(json.dumps({
        "phase": "soak", "scans": args.scans, "subjects": analyzed,
        "scan_p50_ms": round(pct(50), 1), "scan_p95_ms": round(pct(95), 1),
        "scan_max_ms": round(max(lat_ms), 1),
        "rss_growth_mb": round(growth, 1),
        "rss_bound_mb": args.rss_mb,
        "ok": growth <= args.rss_mb,
    }), flush=True)
    assert analyzed == sid, (analyzed, sid)
    # every subject exported exactly once with a done marker
    for i in range(sid):
        assert os.path.exists(os.path.join(WORKDIR, "out", f"s{i:04d}",
                                           ".done"))
    sys.exit(0 if growth <= args.rss_mb else 1)


if __name__ == "__main__":
    main()
