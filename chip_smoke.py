"""Smoke test of ventjax on an NVIDIA GPU: the main path, end to end, once.

Drives what a user runs, in one process, at the reference's own geometry
(128x128x16 at 1.5x1.5x10 mm, batch 16):

  1. device    the GPU, its power limit, JAX, the compile cache, the codec
  2. kernels   the CI head kernel compiled for the card, bit-equal to the
               XLA head at every tested pad, both timed
  3. fidelity  N4, masks, VDPs and CI maps against the float64 oracles;
               recon against numpy.fft; the compact export blob bit-exact
  4. cohort    `ventjax cohort` over 32 DICOM studies on disk, then a rerun
               that resumes from the done-markers
  5. serve     one WatchService scan over an inbox of 4 studies
  6. severe    clustered severe-disease loads at pad K=4096 through the
               fused program, CI voxel-exact against the oracle
  7. facade    the reference-compatible Vent_Analysis class on one study

Usage:
  python chip_smoke.py          # the phases above, on one card
  python chip_smoke.py --four   # only the multi-device paths, on four cards

Every phase raises on failure, so any failure exits non-zero.  The last line
of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
Timings are printed beside the card's name and power limit; this is a smoke
test, not a benchmark.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPE = (128, 128, 16)
VOX = (1.5, 1.5, 10.0)
BATCH = 16
HEAD_PADS = {"friendly": (512, 1024, 2048, 4096, 8192), "severe": (4096, 8192)}
SEVERE_PAD = 4096
COHORT_STUDIES = 32
FOUR_STUDIES = 38        # not a multiple of the batch: the last is ragged
OVERSIZE = (256, 256, 62)
N4_ENVELOPE = 2e-3       # relative N4 error over the mask (ROADMAP)
VDP_TOL_PP = 0.1         # |dVDP| in percentage points
CI_TOL_MM = 2e-5         # float32 rounding of the CI map, in mm
RECON_TOL = 1e-4         # relative, against numpy.fft
N4_MESH_TOL = 2e-4       # relative, mesh vs single-device programs

# Precision of every dot on the fused path (PERF.md lists the same table).
DOT_PRECISION = (
    ("n4 sharpen DFT matmuls", "HIGHEST (full f32)"),
    ("n4 one-hot histogram / expectation dots", "HIGHEST (full f32)"),
    ("n4 fit normalizer (den)", "HIGHEST (full f32)"),
    ("n4 fit num and delta products",
     "bf16 operands, f32 accumulation (explicit)"),
    ("n4 final field einsum", "HIGHEST (full f32)"),
    ("fft_recon DFT matmuls", "HIGHEST (full f32)"),
    ("CI, VDP, k-means, SNR", "no dot: elementwise and reductions"),
)


class Smoke:
    """Phase timer and printer; every line names the card."""

    def __init__(self):
        self.card = ""
        self.compile_s = 0.0
        self.t_phase = time.perf_counter()

    def line(self, phase, msg):
        print(f"[{phase}] {msg}", flush=True)

    def done(self, phase, **extra):
        import jax

        dt = time.perf_counter() - self.t_phase
        peak = jax.devices()[0].memory_stats() or {}
        fields = " ".join(f"{k}={v}" for k, v in extra.items())
        self.line(phase, f"PASS seconds={dt:.2f} compile_s_total="
                  f"{self.compile_s:.2f} peak_bytes_in_use="
                  f"{peak.get('peak_bytes_in_use', 'n/a')} {fields} "
                  f"({self.card})")
        self.t_phase = time.perf_counter()


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def require_gpu(device):
    """The device gate: a smoke run on anything but a GPU is refused."""
    if device.platform != "gpu":
        raise SystemExit(f"chip_smoke.py: no GPU; JAX found "
                         f"{device.platform} ({device.device_kind})")


def result_line(device, count):
    return json.dumps({"ok": True, "device": {
        "platform": device.platform, "kind": device.device_kind,
        "count": count}})


def card_label():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        raise SystemExit(f"chip_smoke.py: nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def timeit(fn, *args, reps=5):
    """Median seconds of fn(*args), each call waited for on the device."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts))


def severe_images(defects):
    """Phantom lungs whose signal drops to 5% inside the clustered severe
    defect loads of benchmarks/run.py (config 6)."""
    import numpy as np

    from ventjax.io.phantom import make_phantom

    hps, masks = [], []
    for b, d in enumerate(defects):
        ph = make_phantom(shape=d.shape, vox=VOX, seed=100 + b, n_defects=0)
        hps.append(ph.hp * np.where(d > 0, 0.05, 1.0))
        masks.append(ph.mask)
    return (np.stack(hps).astype(np.float32),
            np.stack(masks).astype(np.float32))


def ci_oracle_maps(defects, workers=8):
    from ventjax.oracle.ci_oracle import calculate_ci_oracle

    with ThreadPoolExecutor(workers) as ex:
        return list(ex.map(
            lambda d: calculate_ci_oracle(d, VOX, saturate=True), defects))


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------
def phase_device(s):
    from ventjax.utils.profiling import (
        GPU_DETERMINISM_FLAG, enable_compile_cache)

    cache = enable_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    require_gpu(dev)
    s.card = card_label()
    jax.monitoring.register_event_duration_secs_listener(
        lambda name, secs, **kw: setattr(s, "compile_s", s.compile_s + secs)
        if name == "/jax/core/compile/backend_compile_duration" else None)
    from ventjax.io import native

    s.line("device", f"kind={dev.device_kind!r} count={len(jax.devices())} "
           f"nvidia-smi={s.card!r} jax={jax.__version__}")
    s.line("device", f"compile_cache={cache!r} "
           f"dicom_codec={'native' if native.available() else 'python'}")
    # The CLI's --deterministic sets this flag through XLA_FLAGS, where an
    # unknown name aborts the process; a per-compile option with the same
    # name is checked here without making this whole run deterministic.
    probe = jax.jit(lambda x, i: x.at[i].add(1.0)).lower(
        jnp.zeros(8), jnp.arange(4)).compile(
        compiler_options={GPU_DETERMINISM_FLAG: True})
    check(float(probe(jnp.zeros(8), jnp.arange(4)).sum()) == 4.0,
          "deterministic scatter probe")
    s.line("device", f"determinism flag {GPU_DETERMINISM_FLAG!r} accepted "
           f"by this card's XLA (deterministic scatter compiled and ran)")
    s.done("device")
    return dev


# --------------------------------------------------------------------------
# 2. kernels
# --------------------------------------------------------------------------
def phase_kernels(s, severe, friendly):
    import jax
    import numpy as np

    from ventjax.ops.ci_pairwise import (
        HEAD_KERNEL_MIN_K, build_ci_pairwise_geometry, calculate_ci_pairwise)

    geom = build_ci_pairwise_geometry(VOX, SHAPE, 50, "wrap")
    loads = {"friendly": friendly, "severe": severe}
    cells = [(name, loads[name], K)
             for name, pads in HEAD_PADS.items() for K in pads]
    for name, load, K in cells:
        fns = {
            use: jax.jit(jax.vmap(lambda d, use=use, K=K:
                                  calculate_ci_pairwise(d, geom, K,
                                                        use_pallas=use)))
            for use in (True, False)
        }
        compiled = fns[True].lower(load).compile()
        if (name, K) == ("severe", SEVERE_PAD):
            s.line("kernels", f"ci_head_first_fail memory_analysis at "
                   f"K={K}, batch {BATCH}: {compiled.memory_analysis()}")
        outs = {use: jax.tree_util.tree_map(np.asarray, f(load))
                for use, f in fns.items()}
        for a, b in zip(outs[True], outs[False]):
            check(np.array_equal(a, b),
                  f"CI head kernel != XLA head ({name}, K={K})")
        t_k = timeit(fns[True], load)
        t_x = timeit(fns[False], load)
        s.line("kernels", f"ci_head {name} K={K} batch={BATCH}: bit-equal; "
               f"kernel {t_k * 1e3:.3f} ms, xla {t_x * 1e3:.3f} ms "
               f"(whole CI op; overflowing lanes "
               f"{int(outs[True][2].sum())}) ({s.card})")
    s.done("kernels", auto_kernel_from_K=HEAD_KERNEL_MIN_K)


# --------------------------------------------------------------------------
# 3. fidelity
# --------------------------------------------------------------------------
def phase_fidelity(s, hp, mask, n4_oracle_futures):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ventjax.config import DEFAULT_CONFIG
    from ventjax.oracle import reference as ref
    from ventjax.pipeline.analyze import analyze_cohort, build_geometry

    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=SEVERE_PAD,
                                 n4_mask_pad=49152)
    geom = build_geometry(VOX, SHAPE, cfg)
    res = jax.jit(lambda h, m: analyze_cohort(h, m, geom, cfg))(
        jnp.asarray(hp), jnp.asarray(mask))
    res = jax.tree_util.tree_map(np.asarray, res)
    check(res.metrics.valid.all(), "invalid lane in the phantom cohort")
    check(not res.metrics.ci_overflow.any() and
          not res.metrics.n4_overflow.any(), "overflow flag standing")

    # Masks, on the same N4 input: device ops vs the reference formulas.
    for b in range(len(hp)):
        n4, m = res.n4[b].astype(np.float64), mask[b]
        d_ref, _ = ref.vdp_mean_anchored(n4, m, cfg.vdp_thresh)
        lb_ref, _ = ref.vdp_linear_binning(n4, m, cfg.lb_edges,
                                           cfg.lb_percentile)
        check(np.array_equal(res.defect[b], d_ref), f"lane {b}: defect mask")
        check(np.array_equal(res.defect_lb[b], lb_ref),
              f"lane {b}: linear-binning mask")
    s.line("fidelity", f"defect and linear-binning masks exact on all "
           f"{len(hp)} lanes")

    # N4 and the three VDPs end to end against the float64 oracle N4.
    worst = {"n4_max": 0.0, "n4_mean": 0.0, "vdp": 0.0, "vdp_lb": 0.0,
             "vdp_km": 0.0}
    for b, fut in n4_oracle_futures:
        oc = fut.result()
        m = mask[b] > 0
        rel = np.abs(res.n4[b] - oc)[m] / (np.abs(oc)[m] + 1e-6)
        worst["n4_max"] = max(worst["n4_max"], float(rel.max()))
        worst["n4_mean"] = max(worst["n4_mean"], float(rel.mean()))
        _, vdp = ref.vdp_mean_anchored(oc, mask[b], cfg.vdp_thresh)
        _, vdp_lb = ref.vdp_linear_binning(oc, mask[b], cfg.lb_edges,
                                           cfg.lb_percentile)
        _, vdp_km = ref.vdp_kmeans(oc, mask[b], cfg.kmeans_clusters,
                                   cfg.kmeans_iters,
                                   cfg.kmeans_defect_clusters)
        for k, want in (("vdp", vdp), ("vdp_lb", vdp_lb),
                        ("vdp_km", vdp_km)):
            got = float(getattr(res.metrics, k)[b])
            worst[k] = max(worst[k], abs(got - float(want)))
    check(worst["n4_max"] < N4_ENVELOPE, f"N4 envelope: {worst}")
    for k in ("vdp", "vdp_lb", "vdp_km"):
        check(worst[k] < VDP_TOL_PP, f"|d{k}| >= {VDP_TOL_PP} pp: {worst}")
    s.line("fidelity", f"oracle N4 on lanes "
           f"{[b for b, _ in n4_oracle_futures]}: N4 rel max "
           f"{worst['n4_max']:.3e} mean {worst['n4_mean']:.3e} "
           f"(< {N4_ENVELOPE}); |dVDP| pp mean-anchored {worst['vdp']:.4f} "
           f"linear-binning {worst['vdp_lb']:.4f} k-means "
           f"{worst['vdp_km']:.4f} (< {VDP_TOL_PP})")

    # CI maps voxel-exact against the oracle on the device's own defects.
    oracle_ci = ci_oracle_maps(res.defect)
    ci_dev = max(float(np.abs(res.ci_map[b] - o).max())
                 for b, o in enumerate(oracle_ci))
    check(ci_dev <= CI_TOL_MM, f"CI map off the oracle by {ci_dev} mm")
    s.line("fidelity", f"CI maps vs oracle, {len(hp)} lanes "
           f"(K={SEVERE_PAD}): max |d| {ci_dev:.2e} mm (<= {CI_TOL_MM})")

    # Recon: multi-coil 128x128 slices against numpy.fft.
    from ventjax.ops.fft_recon import (
        recon_2d_multislice, recon_2d_multislice_rss)

    rng = np.random.default_rng(17)
    k = (rng.normal(size=(4, 128, 128, 4))
         + 1j * rng.normal(size=(4, 128, 128, 4))).astype(np.complex64)

    def fft_ref(kc):
        img = np.fft.fftshift(np.fft.fft2(np.fft.fftshift(
            kc.astype(np.complex128), axes=(0, 1)), axes=(0, 1)),
            axes=(0, 1))
        return np.transpose(img, (1, 0, 2))[:, ::-1, :]

    one = fft_ref(k[0])
    err1 = float(np.abs(recon_2d_multislice(k[0]) - one).max()
                 / np.abs(one).max())
    rss = np.sqrt(sum(np.abs(fft_ref(k[c])) ** 2 for c in range(4)))
    err4 = float(np.abs(recon_2d_multislice_rss(k) - rss).max()
                 / rss.max())
    check(max(err1, err4) < RECON_TOL, f"recon error {err1}, {err4}")
    s.line("fidelity", f"recon vs numpy.fft: single-coil {err1:.2e}, "
           f"4-coil RSS {err4:.2e} (< {RECON_TOL})")

    # The compact export blob: bit-transparent int32 lanes, and the host
    # rebuild bit-equal to the same program's dense channels.
    from ventjax.pipeline.cohort import (
        _GeometryRunner, _decode_host_pack, _densify_ci,
        _rebuild_compact_pack)

    runner = _GeometryRunner(SHAPE, VOX, cfg, mesh=None, batch_size=4)
    h4, m4 = jnp.asarray(hp[:4]), jnp.asarray(mask[:4])
    host = _decode_host_pack(
        jax.tree_util.tree_map(
            np.asarray, runner._fn(SEVERE_PAD, 65536, compact=True)(h4, m4)),
        runner.blob_schema(SEVERE_PAD, 65536))
    dense = jax.tree_util.tree_map(
        np.asarray, runner._fn(SEVERE_PAD, 65536, compact=False)(h4, m4))
    cfg_p = cfg.replace(n4_mask_pad=65536)
    for lane in range(4):
        want_idx = np.flatnonzero(dense["defect"][lane].reshape(-1))
        n = int(host["n_def"][lane])
        check(n == len(want_idx) and np.array_equal(
            host["cidx"][lane][:n], want_idx),
            f"lane {lane}: blob index lanes not bit-exact")
        lp = jax.tree_util.tree_map(lambda x: x[lane], host)
        rb = _rebuild_compact_pack(lp, hp[lane], mask[lane], cfg_p)
        check(np.array_equal(rb["defect"], dense["defect"][lane]),
              f"lane {lane}: compact defect channel")
        check(np.array_equal(_densify_ci(rb), _densify_ci(
            jax.tree_util.tree_map(lambda x: x[lane], dense))),
            f"lane {lane}: compact CI channel")
        mf = mask[lane].reshape(-1) > 0
        check(np.array_equal(rb["n4"].reshape(-1)[mf],
                             dense["n4"][lane].reshape(-1)[mf]),
              f"lane {lane}: compact n4 at masked voxels")
    s.line("fidelity", "compact blob: int32 index lanes and rebuilt "
           "channels bit-exact on 4 lanes")
    for name, prec in DOT_PRECISION:
        s.line("fidelity", f"dot precision: {name}: {prec}")
    s.done("fidelity")
    return res


# --------------------------------------------------------------------------
# 4. cohort, 5. serve
# --------------------------------------------------------------------------
def write_cohort(root, n, seed0=200):
    from ventjax.io.synthetic import write_study

    manifest = []
    for i in range(n):
        d = os.path.join(root, f"s{i:03d}")
        write_study(d, shape=SHAPE, vox=VOX, seed=seed0 + i,
                    with_proton=False)
        manifest.append({"id": f"s{i:03d}", "xenon": f"{d}/xenon.dcm",
                         "mask": f"{d}/mask"})
    path = os.path.join(root, "manifest.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return manifest, path


def check_exports(out, ids):
    import numpy as np

    from ventjax.io.nifti import load as nifti_load

    for sid in ids:
        sdir = os.path.join(out, sid)
        check(os.path.exists(os.path.join(sdir, ".done")), f"{sid}: no .done")
        with open(os.path.join(sdir, "metrics.json")) as f:
            m = json.load(f)
        check(m["valid"] and np.isfinite(m["VDP"]) and np.isfinite(m["CI"]),
              f"{sid}: metrics {m}")
        data, _ = nifti_load(os.path.join(sdir, f"{sid}_dataArray.nii"))
        check(data.shape == (*SHAPE, 6), f"{sid}: NIfTI shape {data.shape}")


def phase_cohort(s, tmp):
    from ventjax import cli

    n = COHORT_STUDIES
    manifest, mpath = write_cohort(os.path.join(tmp, "cohort_in"), n)
    out = os.path.join(tmp, "cohort_out")
    t0 = time.perf_counter()
    check(cli.main(["cohort", "--manifest", mpath, "--out", out,
                    "--batch", "16"]) == 0, "cohort exit code")
    dt = time.perf_counter() - t0
    ids = [e["id"] for e in manifest]
    check_exports(out, ids)
    with open(os.path.join(out, "cohort_summary.json")) as f:
        summary = json.load(f)
    check(not summary["failed"], f"failed lanes: {summary['failed']}")
    check(not summary["flags"]["ci_overflow"]
          and not summary["flags"]["n4_overflow"],
          f"standing overflow flags: {summary['flags']}")
    from ventjax.pipeline.cohort import load_manifest, run_cohort

    events = []
    rerun = run_cohort(load_manifest(mpath), out,
                       progress=lambda stage, done, total:
                       events.append((stage, done)))
    analyzed = max([d for st, d in events if st == "analyze"], default=0)
    check(analyzed == 0 and len(rerun) == n,
          f"rerun analyzed {analyzed} subjects")
    s.done("cohort", studies=n, seconds_incl_compile=f"{dt:.2f}",
           studies_per_s=f"{n / dt:.3f}", rerun_analyzed=analyzed)


def phase_serve(s, tmp, severe_defect):
    from ventjax.io.phantom import make_phantom
    from ventjax.io.synthetic import write_study
    from ventjax.pipeline.serve import WatchService

    inbox = os.path.join(tmp, "inbox")
    out = os.path.join(tmp, "served")
    for i in range(4):
        ph = make_phantom(shape=SHAPE, vox=VOX, seed=300 + i,
                          n_defects=0 if i == 0 else 3)
        if i == 0:  # one arrival carries a severe clustered defect load
            ph.hp = (ph.hp * (1.0 - 0.95 * (severe_defect > 0))).astype(
                "float32")
        write_study(os.path.join(inbox, f"p{i}"), phantom=ph,
                    with_proton=False)
    svc = WatchService(inbox, out, min_age=0.0)
    first = svc.scan_once()
    check(first.analyzed == 4 and first.failed == 0, f"scan 1: {first}")
    again = svc.scan_once()
    check(again.analyzed == 0 and again.new == 0, f"scan 2: {again}")
    check_exports(out, [f"p{i}" for i in range(4)])
    s.done("serve", scan1=json.dumps(first.as_dict()),
           scan2_analyzed=again.analyzed)


# --------------------------------------------------------------------------
# 6. severe CI, 7. facade
# --------------------------------------------------------------------------
def phase_severe(s, severe):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ventjax.config import DEFAULT_CONFIG
    from ventjax.pipeline.analyze import analyze_cohort, build_geometry

    hp, mask = severe_images(severe)
    cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=SEVERE_PAD,
                                 n4_mask_pad=49152)
    geom = build_geometry(VOX, SHAPE, cfg)
    fn = jax.jit(lambda h, m: analyze_cohort(h, m, geom, cfg))
    res = jax.tree_util.tree_map(
        np.asarray, fn(jnp.asarray(hp), jnp.asarray(mask)))
    n_def = res.defect.reshape(len(hp), -1).sum(1).astype(int)
    check(not res.metrics.ci_overflow.any(),
          f"CI overflow standing at K={SEVERE_PAD}: "
          f"{res.metrics.ci_overflow}")
    oracle_ci = ci_oracle_maps(res.defect)
    dev = max(float(np.abs(res.ci_map[b] - o).max())
              for b, o in enumerate(oracle_ci))
    check(dev <= CI_TOL_MM, f"severe CI off the oracle by {dev} mm")
    ms = timeit(fn, jnp.asarray(hp), jnp.asarray(mask), reps=3) * 1e3
    s.done("severe", defects_per_lane=f"{n_def.min()}-{n_def.max()}",
           ci_vs_oracle_mm=f"{dev:.2e}",
           fused_batch_ms=f"{ms:.3f}")


def phase_facade(s, tmp):
    import numpy as np

    from ventjax.compat import Vent_Analysis
    from ventjax.io.synthetic import write_study

    root = os.path.join(tmp, "facade")
    write_study(root, shape=SHAPE, vox=VOX, seed=400)
    va = Vent_Analysis(xenon_path=f"{root}/xenon.dcm",
                       mask_path=f"{root}/mask",
                       proton_path=f"{root}/proton.dcm")
    va.calculate_VDP()
    va.calculate_CI()
    va.exportNifti(root, "facade")
    check(np.isfinite(float(va.metadata["VDP"]))
          and np.isfinite(float(va.metadata["CI"])),
          f"facade metadata {va.metadata}")
    check(os.path.exists(os.path.join(root, "facade_dataArray.nii")),
          "facade NIfTI missing")
    s.done("facade", VDP=va.metadata["VDP"], CI=va.metadata["CI"])


# --------------------------------------------------------------------------
# --four: the multi-device paths
# --------------------------------------------------------------------------
def phase_four(s, tmp):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ventjax.io.nifti import load as nifti_load
    from ventjax.pipeline.cohort import load_manifest, run_cohort

    check(len(jax.devices()) == 4, f"--four needs 4 devices, found "
          f"{len(jax.devices())}")
    n = FOUR_STUDIES
    manifest, mpath = write_cohort(os.path.join(tmp, "four_in"), n)
    outs = {}
    for name, use_mesh in (("mesh", True), ("card0", False)):
        out = os.path.join(tmp, f"four_{name}")
        t0 = time.perf_counter()
        res = run_cohort(load_manifest(mpath), out, batch_size=16,
                         use_mesh=use_mesh)
        check(len(res) == n, f"{name}: {len(res)} results")
        s.line("four", f"run_cohort {name}: {n} studies in "
               f"{time.perf_counter() - t0:.2f} s incl. compile "
               f"({s.card})")
        outs[name] = out
    worst_n4 = 0.0
    for e in manifest:
        sid = e["id"]
        arrs, mets = [], []
        for name in ("mesh", "card0"):
            sdir = os.path.join(outs[name], sid)
            arrs.append(nifti_load(os.path.join(sdir,
                                                f"{sid}_dataArray.nii"))[0])
            with open(os.path.join(sdir, "metrics.json")) as f:
                mets.append(json.load(f))
        a, b = arrs
        check(np.array_equal(a[..., 5], b[..., 5]), f"{sid}: CI maps differ")
        check(np.array_equal(a[..., 4], b[..., 4]), f"{sid}: defects differ")
        for k in ("VDP", "VDP_lb", "VDP_km"):
            check(mets[0][k] == mets[1][k], f"{sid}: {k} differs")
        m = a[..., 2] > 0
        rel = np.abs(a[..., 3] - b[..., 3])[m] / np.maximum(
            np.abs(b[..., 3])[m], 1e-6)
        worst_n4 = max(worst_n4, float(rel.max()))
    check(worst_n4 < N4_MESH_TOL, f"N4 mesh vs card0 rel {worst_n4}")
    s.line("four", f"cohort mesh(4) vs card 0: CI maps and defect masks "
           f"bit-equal, VDPs equal, N4 rel max {worst_n4:.2e} "
           f"(< {N4_MESH_TOL})")

    from benchmarks.run import make_severe_defects
    from ventjax.dist.halo import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise)

    defect = jnp.asarray(make_severe_defects(1, OVERSIZE, VOX)[0])
    geom = build_ci_pairwise_geometry(VOX, OVERSIZE, 50, "wrap")
    ci_s, nsat_s, ovf_s = calculate_ci_sharded(
        defect, geom, n_shards=4, max_defect_voxels=SEVERE_PAD)
    ci_u, nsat_u, ovf_u = jax.jit(
        lambda d: calculate_ci_pairwise(d, geom, SEVERE_PAD))(defect)
    check(not bool(ovf_s) and not bool(ovf_u), "sharded CI overflow")
    check(np.array_equal(np.asarray(ci_s), np.asarray(ci_u))
          and int(nsat_s) == int(nsat_u), "sharded CI != unsharded")
    s.line("four", f"calculate_ci_sharded {OVERSIZE} over 4 cards: "
           f"bit-equal to the unsharded engine "
           f"({int(np.asarray(defect).sum())} defect voxels)")
    s.done("four")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the multi-device paths, on four cards")
    args = p.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "ventjax")):
        raise SystemExit("chip_smoke.py: no ventjax package beside this "
                         "script; run it from a ventjax checkout")
    sys.path.insert(0, ROOT)
    s = Smoke()
    dev = phase_device(s)
    import jax

    with tempfile.TemporaryDirectory(prefix="ventjax_smoke_") as tmp:
        if args.four:
            phase_four(s, tmp)
            print(result_line(dev, len(jax.devices())))
            return 0
        import jax.numpy as jnp
        import numpy as np

        from benchmarks.run import make_severe_defects
        from ventjax.io.phantom import make_cohort
        from ventjax.oracle.n4_oracle import n4_bias_correction_oracle

        hp, mask, _ = make_cohort(BATCH, shape=SHAPE, vox=VOX, seed=0)
        severe = make_severe_defects(BATCH, SHAPE, VOX)
        # The float64 N4 oracle takes about a minute per study: start it
        # now, on host threads, for four lanes.
        pool = ThreadPoolExecutor(4)
        lanes = sorted({0, BATCH // 3, 2 * BATCH // 3, BATCH - 1})
        n4_oracle_futures = [
            (b, pool.submit(n4_bias_correction_oracle,
                            hp[b].astype(np.float64), mask[b]))
            for b in lanes]
        try:
            from ventjax.config import DEFAULT_CONFIG
            from ventjax.pipeline.analyze import (
                analyze_cohort, build_geometry)

            cfg = DEFAULT_CONFIG.replace(ci_max_defect_voxels=8192,
                                         n4_mask_pad=49152)
            geom = build_geometry(VOX, SHAPE, cfg)
            friendly = jax.jit(lambda h, m: analyze_cohort(
                h, m, geom, cfg).defect)(jnp.asarray(hp), jnp.asarray(mask))
            phase_kernels(s, jnp.asarray(severe), friendly)
            phase_fidelity(s, hp, mask, n4_oracle_futures)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
        phase_cohort(s, tmp)
        phase_serve(s, tmp, severe[0])
        phase_severe(s, severe)
        phase_facade(s, tmp)
    print(result_line(dev, len(jax.devices())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
