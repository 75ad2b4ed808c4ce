"""Headless CLI — the reference GUI's buttons as commands.

The reference wraps everything in a PySimpleGUI desktop app
(Vent_Analysis.py:607-1013); on a headless server the equivalent surface is a CLI
with the same actions (SURVEY.md §1 L5): load-from-paths, calculate VDP,
calculate CI, export (NIfTI + header JSON + pickle + screenshot + defect
DICOMs, with the GUI's IRB filename grammar), plus cohort-scale batch runs
the GUI never had.

Usage:
  python -m ventjax analyze --xenon X.dcm --mask MASKDIR [--proton P.dcm]
      --out OUT [--irb mepo --id 0039 --visit 1 --treatment preAlb]
      [--user RPT] [--no-ci]
  python -m ventjax cohort --manifest subjects.json --out OUT [--batch 16]
  python -m ventjax serve --inbox IN --out OUT [--interval 5] [--once]
  python -m ventjax twix --dat FILE.dat --out OUT
  python -m ventjax gui [--xenon X.dcm --mask MASKDIR ...]
  python -m ventjax info
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pickle
import sys


def _cmd_analyze(args) -> int:
    from ventjax.compat import Vent_Analysis
    from ventjax.config import DEFAULT_CONFIG, preset
    from ventjax.report.export import study_filename

    if args.deterministic:
        from ventjax.utils.profiling import enable_deterministic

        enable_deterministic()

    study = None
    cfg = DEFAULT_CONFIG
    if args.irb:
        # Per-study schema: validates the treatment/visit arms against the
        # reference GUI's columns (Vent_Analysis.py:659-672) and supplies
        # the study's VentConfig.
        study = preset(args.irb)
        study.validate(treatment=args.treatment, visit=args.visit)
        cfg = study.config
    if args.max_defect:
        cfg = cfg.replace(ci_max_defect_voxels=args.max_defect)
    if args.shard_slices:
        if args.shard_slices == "auto":
            import jax

            n_shards = len(jax.devices())
        else:
            try:
                n_shards = int(args.shard_slices)
            except ValueError:
                print(f"error: --shard-slices must be an integer or 'auto', "
                      f"got {args.shard_slices!r}", file=sys.stderr)
                return 2
        cfg = cfg.replace(ci_shard_slices=n_shards)

    if args.mask is None and not args.auto_mask:
        print("error: provide --mask FOLDER or --auto-mask (with --seg-ckpt)",
              file=sys.stderr)
        return 2
    mask_array = None
    if args.auto_mask:
        if args.proton is None:
            print("error: --auto-mask needs --proton", file=sys.stderr)
            return 2
        import numpy as np
        import jax.numpy as jnp
        from ventjax.io.dicom import open_single_dicom
        from ventjax.models.segmentation import (
            SegUNet, default_checkpoint_path, load_checkpoint, predict_mask,
        )

        ckpt = args.seg_ckpt or default_checkpoint_path()
        if not os.path.isdir(ckpt):
            print("error: --auto-mask needs --seg-ckpt (train one with "
                  "`python -m ventjax train-seg`); shipped artifact not "
                  f"found at {ckpt}", file=sys.stderr)
            return 2
        _, proton_arr = open_single_dicom(args.proton)
        model = SegUNet(base=args.seg_base)
        state = load_checkpoint(os.path.abspath(ckpt))
        mask_array = np.asarray(predict_mask(
            model, state.params, jnp.asarray(proton_arr.astype(np.float32))
        ))

    v = Vent_Analysis(
        xenon_path=args.xenon, mask_path=args.mask, proton_path=args.proton,
        mask_array=mask_array, config=cfg,
    )
    # Patient-info overrides: the GUI's edit buttons
    # (Vent_Analysis.py:819-838, 988-994) as flags.
    for flag, key in (
        (args.set_patient_name, "PatientName"),
        (args.set_age, "PatientAge"),
        (args.set_sex, "PatientSex"),
        (args.set_dob, "PatientBirthDate"),
        (args.set_study_date, "StudyDate"),
        (args.set_study_time, "StudyTime"),
        (args.disease, "Disease"),
    ):
        if flag is not None:
            v.metadata[key] = flag
    if args.mask_edit:
        # The reference's "edit mask" roadmap item (README.md:28) as a
        # scriptable recipe, applied to hand-drawn and --auto-mask masks
        # alike before any analysis.
        try:
            v.editMask(args.mask_edit)
        except ValueError as e:
            print(f"error: --mask-edit {e}", file=sys.stderr)
            return 2
    if mask_array is not None:
        # Inference-time QC gate on the predicted mask (round-5 VERDICT
        # item 4): warn — never fail — and surface the verdict in the
        # exported metadata so downstream consumers see it next to VDP.
        # Runs AFTER --mask-edit so the verdict describes the mask the
        # metrics are actually computed from (review finding): an edit
        # that repairs a suspect prediction clears the flag, one that
        # breaks it raises it.
        import numpy as np
        from ventjax.models.segmentation import mask_qc

        qc = mask_qc(np.asarray(v.mask), v.vox)
        v.metadata["automask_suspect"] = qc["suspect"]
        v.metadata["automask_qc"] = "; ".join(qc["reasons"])
        if qc["suspect"]:
            print("warning: auto-mask failed plausibility checks — "
                  + "; ".join(qc["reasons"])
                  + " — metrics below may be unreliable "
                  "(metadata.automask_suspect=true)", file=sys.stderr)
    if args.denoise is not None:
        # The reference's roadmap "Denoise Option" (README.md:29), prototyped
        # with Haar wavelets in its playground script.
        import jax.numpy as jnp
        import numpy as np
        from ventjax.ops.wavelet import denoise_volume

        v.HPvent = np.asarray(denoise_volume(
            jnp.asarray(np.asarray(v.HPvent, np.float32)), args.denoise
        ))
    v.calculate_VDP(thresh=args.thresh)
    if not args.no_ci:
        try:
            v.calculate_CI()
        except ValueError as e:
            # e.g. --shard-slices on a geometry the pairwise engine rejects,
            # or more shards than the halo allows — actionable user input.
            print(f"error: {e}", file=sys.stderr)
            return 2
    v.metadata["analysisUser"] = args.user
    v.metadata["DE"] = args.de or ""
    v.metadata["FEV1"] = args.fev1 or ""
    v.metadata["FVC"] = args.fvc or ""
    v.metadata["notes"] = args.notes or ""
    if args.irb:
        v.metadata["IRB"] = args.irb
        v.metadata["treatment"] = args.treatment or "none"
        v.metadata["visit"] = args.visit or ""
        v.metadata[study.id_field] = args.id
        file_name = study_filename(
            args.irb, v.metadata,
            genxe_id=args.id, mepo_id=args.id, clinical_id=args.id,
            visit=args.visit, treatment=args.treatment,
        )
    else:
        file_name = args.filename or str(v.metadata["PatientName"]).replace("^", "_")
    v.metadata["fileName"] = file_name

    os.makedirs(args.out, exist_ok=True)
    v.exportNifti(args.out, file_name)
    v.dicom_to_json(v.ds, os.path.join(args.out, f"{file_name}.json"))
    v.pickleMe(os.path.join(args.out, f"{file_name}.pkl"))
    if args.npz:
        v.saveNpz(os.path.join(args.out, f"{file_name}.npz"))
    v.screenShot(os.path.join(args.out, f"{file_name}.png"))
    if args.histogram:
        v.exportHistogram(os.path.join(args.out, f"{file_name}_hist.png"))
    v.exportDICOM(v.ds, args.out, optional_text=file_name, forPACS=True,
                  compress=args.compress_dicom)
    if args.archive:
        os.makedirs(args.archive, exist_ok=True)
        v.pickleMe(os.path.join(args.archive, f"{file_name}.pkl"))

    summary = {k: v.metadata[k] for k in
               ("SNR", "VDP", "VDP_lb", "VDP_km", "LungVolume",
                "DefectVolume", "CI")}
    out = {k: _jsonable(x) for k, x in summary.items()}
    if "automask_suspect" in v.metadata:
        out["automask_suspect"] = bool(v.metadata["automask_suspect"])
        out["automask_qc"] = str(v.metadata["automask_qc"])
    print(json.dumps(out, indent=2))
    return 0


def _jsonable(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


def _cmd_export(args) -> int:
    """Regenerate report exports from a saved study artifact.

    The reference GUI's 'Load Pickle' button followed by 'Export'
    (Vent_Analysis.py:919-941, 943-1013), and its playground's
    pickle-reload + re-screenshot workflow (vent playground.py) — as one
    command over either checkpoint format (pickle or the versioned NPZ).
    `--recalculate` reruns the analysis on the stored arrays first, so an
    archived study can be re-analyzed (e.g. a new --thresh) without the
    raw DICOMs.
    """
    import numpy as np

    from ventjax.compat import Vent_Analysis
    from ventjax.report.export import ReferencePickleError

    src = args.pickle or args.npz_in
    try:
        if args.pickle:
            v = Vent_Analysis(pickle_path=args.pickle)
        else:
            v = Vent_Analysis(npz_path=args.npz_in)
    except (ReferencePickleError, ValueError, OSError, EOFError,
            pickle.UnpicklingError) as e:
        # OSError covers a missing/unreadable file; EOFError a truncated
        # pickle; UnpicklingError a corrupt (bit-flipped) one — all
        # user-input problems, not crashes.
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not hasattr(v, "HPvent") or not hasattr(v, "mask"):
        print(f"error: {src} holds no HPvent/mask arrays; nothing to export",
              file=sys.stderr)
        return 2
    # Slim artifacts (cohort NPZs) carry only the analysis arrays; derived
    # display state is recomputed, not required.
    if not hasattr(v, "mask_border"):
        v.mask_border = v.calculateBorder(np.asarray(v.mask))
    if args.recalculate:
        v.calculate_VDP(thresh=args.thresh)
        if not args.no_ci:
            v.calculate_CI()
    analyzed = not (isinstance(v.defectArray, str)
                    or isinstance(v.N4HPvent, str))

    file_name = (args.filename or str(v.metadata.get("fileName") or "")
                 or os.path.splitext(os.path.basename(src))[0])
    os.makedirs(args.out, exist_ok=True)
    written, skipped = [], []
    written.append(v.exportNifti(args.out, file_name))
    v.pickleMe(os.path.join(args.out, f"{file_name}.pkl"))
    written.append(os.path.join(args.out, f"{file_name}.pkl"))
    if args.npz:
        written.append(v.saveNpz(os.path.join(args.out, f"{file_name}.npz")))
    if not isinstance(v.ds, str):
        jpath = os.path.join(args.out, f"{file_name}.json")
        v.dicom_to_json(v.ds, jpath)
        written.append(jpath)
    else:
        skipped.append("header JSON (artifact carries no DICOM dataset)")
    if analyzed:
        ppath = os.path.join(args.out, f"{file_name}.png")
        v.screenShot(ppath)
        written.append(ppath)
        if args.histogram:
            hpath = os.path.join(args.out, f"{file_name}_hist.png")
            v.exportHistogram(hpath)
            written.append(hpath)
        if not isinstance(v.ds, str):
            written.append(v.exportDICOM(
                v.ds, args.out, optional_text=file_name, forPACS=True,
                compress=args.compress_dicom))
        else:
            skipped.append("defect DICOMs (artifact carries no DICOM dataset)")
    else:
        skipped.append("screenshot + defect DICOMs (artifact not analyzed; "
                       "use --recalculate)")
    summary = {k: _jsonable(v.metadata.get(k, "")) for k in
               ("SNR", "VDP", "VDP_lb", "VDP_km", "LungVolume",
                "DefectVolume", "CI")}
    print(json.dumps({"written": written, "skipped": skipped,
                      "metrics": summary}, indent=2))
    return 0


def _cmd_cohort(args) -> int:
    from ventjax.pipeline.cohort import load_manifest, run_cohort
    from ventjax.utils.profiling import trace

    from ventjax.config import DEFAULT_CONFIG

    if args.deterministic:
        from ventjax.utils.profiling import enable_deterministic

        enable_deterministic()

    cfg = DEFAULT_CONFIG
    if args.max_defect:
        cfg = cfg.replace(ci_max_defect_voxels=args.max_defect)
    manifest = load_manifest(args.manifest)
    watchdog = contextlib.nullcontext()
    if args.stall_timeout > 0:
        from ventjax.utils.watchdog import StallWatchdog

        watchdog = StallWatchdog(args.stall_timeout, label="cohort")
    progress = None
    if args.progress or args.stall_timeout > 0:
        # One JSON line per progress event on stderr (stdout stays the
        # machine-readable result) — tail-able for long cohorts.  The
        # same events feed the stall watchdog when one is armed.
        def progress(stage, done, total):
            if args.stall_timeout > 0:
                watchdog.touch()
            if args.progress:
                print(json.dumps({"stage": stage, "done": done,
                                  "total": total}),
                      file=sys.stderr, flush=True)
    with trace(args.profile_dir), watchdog:
        results = run_cohort(
            manifest, args.out, config=cfg, batch_size=args.batch,
            use_mesh=not args.no_mesh, resume=not args.fresh,
            export_npz=args.npz, shard_export=args.shard_export,
            compact_export=not args.dense_export,
            progress=progress,
        )
    ok = sum(1 for r in results if r.get("valid"))
    print(json.dumps({"subjects": len(results), "valid": ok,
                      "out": args.out}))
    # Aggregate files go to one shared path: under multihost only process 0
    # writes them (every process holds identical results lists; N
    # concurrent "w"-mode writers would tear the files).
    import jax
    if jax.process_index() != 0:
        return 0
    # cohort-level aggregate summary: distribution stats per metric plus an
    # explicit accounting of failed / flagged lanes (pipeline.summary)
    from ventjax.pipeline.summary import cohort_summary

    with open(os.path.join(args.out, "cohort_summary.json"), "w") as f:
        json.dump(cohort_summary(results), f, indent=2)
    # cohort-level CSV (+ parquet when pyarrow exists) aggregation
    import csv
    keys = sorted({k for r in results for k in r})
    with open(os.path.join(args.out, "cohort_metrics.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        w.writerows(results)
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        pass
    else:
        # one typed column per key; heterogenous cells (a metric on one
        # subject, an error string on another) degrade that column to string
        cols = {}
        for k in keys:
            vals = [r.get(k) for r in results]
            if all(v is None or isinstance(v, (int, float, bool))
                   for v in vals):
                cols[k] = vals
            else:
                cols[k] = [None if v is None else str(v) for v in vals]
        pq.write_table(pa.table(cols),
                       os.path.join(args.out, "cohort_metrics.parquet"))
    return 0


def _cmd_train_seg(args) -> int:
    """Train the proton->mask U-Net on synthetic phantoms (host data, jitted
    device steps) and save an orbax checkpoint usable by analyze --auto-mask."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ventjax.io.phantom import make_cohort, make_random_cohort
    from ventjax.models.segmentation import (
        create_train_state, save_checkpoint, train_step,
    )

    shape = tuple(args.shape)
    model, tx, state = create_train_state(
        jax.random.PRNGKey(args.seed), shape=shape[:2], base=args.base,
        learning_rate=args.lr,
    )
    step = jax.jit(lambda s, p, m: train_step(model, tx, s, p, m))
    loss = float("nan")
    for i in range(args.steps):
        # Domain-randomized phantoms (geometry/contrast/noise/bias/partial-
        # volume edges vary per sample) so the checkpoint generalizes past
        # one generator configuration; --plain-phantoms restores the old
        # fixed-generator behavior.
        if args.plain_phantoms:
            _, mask, proton = make_cohort(
                args.batch, shape=shape, seed=args.seed + 1 + i
            )
        else:
            _, mask, proton = make_random_cohort(
                args.batch, shape=shape,
                seed=args.seed + 1 + i * args.batch,
            )
        state, loss_t = step(state, jnp.asarray(proton), jnp.asarray(mask))
        if (i + 1) % 25 == 0 or i == 0:
            loss = float(np.asarray(loss_t))
            print(f"step {i + 1}/{args.steps}: loss {loss:.4f}", flush=True)
    save_checkpoint(os.path.abspath(args.out), state,
                    params_only=args.params_only)
    print(json.dumps({"checkpoint": os.path.abspath(args.out),
                      "steps": args.steps, "final_loss": loss}))
    return 0


def _cmd_twix(args) -> int:
    import numpy as np
    from ventjax.io.twix import read_twix
    from ventjax.ops.fft_recon import (
        recon_2d_multislice, recon_2d_multislice_rss,
    )

    tw = read_twix(args.dat)
    # complex arrays stay on host: the recon wrappers split real/imag and
    # run the MXU matmul-DFT (no complex dtype ever reaches the device)
    if tw.n_channels > 1:
        k = tw.kspace_multicoil()
        img = recon_2d_multislice_rss(k)
        combine = "rss"
        kshape = list(k.shape)
    else:
        k = tw.kspace()
        img = recon_2d_multislice(k)
        combine = "none"
        kshape = list(k.shape)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "raw_HPvent.npy"), img)
    print(json.dumps({
        "protocol": tw.protocol_name,
        "scan_datetime": tw.scan_datetime,
        "header_params": tw.header_params,
        "kspace_shape": kshape,
        "channels": tw.n_channels,
        "coil_combine": combine,
        "out": os.path.join(args.out, "raw_HPvent.npy"),
    }))
    return 0


def parse_geometry_spec(spec: str):
    """Parse a --prewarm geometry spec ``HxWxD[@vr,vc,vs]`` into
    ((H, W, D), (vr, vc, vs)); vox defaults to the common clinical
    (1.5, 1.5, 10.0) mm when omitted."""
    shape_s, _, vox_s = spec.partition("@")
    try:
        shape = tuple(int(x) for x in shape_s.lower().split("x"))
        vox = ((1.5, 1.5, 10.0) if not vox_s
               else tuple(float(x) for x in vox_s.split(",")))
    except ValueError:
        raise ValueError(f"bad geometry spec {spec!r}: expected "
                         "HxWxD[@vr,vc,vs], e.g. 128x128x16@1.5,1.5,10.0")
    # all(v > 0) is False for NaN too (NaN comparisons are all False),
    # unlike a min(vox) <= 0 test, which NaN would sneak past.
    if len(shape) != 3 or len(vox) != 3 or not all(d >= 1 for d in shape) \
            or not all(math.isfinite(v) and v > 0 for v in vox):
        raise ValueError(f"bad geometry spec {spec!r}: need three positive "
                         "dims and three positive finite voxel sizes")
    return shape, vox


def _cmd_serve(args) -> int:
    import signal
    import threading

    from ventjax.config import DEFAULT_CONFIG
    from ventjax.pipeline.serve import WatchService

    if args.deterministic:
        from ventjax.utils.profiling import enable_deterministic

        enable_deterministic()
    cfg = DEFAULT_CONFIG
    if args.max_defect:
        cfg = cfg.replace(ci_max_defect_voxels=args.max_defect)
    svc = WatchService(
        args.inbox, args.out, config=cfg, batch_size=args.batch,
        use_mesh=not args.no_mesh, ready_marker=args.ready_marker,
        min_age=args.min_age, max_retries=args.max_retries,
        retry_backoff=args.retry_backoff, settle_scans=args.settle_scans,
        export_npz=args.npz,
    )

    # Validate --prewarm specs FIRST: pure string parsing must fail fast,
    # not after the preflight battery.
    geoms = []
    if args.prewarm:
        try:
            geoms = [parse_geometry_spec(s) for s in args.prewarm]
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    # The startup phases (doctor device probe, prewarm compiles) hit the
    # device before serve_forever arms its per-scan watchdog — and the
    # wedge mode is a STARTUP hazard too (a trivial device probe can
    # block in native code).  Reuse --scan-timeout as a per-phase stall budget:
    # preflight completion and every prewarm progress event feed it.
    if args.scan_timeout > 0 and (args.preflight or geoms):
        from ventjax.utils.watchdog import StallWatchdog

        startup_wd = StallWatchdog(args.scan_timeout,
                                   label="serve startup")
    else:
        startup_wd = None

    with (startup_wd or contextlib.nullcontext()):
        if args.preflight:
            # Refuse to serve on a broken install: run the doctor battery
            # before the first scan.  The result (pass or fail) also lands
            # in the serve_status.json heartbeat for monitors.
            from ventjax.utils.doctor import format_report

            report = svc.preflight()
            if not report["ok"]:
                print(format_report(report), file=sys.stderr)
                print("error: preflight failed; not serving",
                      file=sys.stderr)
                return 2
            if startup_wd is not None:
                startup_wd.touch()

        if geoms:
            secs = svc.prewarm(
                geoms,
                progress=(None if startup_wd is None
                          else lambda *a: startup_wd.touch()),
            )
            print(json.dumps({"prewarmed": len(geoms),
                              "seconds": round(secs, 1)}), file=sys.stderr)

    last_pending = [None]

    def on_scan(report):
        # One JSON line per scan — machine-tailable service output.  Print
        # whenever the scan did work (incl. retries, which have new=0) or
        # the pending count changed; a permanently non-conforming inbox
        # entry thus prints once, not every interval.  --verbose prints
        # every scan.
        did_work = (report.new or report.retried or report.resumed
                    or report.analyzed or report.failed)
        pending_changed = report.pending != last_pending[0]
        last_pending[0] = report.pending
        if did_work or pending_changed or args.verbose:
            print(json.dumps(report.as_dict()), flush=True)

    if args.once:
        report = svc.scan_once()
        print(json.dumps(report.as_dict()))
        return 0 if report.failed == 0 else 1
    stop = threading.Event()
    # Graceful shutdown under process supervisors (systemd, docker stop):
    # SIGTERM finishes the in-flight scan, then exits the loop cleanly so
    # the last subject's export + .done marker are never torn.
    try:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
    except ValueError:
        pass  # not the main thread (embedded use); SIGTERM stays default
    try:
        svc.serve_forever(interval=args.interval, stop=stop,
                          max_scans=args.max_scans, on_scan=on_scan,
                          scan_timeout=args.scan_timeout)
    except KeyboardInterrupt:
        pass
    return 0


def _cmd_gui(args) -> int:
    from ventjax.gui.app import GuiUnavailableError, launch
    from ventjax.gui.controller import GuiState, VentController

    state = GuiState(
        dicom_path=args.xenon or "", mask_path=args.mask or "",
        proton_path=args.proton or "", twix_path=args.twix or "",
        export_path=args.out or "", archive_path=args.archive or "",
        user=args.user or "",
    )
    try:
        launch(VentController(state))
    except GuiUnavailableError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


def _cmd_doctor(args) -> int:
    from ventjax.utils.doctor import format_report, run_doctor

    report = run_doctor(full=args.full)
    print(format_report(report))
    return 0 if report["ok"] else 1


def _cmd_info(args) -> int:
    import dataclasses

    import jax
    import ventjax
    from ventjax.config import DEFAULT_CONFIG

    print(json.dumps({
        "ventjax": ventjax.__version__,
        "jax": jax.__version__,
        "devices": [str(d) for d in jax.devices()],
        "default_config": dataclasses.asdict(DEFAULT_CONFIG),
    }, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The full ventjax argument parser (split from main so tests and docs
    can introspect the subcommand surface without invoking anything)."""
    p = argparse.ArgumentParser(prog="ventjax")
    p.add_argument(
        "--no-compile-cache", action="store_true",
        help="disable the persistent XLA compilation cache (by default "
        "$JAX_COMPILATION_CACHE_DIR, else .jax_cache in the checkout; "
        "repeat invocations reuse compiled programs)")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("analyze", help="analyze one study and export reports")
    a.add_argument("--xenon", required=True)
    a.add_argument("--mask", default=None)
    a.add_argument("--proton", default=None)
    a.add_argument("--out", required=True)
    a.add_argument("--thresh", type=float, default=0.6)
    a.add_argument("--no-ci", action="store_true")
    a.add_argument("--user", default="")
    a.add_argument("--irb", choices=["genxe", "mepo", "clinical"], default=None)
    a.add_argument("--id", default="0000")
    a.add_argument("--visit", default=None)
    a.add_argument("--treatment", default=None)
    a.add_argument("--de", default=None)
    a.add_argument("--fev1", default=None)
    a.add_argument("--fvc", default=None)
    a.add_argument("--notes", default=None)
    a.add_argument("--disease", default=None,
                   help="Disease metadata (GUI radio, Vent_Analysis.py:660)")
    a.add_argument("--set-patient-name", default=None,
                   help="override PatientName (GUI edit button)")
    a.add_argument("--set-age", default=None, help="override PatientAge")
    a.add_argument("--set-sex", default=None, help="override PatientSex")
    a.add_argument("--set-dob", default=None, help="override PatientBirthDate")
    a.add_argument("--set-study-date", default=None, help="override StudyDate")
    a.add_argument("--set-study-time", default=None, help="override StudyTime")
    a.add_argument("--auto-mask", action="store_true",
                   help="predict the lung mask from --proton with the U-Net "
                   "(no --mask folder needed)")
    a.add_argument("--seg-ckpt", default=None,
                   help="orbax checkpoint for --auto-mask (see train-seg)")
    a.add_argument("--seg-base", type=int, default=16,
                   help="U-Net base width the checkpoint was trained with")
    a.add_argument("--deterministic", action="store_true",
                   help="force deterministic XLA reductions")
    a.add_argument("--filename", default=None)
    a.add_argument("--archive", default=None,
                   help="optional second pickle copy (the GUI's archive box)")
    a.add_argument("--max-defect", type=int, default=None,
                   help="static bound on defect voxels for CI (default 8192)")
    a.add_argument("--histogram", action="store_true",
                   help="also export the masked-signal histogram with the "
                   "linear-binning edges ({file}_hist.png)")
    a.add_argument("--mask-edit", default=None, metavar="RECIPE",
                   help="morphology recipe applied to the mask before "
                   "analysis, e.g. 'close:1,fillholes,erode:1' (ops: "
                   "dilate/erode/open/close[:iters], fillholes)")
    a.add_argument("--compress-dicom", action="store_true",
                   help="write the defect-overlay DICOMs RLE Lossless "
                   "compressed (PS3.5 Annex G) instead of Explicit VR LE")
    a.add_argument("--npz", action="store_true",
                   help="also export the versioned NPZ study artifact "
                   "(pickle-free; loads anywhere NumPy exists)")
    a.add_argument("--denoise", type=float, default=None, metavar="THRESH",
                   help="Haar-wavelet denoise the xenon volume first")
    a.add_argument("--shard-slices", default=None, metavar="N|auto",
                   help="oversize volumes: shard the CI slice axis over N "
                   "devices ('auto' = all visible devices) via halo "
                   "exchange — bit-identical to unsharded (requires the "
                   "pairwise CI engine)")
    a.set_defaults(fn=_cmd_analyze)

    e = sub.add_parser(
        "export",
        help="regenerate report exports from a saved study artifact "
        "(pickle or NPZ) — the GUI's Load-Pickle + Export workflow",
    )
    esrc = e.add_mutually_exclusive_group(required=True)
    esrc.add_argument("--pickle", default=None, metavar="STUDY.pkl",
                      help="study pickle (pickleMe / analyze output)")
    esrc.add_argument("--npz-in", default=None, metavar="STUDY.npz",
                      help="versioned NPZ study artifact (saveNpz / "
                      "analyze --npz / cohort --npz output)")
    e.add_argument("--out", required=True)
    e.add_argument("--filename", default=None,
                   help="output basename (default: the artifact's stored "
                   "fileName, else the input file's stem)")
    e.add_argument("--recalculate", action="store_true",
                   help="rerun VDP (+CI) on the stored arrays before "
                   "exporting — re-analyze without the raw DICOMs")
    e.add_argument("--thresh", type=float, default=0.6,
                   help="mean-anchored defect threshold for --recalculate")
    e.add_argument("--no-ci", action="store_true",
                   help="skip CI during --recalculate")
    e.add_argument("--histogram", action="store_true",
                   help="also export the masked-signal histogram")
    e.add_argument("--compress-dicom", action="store_true",
                   help="RLE Lossless defect-overlay DICOMs")
    e.add_argument("--npz", action="store_true",
                   help="also (re)write the versioned NPZ artifact")
    e.set_defaults(fn=_cmd_export)

    ts = sub.add_parser(
        "train-seg",
        help="train the proton->mask U-Net on synthetic phantoms and save "
        "an orbax checkpoint for analyze --auto-mask",
    )
    ts.add_argument("--out", required=True, help="checkpoint directory")
    ts.add_argument("--steps", type=int, default=200)
    ts.add_argument("--batch", type=int, default=8)
    ts.add_argument("--shape", type=int, nargs=3, default=(128, 128, 16))
    ts.add_argument("--base", type=int, default=16)
    ts.add_argument("--seed", type=int, default=0)
    ts.add_argument("--lr", type=float, default=1e-3)
    ts.add_argument("--params-only", action="store_true",
                    help="save an inference-only checkpoint (no optimizer "
                    "state; the shipped-artifact form)")
    ts.add_argument("--plain-phantoms", action="store_true",
                    help="train on the fixed-generator phantoms instead of "
                    "the domain-randomized ones")
    ts.set_defaults(fn=_cmd_train_seg)

    c = sub.add_parser("cohort", help="batched cohort run from a manifest")
    c.add_argument("--manifest", required=True)
    c.add_argument("--out", required=True)
    c.add_argument("--batch", type=int, default=None)
    c.add_argument("--no-mesh", action="store_true")
    c.add_argument("--fresh", action="store_true", help="ignore done-markers")
    c.add_argument("--profile-dir", default=None,
                   help="emit a jax.profiler trace (TensorBoard/Perfetto)")
    c.add_argument("--npz", action="store_true",
                   help="also write each subject's versioned NPZ artifact")
    c.add_argument("--dense-export", action="store_true",
                   help="ship full dense n4/defect volumes device->host "
                   "instead of the compact pack (masked n4 values + "
                   "B-spline lattices + defect indices); the compact "
                   "default is bit-exact at every analyzed voxel and "
                   "~8x less transfer")
    c.add_argument("--shard-export", action="store_true",
                   help="multi-host: each process exports its own batch "
                   "lanes (shared filesystem required) instead of "
                   "process 0 exporting everything")
    c.add_argument("--progress", action="store_true",
                   help="emit JSON progress events (decode/analyze/"
                   "export) on stderr as the cohort streams")
    c.add_argument("--stall-timeout", type=float, default=0.0,
                   help="watchdog: hard-exit (code 86) if no decode/"
                   "analyze/export progress for this many seconds — "
                   "recovers a wedged device runtime under a job "
                   "scheduler (rerun resumes from .done markers); size "
                   "it above the worst-case gap incl. cold-cache "
                   "compilation; 0 disables")
    c.add_argument("--max-defect", type=int, default=None,
                   help="static bound on defect voxels for CI (default 8192)")
    c.add_argument("--deterministic", action="store_true",
                   help="force deterministic XLA reductions")
    c.set_defaults(fn=_cmd_cohort)

    s = sub.add_parser(
        "serve",
        help="watch an inbox directory and analyze studies as they arrive "
        "(warm jitted programs across scans; exactly-once via .done markers)",
    )
    s.add_argument("--inbox", required=True,
                   help="directory to watch; each subdirectory holding "
                   "xenon.dcm + mask/ (optional proton.dcm) is a subject")
    s.add_argument("--out", required=True, help="output root (one "
                   "subdirectory per subject id + serve_log.jsonl)")
    s.add_argument("--interval", type=float, default=5.0,
                   help="seconds between inbox scans")
    s.add_argument("--once", action="store_true",
                   help="single scan, then exit (exit 1 if any new subject "
                   "failed)")
    s.add_argument("--max-scans", type=int, default=None,
                   help="stop after N scans (default: run until SIGINT)")
    s.add_argument("--ready-marker", default=None, metavar="NAME",
                   help="only pick up a subject once NAME exists in its "
                   "directory (producer drops it after the copy completes)")
    s.add_argument("--min-age", type=float, default=1.0,
                   help="without --ready-marker: require the subject's "
                   "newest file mtime to be at least this many seconds old "
                   "before pickup (guards half-copied studies)")
    s.add_argument("--max-retries", type=int, default=2,
                   help="re-attempt a failed subject up to N times with "
                   "exponential backoff; after that it waits until its "
                   "files change on disk (which re-arms a fresh budget)")
    s.add_argument("--retry-backoff", type=float, default=60.0,
                   help="base seconds before the first retry of a failed "
                   "subject (doubles on each further attempt)")
    s.add_argument("--prewarm", action="append", default=[],
                   metavar="HxWxD[@vr,vc,vs]",
                   help="compile the pipeline for this study geometry "
                   "before serving (repeatable), so the first real "
                   "arrival skips the first-compile latency; vox "
                   "defaults to 1.5,1.5,10.0 mm, e.g. "
                   "--prewarm 128x128x16@1.5,1.5,10.0")
    s.add_argument("--scan-timeout", type=float, default=0.0,
                   help="watchdog: hard-exit (code 86) if one scan runs "
                   "longer than this many seconds — recovers a wedged "
                   "device runtime under a process supervisor (systemd "
                   "Restart=, docker --restart); also budgets each "
                   "startup phase (--preflight battery, each --prewarm "
                   "compile step); size it above the worst-case scan "
                   "incl. first-scan compilation; 0 disables (ignored "
                   "with --once except for the startup phases)")
    s.add_argument("--preflight", action="store_true",
                   help="run the doctor check battery before serving; "
                   "exit 2 without scanning if a required check fails "
                   "(result recorded in serve_status.json)")
    s.add_argument("--settle-scans", type=int, default=0,
                   help="require a subject's file signature to be stable "
                   "across N consecutive scans before first pickup — use "
                   "N>=1 for producers that preserve source mtimes "
                   "(rsync -a), which defeat the --min-age test")
    s.add_argument("--npz", action="store_true",
                   help="also write each subject's versioned NPZ artifact")
    s.add_argument("--batch", type=int, default=None)
    s.add_argument("--no-mesh", action="store_true")
    s.add_argument("--max-defect", type=int, default=None,
                   help="static bound on defect voxels for CI (default 8192)")
    s.add_argument("--deterministic", action="store_true",
                   help="force deterministic XLA reductions")
    s.add_argument("--verbose", action="store_true",
                   help="print a JSON line for quiet scans too")
    s.set_defaults(fn=_cmd_serve)

    t = sub.add_parser("twix", help="reconstruct a Siemens twix .dat")
    t.add_argument("--dat", required=True)
    t.add_argument("--out", required=True)
    t.set_defaults(fn=_cmd_twix)

    g = sub.add_parser(
        "gui", help="desktop GUI (tkinter port of the reference app)")
    g.add_argument("--xenon", default=None, help="prefill the DICOM path")
    g.add_argument("--mask", default=None, help="prefill the mask folder")
    g.add_argument("--proton", default=None)
    g.add_argument("--twix", default=None)
    g.add_argument("--out", default=None, help="prefill the export path")
    g.add_argument("--archive", default=None, help="archive pickle dir")
    g.add_argument("--user", default=None)
    g.set_defaults(fn=_cmd_gui)

    d = sub.add_parser(
        "doctor",
        help="deployment self-check: device probe, compile cache, codec "
        "round-trip, pipeline-vs-oracle self-test; exit 0 iff healthy",
    )
    d.add_argument("--full", action="store_true",
                   help="flagship-geometry self-test incl. CI (slower; "
                   "times the device path)")
    d.set_defaults(fn=_cmd_doctor)

    i = sub.add_parser("info", help="version / device info")
    i.set_defaults(fn=_cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if os.environ.get("VENTJAX_DEBUG_STACKS"):
        # Hang forensics (a runtime call blocked in native code shows
        # zero CPU and no error): dump every thread's Python stack to
        # stderr every 120 s so a stuck run shows WHERE it is stuck.
        import faulthandler

        faulthandler.dump_traceback_later(120, repeat=True)
    if not args.no_compile_cache and args.cmd in ("analyze", "cohort",
                                                  "twix", "train-seg",
                                                  "gui", "serve"):
        from ventjax.utils.profiling import enable_compile_cache

        enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
