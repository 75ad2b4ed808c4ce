"""CLI + cohort driver end to end (the GUI-replacement surface)."""
import json
import os

import jax
import numpy as np
import pytest

from ventjax.cli import main
from ventjax.io.synthetic import write_study


@pytest.fixture(scope="module")
def study_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_study")
    write_study(str(root), shape=(64, 64, 8), vox=(1.5, 1.5, 10.0), seed=6)
    return str(root)


def test_cli_analyze_mepo_grammar(study_root, tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = main([
        "analyze", "--xenon", f"{study_root}/xenon.dcm",
        "--mask", f"{study_root}/mask", "--out", out, "--max-defect", "1024",
        "--irb", "mepo", "--id", "0039", "--visit", "1",
        "--treatment", "preAlb", "--user", "tester",
    ])
    assert rc == 0
    base = "Mepo0039_240301_visit1_preAlb"
    files = set(os.listdir(out))
    assert {f"{base}.json", f"{base}.pkl", f"{base}.png",
            f"{base}_dataArray.nii", "defectDICOMS"} <= files
    summary = json.loads(capsys.readouterr().out)
    assert 0 < summary["VDP"] < 50


def test_cli_cohort_with_error_isolation_and_resume(study_root, tmp_path, capsys):
    manifest = [
        {"id": "s0", "xenon": f"{study_root}/xenon.dcm",
         "mask": f"{study_root}/mask",
         "proton": f"{study_root}/proton.dcm"},
        {"id": "s1", "xenon": f"{study_root}/xenon.dcm",
         "mask": f"{study_root}/mask"},
        {"id": "bad", "xenon": "/nonexistent.dcm", "mask": "/nope"},
    ]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    out = str(tmp_path / "cohort")
    rc = main(["cohort", "--manifest", mpath, "--out", out, "--batch", "2",
               "--max-defect", "1024"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["subjects"] == 3 and report["valid"] == 2
    m0 = json.load(open(os.path.join(out, "s0", "metrics.json")))
    m1 = json.load(open(os.path.join(out, "s1", "metrics.json")))
    assert m0["VDP"] == m1["VDP"]  # identical inputs
    # manifest "proton" feeds NIfTI channel 0 (reference channel order);
    # subjects without one get the zero channel
    from ventjax.io import dicom as dcm, nifti
    _, proton = dcm.open_single_dicom(f"{study_root}/proton.dcm")
    d0, _ = nifti.load(os.path.join(out, "s0", "s0_dataArray.nii"))
    d1, _ = nifti.load(os.path.join(out, "s1", "s1_dataArray.nii"))
    assert np.array_equal(d0[..., 0], proton.astype(np.float32))
    assert not d1[..., 0].any()
    assert os.path.exists(os.path.join(out, "cohort_metrics.csv"))
    # parquet aggregation (written whenever pyarrow is importable): same
    # rows as the CSV, with the error lane's string column intact
    try:
        import pyarrow.parquet as pq
    except ImportError:
        pass
    else:
        t = pq.read_table(os.path.join(out, "cohort_metrics.parquet"))
        assert t.num_rows == 3
        byid = {r["id"]: r for r in t.to_pylist()}
        assert byid["s0"]["VDP"] == pytest.approx(m0["VDP"])
        assert not byid["bad"]["valid"] or byid["bad"].get("error")
    # cohort aggregate summary: stats over the two valid lanes, the decode
    # failure accounted for explicitly (pipeline.summary)
    summ = json.load(open(os.path.join(out, "cohort_summary.json")))
    assert summ["subjects"] == 3 and summ["valid"] == 2
    assert summ["failed"] == [{"id": "bad", "error": "decode_failed"}]
    assert summ["metrics"]["VDP"]["n"] == 2
    assert summ["metrics"]["VDP"]["mean"] == pytest.approx(m0["VDP"])
    assert summ["metrics"]["VDP"]["std"] == pytest.approx(0.0)
    # resume: done markers short-circuit
    rc = main(["cohort", "--manifest", mpath, "--out", out])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["valid"] == 2
    # the summary is rebuilt from the re-read metrics.json files on resume
    summ = json.load(open(os.path.join(out, "cohort_summary.json")))
    assert summ["metrics"]["VDP"]["n"] == 2 and summ["valid"] == 2


def test_cli_analyze_mask_edit(study_root, tmp_path, capsys):
    """--mask-edit applies the morphology recipe before analysis; a grown
    mask raises LungVolume vs the untouched run."""
    out1 = str(tmp_path / "plain")
    rc = main(["analyze", "--xenon", f"{study_root}/xenon.dcm",
               "--mask", f"{study_root}/mask", "--out", out1,
               "--no-ci", "--filename", "plain"])
    assert rc == 0
    plain = json.loads(capsys.readouterr().out)
    out2 = str(tmp_path / "edited")
    rc = main(["analyze", "--xenon", f"{study_root}/xenon.dcm",
               "--mask", f"{study_root}/mask", "--out", out2,
               "--no-ci", "--filename", "edited",
               "--mask-edit", "dilate:1,fillholes"])
    assert rc == 0
    edited = json.loads(capsys.readouterr().out)
    assert edited["LungVolume"] > plain["LungVolume"]

    rc = main(["analyze", "--xenon", f"{study_root}/xenon.dcm",
               "--mask", f"{study_root}/mask", "--out", out2,
               "--mask-edit", "sharpen:1"])
    assert rc == 2  # unknown op -> clean exit, not a traceback


def test_cli_twix(tmp_path, rng, capsys):
    from ventjax.io.twix import write_synthetic_twix
    k = (rng.normal(size=(16, 12, 2))
         + 1j * rng.normal(size=(16, 12, 2))).astype(np.complex64)
    dat = str(tmp_path / "m.dat")
    write_synthetic_twix(dat, k)
    rc = main(["twix", "--dat", dat, "--out", str(tmp_path / "o")])
    assert rc == 0
    info = json.loads(capsys.readouterr().out)
    assert info["kspace_shape"] == [16, 12, 2]
    assert os.path.exists(info["out"])


def test_cli_info(capsys):
    assert main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "ventjax" in info and "devices" in info


def test_cohort_mixed_geometry_and_adaptive_pads(tmp_path):
    """A manifest mixing 64x64x8 and 128x128x16 studies completes with
    correct per-subject metrics via per-geometry sub-batches, and resume
    still works (VERDICT r1 item 3 / SURVEY §7 hard part 4)."""
    from ventjax.io.synthetic import write_study
    from ventjax.pipeline.cohort import run_cohort

    small = str(tmp_path / "small")
    big = str(tmp_path / "big")
    write_study(small, shape=(64, 64, 8), vox=(1.5, 1.5, 10.0), seed=6)
    write_study(big, shape=(128, 128, 16), vox=(2.0, 2.0, 11.5), seed=7)
    manifest = [
        {"id": "sm0", "xenon": f"{small}/xenon.dcm", "mask": f"{small}/mask"},
        {"id": "bg0", "xenon": f"{big}/xenon.dcm", "mask": f"{big}/mask"},
        {"id": "sm1", "xenon": f"{small}/xenon.dcm", "mask": f"{small}/mask"},
    ]
    out = str(tmp_path / "out")
    results = run_cohort(manifest, out, batch_size=2)
    by_id = {r["id"]: r for r in results}
    assert set(by_id) == {"sm0", "bg0", "sm1"}
    assert all(r["valid"] for r in results)
    # identical small studies agree exactly; geometries got separate batches
    assert by_id["sm0"]["VDP"] == by_id["sm1"]["VDP"]
    assert by_id["bg0"]["VDP"] != by_id["sm0"]["VDP"]
    # single-study run must match the cohort lane (pad/bucketing is inert)
    from ventjax.config import DEFAULT_CONFIG
    from ventjax.pipeline.analyze import make_analyze_fn
    from ventjax.io.dicom import open_single_dicom, open_dicom_folder
    import jax.numpy as jnp
    _, hp = open_single_dicom(f"{small}/xenon.dcm")
    _, mk = open_dicom_folder(f"{small}/mask")
    single = make_analyze_fn((1.5, 1.5, 10.0), (64, 64, 8), DEFAULT_CONFIG)
    r1 = single(jnp.asarray(np.asarray(hp, np.float32)),
                jnp.asarray(np.asarray(mk, np.float32)))
    assert by_id["sm0"]["VDP"] == pytest.approx(float(r1.metrics.vdp),
                                                abs=1e-4)
    # resume: a rerun loads everything from done-markers
    again = run_cohort(manifest, out, batch_size=2)
    assert {r["id"] for r in again} == {"sm0", "bg0", "sm1"}


def test_study_presets_have_substance():
    """Presets carry real per-IRB schemas and validate treatment/visit arms
    (VERDICT r1 item 10)."""
    from ventjax.config import preset
    from ventjax.report.export import study_filename

    genxe = preset("genxe")
    mepo = preset("mepo")
    clin = preset("clinical")
    assert genxe.id_field != mepo.id_field != clin.id_field
    assert set(genxe.treatments) == {"preAlbuterol", "postAlbuterol",
                                     "preSildenafil", "postSildenafil"}
    mepo.validate(treatment="preAlb", visit="2")
    with pytest.raises(ValueError):
        mepo.validate(visit="4")
    with pytest.raises(ValueError):
        clin.validate(treatment="albuterol")  # case matters: 'Albuterol'
    # each preset's arms produce the reference's filename grammar suffixes
    md = {"StudyDate": "20240301"}
    assert study_filename("genxe", md, genxe_id="1",
                          treatment="preSildenafil").endswith("_preSil")
    assert study_filename("mepo", md, mepo_id="9", visit="2",
                          treatment="postAlb").endswith("visit2_postAlb")
    assert study_filename("clinical", md, clinical_id="AB", visit="1",
                          treatment="Albuterol").endswith("_Albuterol")


def test_train_seg_and_auto_mask(tmp_path, capsys):
    """train-seg produces a checkpoint that analyze --auto-mask consumes:
    the full mask-free proton flow (VERDICT r1 item 8)."""
    from ventjax.io.synthetic import write_study

    study = str(tmp_path / "study")
    write_study(study, shape=(64, 64, 8), vox=(1.5, 1.5, 10.0), seed=9)
    ckpt = str(tmp_path / "ckpt")
    rc = main(["train-seg", "--out", ckpt, "--steps", "60", "--batch", "4",
               "--shape", "64", "64", "8", "--base", "8"])
    assert rc == 0
    train_info = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert train_info["final_loss"] < 0.6

    out = str(tmp_path / "out")
    rc = main([
        "analyze", "--xenon", f"{study}/xenon.dcm",
        "--proton", f"{study}/proton.dcm", "--auto-mask",
        "--seg-ckpt", ckpt, "--seg-base", "8",
        "--out", out, "--max-defect", "1024", "--no-ci",
        "--disease", "CF",
    ])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert np.isfinite(summary["VDP"]) and summary["LungVolume"] > 0
    # the Disease line reaches the report path (screenshot rendered)
    pngs = [f for f in os.listdir(out) if f.endswith(".png")]
    assert pngs


def test_compile_cache_populates_and_disables(tmp_path, monkeypatch):
    """enable_compile_cache writes compiled programs to the persistent
    cache dir (repeat CLI invocations skip the compile); VENTJAX_NO_CACHE
    disables it."""
    import jax
    import jax.numpy as jnp

    from ventjax.utils import profiling

    d = str(tmp_path / "xla")
    monkeypatch.delenv("VENTJAX_NO_CACHE", raising=False)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(profiling, "default_compile_cache_dir", lambda: d)
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )}
    try:
        assert profiling.enable_compile_cache() == d
        f = jax.jit(lambda x: x @ x.T + 2.0)
        np.asarray(f(jnp.ones((32, 32))))
        assert any("cache" in e for e in os.listdir(d))

        monkeypatch.setenv("VENTJAX_NO_CACHE", "1")
        monkeypatch.setattr(profiling, "default_compile_cache_dir",
                            lambda: str(tmp_path / "other"))
        assert profiling.enable_compile_cache() is None
        assert not os.path.exists(str(tmp_path / "other"))
    finally:
        # tmp_path is deleted after the test; leaving the global cache
        # config pointed there would leak into every later compile
        for k, v in saved.items():
            jax.config.update(k, v)
        from jax.experimental.compilation_cache import compilation_cache
        compilation_cache.reset_cache()


def test_compile_cache_honours_jax_env_var(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads the variable itself:
    enable_compile_cache reports it and sets no directory of its own."""
    import jax

    from ventjax.utils import profiling

    d = str(tmp_path / "from_env")
    monkeypatch.delenv("VENTJAX_NO_CACHE", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", d)
    before = jax.config.jax_compilation_cache_dir
    saved = {k: getattr(jax.config, k) for k in (
        "jax_persistent_cache_min_compile_time_secs",
        "jax_persistent_cache_min_entry_size_bytes",
    )}
    try:
        assert profiling.enable_compile_cache() == d
        assert jax.config.jax_compilation_cache_dir == before
        assert not os.path.exists(d)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def test_default_compile_cache_dir_is_fixed_in_checkout(tmp_path,
                                                        monkeypatch):
    """Without the env var the cache sits at one fixed path inside the
    checkout holding the package, whatever the working directory."""
    import ventjax
    from ventjax.utils import profiling

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("VENTJAX_NO_CACHE", raising=False)
    first = profiling.compile_cache_dir()
    monkeypatch.chdir(tmp_path)
    assert profiling.compile_cache_dir() == first
    root = os.path.dirname(os.path.dirname(os.path.abspath(ventjax.__file__)))
    assert first == os.path.join(root, ".jax_cache")


def test_enable_deterministic_sets_gpu_and_cpu_flags(monkeypatch):
    """--deterministic appends the GPU determinism flag (and CPU fast math
    off) to XLA_FLAGS once, keeping flags the user already set."""
    from ventjax.utils.profiling import enable_deterministic

    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8"
                       " --xla_cpu_enable_fast_math=true")
    enable_deterministic()
    enable_deterministic()
    flags = os.environ["XLA_FLAGS"].split()
    assert flags.count("--xla_gpu_deterministic_ops=true") == 1
    assert "--xla_force_host_platform_device_count=8" in flags
    # the user's own fast-math choice is not overridden or duplicated
    assert [f for f in flags if f.startswith("--xla_cpu_enable_fast_math")] \
        == ["--xla_cpu_enable_fast_math=true"]


def test_manifest_validation_errors(tmp_path):
    """A malformed manifest must fail with an actionable message at load
    time, not a KeyError deep inside the batched dispatch."""
    import json

    import pytest

    from ventjax.pipeline.cohort import load_manifest

    p = str(tmp_path / "m.json")

    json.dump({"id": "a"}, open(p, "w"))
    with pytest.raises(ValueError, match="JSON list"):
        load_manifest(p)

    json.dump([{"subject": "a", "xenon": "x", "mask": "m"}], open(p, "w"))
    with pytest.raises(ValueError, match="missing required key.*id"):
        load_manifest(p)

    json.dump([{"id": "a", "xenon": "x"}], open(p, "w"))
    with pytest.raises(ValueError, match="mask"):
        load_manifest(p)

    json.dump([{"id": "a", "xenon": "x", "mask": "m"},
               {"id": "a", "xenon": "y", "mask": "n"}], open(p, "w"))
    with pytest.raises(ValueError, match="duplicate"):
        load_manifest(p)

    good = [{"id": "a", "xenon": "x", "mask": "m"},
            {"id": "b", "xenon": "y", "mask": "n", "proton": "p"}]
    json.dump(good, open(p, "w"))
    assert load_manifest(p) == good


def test_manifest_id_must_be_string(tmp_path):
    import json

    import pytest

    from ventjax.pipeline.cohort import load_manifest

    p = str(tmp_path / "m.json")
    json.dump([{"id": 1, "xenon": "x", "mask": "m"}], open(p, "w"))
    with pytest.raises(ValueError, match="non-empty string"):
        load_manifest(p)
    json.dump([{"id": ["a"], "xenon": "x", "mask": "m"}], open(p, "w"))
    with pytest.raises(ValueError, match="non-empty string"):
        load_manifest(p)


def test_cli_export_regenerates_reports(study_root, tmp_path, capsys):
    """`ventjax export`: the GUI's Load-Pickle -> Export workflow
    (Vent_Analysis.py:919-941, 943-1013) over both artifact formats."""
    out = str(tmp_path / "a")
    rc = main([
        "analyze", "--xenon", f"{study_root}/xenon.dcm",
        "--mask", f"{study_root}/mask", "--out", out,
        "--max-defect", "1024", "--filename", "study", "--npz",
    ])
    assert rc == 0
    orig = json.loads(capsys.readouterr().out)

    # pickle round: everything regenerates (the pickle carries the DICOM ds)
    out2 = str(tmp_path / "from_pkl")
    rc = main(["export", "--pickle", os.path.join(out, "study.pkl"),
               "--out", out2])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["metrics"]["VDP"] == pytest.approx(orig["VDP"])
    assert rep["metrics"]["CI"] == pytest.approx(orig["CI"])
    assert rep["skipped"] == []
    files = set(os.listdir(out2))
    assert {"study.png", "study_dataArray.nii", "study.json", "study.pkl",
            "defectDICOMS"} <= files

    # NPZ round: no DICOM dataset inside -> header JSON + defect DICOMs are
    # reported skipped, array-backed exports regenerate with the same metrics
    out3 = str(tmp_path / "from_npz")
    rc = main(["export", "--npz-in", os.path.join(out, "study.npz"),
               "--out", out3])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["metrics"]["VDP"] == pytest.approx(orig["VDP"])
    assert len(rep["skipped"]) == 2
    files = set(os.listdir(out3))
    assert {"study.png", "study_dataArray.nii", "study.pkl"} <= files
    assert "study.json" not in files


def test_cli_export_recalculate_new_thresh(study_root, tmp_path, capsys):
    """--recalculate re-analyzes the stored arrays (no raw DICOMs needed):
    a higher mean-anchored threshold must grow the defect fraction.  The
    phantom's masked intensities are sharply bimodal (defects ~0, normal
    ~1x mean, noise sigma ~ mean/SNR), so the threshold only moves the
    defect set once it crosses the normal cluster — 1.1 does."""
    out = str(tmp_path / "a")
    rc = main([
        "analyze", "--xenon", f"{study_root}/xenon.dcm",
        "--mask", f"{study_root}/mask", "--out", out,
        "--max-defect", "1024", "--filename", "study", "--no-ci",
    ])
    assert rc == 0
    orig = json.loads(capsys.readouterr().out)

    out2 = str(tmp_path / "re")
    rc = main(["export", "--pickle", os.path.join(out, "study.pkl"),
               "--out", out2, "--recalculate", "--thresh", "1.1", "--no-ci"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["metrics"]["VDP"] > orig["VDP"]
    assert os.path.exists(os.path.join(out2, "study.png"))


def test_cli_export_from_cohort_slim_npz(study_root, tmp_path, capsys):
    """Cohort per-subject NPZs are slim (no mask_border, metadata=metrics);
    export recomputes the derived state and regenerates the reports."""
    manifest = [{"id": "s0", "xenon": f"{study_root}/xenon.dcm",
                 "mask": f"{study_root}/mask"}]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    out = str(tmp_path / "cohort")
    rc = main(["cohort", "--manifest", mpath, "--out", out,
               "--max-defect", "1024", "--npz"])
    assert rc == 0
    capsys.readouterr()
    metrics = json.load(open(os.path.join(out, "s0", "metrics.json")))

    out2 = str(tmp_path / "re")
    rc = main(["export", "--npz-in", os.path.join(out, "s0", "s0.npz"),
               "--out", out2, "--histogram"])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["metrics"]["VDP"] == pytest.approx(metrics["VDP"])
    assert os.path.exists(os.path.join(out2, "s0.png"))
    # slim metadata (= metrics dict, no PatientName) must not crash the
    # histogram title
    assert os.path.exists(os.path.join(out2, "s0_hist.png"))


def test_cli_export_missing_file_is_clean_error(tmp_path, capsys):
    rc = main(["export", "--npz-in", str(tmp_path / "nope.npz"),
               "--out", str(tmp_path / "o")])
    assert rc == 2
    assert "error:" in capsys.readouterr().err


def test_cli_export_rejects_bad_artifacts(tmp_path, capsys):
    bad = str(tmp_path / "not_an_artifact.npz")
    np.savez(bad, x=np.zeros(3))
    rc = main(["export", "--npz-in", bad, "--out", str(tmp_path / "o")])
    assert rc == 2
    assert "artifact" in capsys.readouterr().err


def test_cli_export_rejects_corrupt_pickle(tmp_path, capsys):
    """A bit-flipped (non-truncated) pickle raises pickle.UnpicklingError,
    which must take the friendly exit-2 path, not a raw traceback."""
    bad = str(tmp_path / "corrupt.pkl")
    with open(bad, "wb") as f:
        f.write(b"\x80\x04\xff\xff garbage that is not a pickle stream.")
    rc = main(["export", "--pickle", bad, "--out", str(tmp_path / "o")])
    assert rc == 2
    assert "error:" in capsys.readouterr().err


def test_cli_cohort_progress_events(study_root, tmp_path, capsys):
    manifest = [{"id": "s0", "xenon": f"{study_root}/xenon.dcm",
                 "mask": f"{study_root}/mask"}]
    mpath = str(tmp_path / "m.json")
    json.dump(manifest, open(mpath, "w"))
    rc = main(["cohort", "--manifest", mpath, "--out",
               str(tmp_path / "out"), "--max-defect", "1024", "--progress"])
    assert rc == 0
    err = capsys.readouterr().err
    events = [json.loads(l) for l in err.splitlines() if l.startswith("{")]
    stages = {e["stage"] for e in events}
    assert {"decode", "analyze", "export"} <= stages
    assert events[-1]["done"] == events[-1]["total"] == 1


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs fake devices")
def test_cli_analyze_shard_slices(tmp_path, capsys):
    """analyze --shard-slices N: the oversize-volume path is reachable
    without writing JAX, and its metrics match the unsharded run."""
    root = str(tmp_path / "deep_study")
    write_study(root, shape=(48, 48, 32), vox=(1.5, 1.5, 10.0), seed=9)
    base = ["analyze", "--xenon", f"{root}/xenon.dcm",
            "--mask", f"{root}/mask", "--max-defect", "1024"]
    rc = main(base + ["--out", str(tmp_path / "o1"), "--shard-slices", "2"])
    out1 = capsys.readouterr().out
    assert rc == 0
    rc = main(base + ["--out", str(tmp_path / "o2")])
    out2 = capsys.readouterr().out
    assert rc == 0
    m1 = json.loads(out1[out1.index("{"):])
    m2 = json.loads(out2[out2.index("{"):])
    assert m1["CI"] == m2["CI"]
    assert m1["VDP"] == m2["VDP"]


def test_cli_analyze_shard_slices_rejects_thin_volume(study_root, tmp_path,
                                                      capsys):
    """8-slice study, 2 shards, rmax-50 halo (8 slices): the actionable
    error surfaces as exit 2, not a traceback."""
    rc = main(["analyze", "--xenon", f"{study_root}/xenon.dcm",
               "--mask", f"{study_root}/mask", "--out", str(tmp_path / "o"),
               "--max-defect", "1024", "--shard-slices", "2"])
    assert rc == 2
    err = capsys.readouterr().err
    assert "halo" in err and ("too thin" in err or "at most" in err)


def test_cli_analyze_shard_slices_bad_value(study_root, tmp_path, capsys):
    rc = main(["analyze", "--xenon", f"{study_root}/xenon.dcm",
               "--mask", f"{study_root}/mask", "--out", str(tmp_path / "o"),
               "--shard-slices", "many"])
    assert rc == 2
    assert "integer or 'auto'" in capsys.readouterr().err
