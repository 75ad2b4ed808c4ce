"""Fused pipeline end-to-end vs the oracle chain, batching, error isolation."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ventjax import oracle
from ventjax.config import DEFAULT_CONFIG
from ventjax.io.phantom import make_cohort, make_phantom
from ventjax.oracle.ci_oracle import calculate_ci_oracle, subject_ci
from ventjax.pipeline import make_analyze_fn

CFG = DEFAULT_CONFIG.replace(ci_max_defect_voxels=1024)
SHAPE = (64, 64, 8)
VOX = (1.5, 1.5, 10.0)


@pytest.fixture(scope="module")
def result_and_oracle():
    ph = make_phantom(shape=SHAPE, vox=VOX, seed=5)
    fn = make_analyze_fn(VOX, SHAPE, CFG)
    res = fn(jnp.asarray(ph.hp), jnp.asarray(ph.mask))
    n4_or = oracle.n4_bias_correction_oracle(ph.hp, ph.mask)
    return ph, res, n4_or


def test_pipeline_vdp_within_budget(result_and_oracle):
    """The driver's fidelity gate: |dVDP| < 0.1pp device-vs-oracle, e2e."""
    ph, res, n4_or = result_and_oracle
    _, vdp_or = oracle.vdp_mean_anchored(n4_or, ph.mask)
    _, vdp_lb_or = oracle.vdp_linear_binning(n4_or, ph.mask)
    assert abs(float(res.metrics.vdp) - vdp_or) < 0.1
    assert abs(float(res.metrics.vdp_lb) - vdp_lb_or) < 0.1


def test_pipeline_ci_matches_oracle_chain(result_and_oracle):
    """CI map computed from the device defect array matches the oracle CI of
    that same defect array voxel-wise."""
    ph, res, _ = result_and_oracle
    defect = np.asarray(res.defect)
    want = calculate_ci_oracle(defect, vox=VOX, rmax=50, saturate=True)
    assert np.abs(np.asarray(res.ci_map) - want).max() < 2e-5
    assert float(res.metrics.ci) == pytest.approx(
        subject_ci(want, defect), abs=2e-5
    )


def test_pipeline_volumes(result_and_oracle):
    ph, res, _ = result_and_oracle
    want_lv = oracle.reference.lung_volume_liters(ph.mask, VOX)
    assert float(res.metrics.lung_volume) == pytest.approx(want_lv, rel=1e-6)
    assert float(res.metrics.snr) == pytest.approx(
        oracle.calculate_snr(ph.hp, ph.mask), rel=1e-4
    )
    assert bool(res.metrics.valid)
    d = res.metrics.as_dict()
    assert set(d) >= {"SNR", "VDP", "VDP_lb", "VDP_km", "LungVolume",
                      "DefectVolume", "CI"}


def test_pipeline_batch_lane_equals_single():
    hp, mask, _ = make_cohort(3, shape=SHAPE, vox=VOX, seed=11)
    single = make_analyze_fn(VOX, SHAPE, CFG)
    batched = make_analyze_fn(VOX, SHAPE, CFG, batched=True)
    rb = batched(jnp.asarray(hp), jnp.asarray(mask))
    r1 = single(jnp.asarray(hp[1]), jnp.asarray(mask[1]))
    assert np.array_equal(np.asarray(rb.ci_map[1]), np.asarray(r1.ci_map))
    assert float(rb.metrics.vdp[1]) == float(r1.metrics.vdp)


def test_pipeline_grouped_cohort_bitwise_equals_vmap():
    """analyze_cohort_grouped (lax.map over 4-lane groups) is bitwise the
    plain vmapped cohort — lanes are computationally independent, grouping
    only changes while_loop trip counts for already-frozen lanes."""
    from ventjax.pipeline import analyze_cohort, analyze_cohort_grouped
    from ventjax.pipeline.analyze import build_geometry

    hp, mask, _ = make_cohort(8, shape=SHAPE, vox=VOX, seed=13)
    geom = build_geometry(VOX, SHAPE, CFG)
    plain = jax.jit(lambda h, m: analyze_cohort(h, m, geom, CFG))(
        jnp.asarray(hp), jnp.asarray(mask))
    grouped = jax.jit(
        lambda h, m: analyze_cohort_grouped(h, m, geom, CFG, group_size=4)
    )(jnp.asarray(hp), jnp.asarray(mask))
    for a, b in zip(jax.tree_util.tree_leaves(plain),
                    jax.tree_util.tree_leaves(grouped)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pipeline_empty_mask_isolated():
    """A subject with an empty mask yields NaN metrics + valid=False without
    poisoning the other lanes (SURVEY.md §5 failure detection)."""
    hp, mask, _ = make_cohort(3, shape=SHAPE, vox=VOX, seed=2)
    mask[1] = 0.0
    batched = make_analyze_fn(VOX, SHAPE, CFG, batched=True)
    res = batched(jnp.asarray(hp), jnp.asarray(mask))
    valid = np.asarray(res.metrics.valid)
    vdp = np.asarray(res.metrics.vdp)
    assert list(valid) == [True, False, True]
    assert np.isnan(vdp[1]) and np.isfinite(vdp[0]) and np.isfinite(vdp[2])


def test_pipeline_under_debug_checks():
    """The pipeline runs clean under jax debug_nans/debug_infs interception
    (SURVEY.md §5 sanitizers): no hidden NaN/Inf on the healthy path."""
    import jax
    from ventjax.utils.profiling import enable_debug_checks

    hp, mask, _ = make_cohort(1, shape=SHAPE, vox=VOX, seed=4)
    enable_debug_checks()
    try:
        fn = make_analyze_fn(VOX, SHAPE, CFG)
        res = fn(jnp.asarray(hp[0]), jnp.asarray(mask[0]))
        assert np.isfinite(float(res.metrics.vdp))
    finally:
        jax.config.update("jax_debug_nans", False)
        jax.config.update("jax_debug_infs", False)


def test_cohort_export_pack_densifies_bitwise():
    """The cohort runner's narrowed export pack (uint8 defect + <=K
    compacted CI values) must rebuild the dense defect/CI maps
    bit-identically to the full VentResult (round-4 transfer cut)."""
    from ventjax.pipeline.analyze import analyze_cohort, build_geometry
    from ventjax.pipeline.cohort import _GeometryRunner, _densify_ci

    shape, vox = (32, 32, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=512, ci_rmax=12, n4_fitting_levels=2,
        n4_max_iters=5,
    )
    hp, mask, _ = make_cohort(4, shape=shape, vox=vox, seed=21)
    runner = _GeometryRunner(shape, vox, cfg, mesh=None, batch_size=4)
    pack = runner._fn(512, 8192)(jnp.asarray(hp), jnp.asarray(mask))

    geom = build_geometry(vox, shape, cfg.replace(n4_mask_pad=8192))
    res = jax.jit(lambda h, m: analyze_cohort(
        h, m, geom, cfg.replace(n4_mask_pad=8192)))(
        jnp.asarray(hp), jnp.asarray(mask))

    assert pack["defect"].dtype == jnp.uint8
    for lane in range(4):
        lane_pack = jax.tree_util.tree_map(lambda x: np.asarray(x[lane]),
                                           pack)
        ci = _densify_ci(lane_pack)
        assert np.array_equal(ci, np.asarray(res.ci_map[lane]))
        assert np.array_equal(lane_pack["defect"].astype(np.float32),
                              np.asarray(res.defect[lane]))
        assert np.array_equal(np.asarray(lane_pack["n4"]),
                              np.asarray(res.n4[lane]))


def test_cohort_compact_pack_rebuilds_dense_channels():
    """The round-5 compact transfer (n4 masked values + lattice vector,
    defect as compaction indices) must rebuild: defect and CI channels
    bit-identically, n4 bit-identically at every masked voxel (the only
    voxels any metric reads), and the out-of-mask n4 background to ~1e-6
    relative (host float64 lattice evaluation vs the device's float32
    einsum)."""
    from ventjax.pipeline.analyze import analyze_cohort, build_geometry
    from ventjax.pipeline.cohort import (
        _GeometryRunner, _densify_ci, _rebuild_compact_pack,
    )

    shape, vox = (32, 32, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=512, ci_rmax=12, n4_fitting_levels=2,
        n4_max_iters=5,
    )
    hp, mask, _ = make_cohort(4, shape=shape, vox=vox, seed=21)
    mask[3] = 0.0  # invalid lane: rebuild must not crash, metrics NaN
    runner = _GeometryRunner(shape, vox, cfg, mesh=None, batch_size=4)
    from ventjax.pipeline.cohort import _decode_host_pack

    raw = runner._fn(512, 8192, compact=True)(
        jnp.asarray(hp), jnp.asarray(mask))
    # the compact pack is exactly ONE device array (metrics vector +
    # data lanes in one blob: one device->host transfer per batch)
    assert sorted(raw) == ["blob"]
    host = _decode_host_pack(
        jax.tree_util.tree_map(np.asarray, raw),
        runner.blob_schema(512, 8192))
    assert sorted(host) == ["ci_cv", "cidx", "metrics", "n4_cv", "n_def",
                            "phi"]

    cfg8 = cfg.replace(n4_mask_pad=8192)
    geom = build_geometry(vox, shape, cfg8)
    res = jax.jit(lambda h, m: analyze_cohort(h, m, geom, cfg8))(
        jnp.asarray(hp), jnp.asarray(mask))
    for lane in range(3):
        lp = jax.tree_util.tree_map(lambda x: x[lane], host)
        rb = _rebuild_compact_pack(lp, hp[lane], mask[lane], cfg8)
        assert np.array_equal(_densify_ci(rb), np.asarray(res.ci_map[lane]))
        assert np.array_equal(rb["defect"].astype(np.float32),
                              np.asarray(res.defect[lane]))
        m = mask[lane].reshape(-1) > 0
        got, want = rb["n4"].reshape(-1), np.asarray(res.n4[lane]).reshape(-1)
        np.testing.assert_array_equal(got[m], want[m])
        rel = np.abs(got[~m] - want[~m]) / np.maximum(np.abs(want[~m]), 1e-6)
        assert rel.max() < 1e-5
    # Invalid lane (empty mask): the device computed on the safe ones-mask,
    # whose garbage defect overflows the K=512 pad — the rebuild carries the
    # device's own flagged first-K truncation (cidx is shipped, not derived
    # from the host mask); n4 has no masked voxels to overwrite, so it is
    # purely host-regenerated.  Metrics are NaN/valid=False either way.
    lp = jax.tree_util.tree_map(lambda x: x[3], host)
    rb = _rebuild_compact_pack(lp, hp[3], mask[3], cfg8)
    assert bool(np.asarray(host["metrics"].ci_overflow)[3])
    got_idx = np.flatnonzero(rb["defect"].reshape(-1))
    dev_idx = np.flatnonzero(np.asarray(res.defect[3]).reshape(-1))
    np.testing.assert_array_equal(got_idx, dev_idx[:512])
    assert np.isnan(float(np.asarray(res.metrics.vdp)[3]))


def test_compact_blob_carries_subnormal_int32_lanes_bit_exactly():
    """The blob bitcasts int32 index lanes into f32: every index below 2^23
    is an f32 subnormal bit pattern, so a path that flushed subnormals
    would zero them.  The decoded indices and counts must equal the
    defect voxels' flat indices exactly."""
    from ventjax.pipeline.cohort import _GeometryRunner, _decode_host_pack

    shape, vox = (32, 32, 8), (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=512, ci_rmax=12, n4_fitting_levels=1,
        n4_max_iters=2,
    )
    hp, mask, _ = make_cohort(2, shape=shape, vox=vox, seed=5)
    runner = _GeometryRunner(shape, vox, cfg, mesh=None, batch_size=2)
    raw = runner._fn(512, 8192, compact=True)(
        jnp.asarray(hp), jnp.asarray(mask))
    blob = np.asarray(raw["blob"])
    host = _decode_host_pack({"blob": blob}, runner.blob_schema(512, 8192))
    off = sum(w for name, w, _ in runner.blob_schema(512, 8192)
              if name not in ("cidx", "n_def"))
    geom_fn = runner._fn(512, 8192, compact=False)
    dense = geom_fn(jnp.asarray(hp), jnp.asarray(mask))
    for lane in range(2):
        want = np.flatnonzero(np.asarray(dense["defect"][lane]).reshape(-1))
        n = int(host["n_def"][lane])
        assert n == len(want) > 0
        np.testing.assert_array_equal(host["cidx"][lane][:n], want)
        lanes = blob[lane, off:off + n]
        tiny = np.finfo(np.float32).tiny
        nz = lanes[want > 0]
        assert (np.abs(nz) < tiny).all() and (nz != 0).all()


def test_cohort_compact_and_dense_exports_agree(tmp_path):
    """run_cohort(compact_export=True) writes the same NIfTI defect/CI
    channels and metrics as the dense transfer, and the same n4 channel at
    every masked voxel.

    (The masked-n4 bitwise claim compares two separately-jitted programs —
    exact on this CPU backend where both compile to the same f32 schedule;
    the portable guarantee is bit-exactness vs the SAME program's dense
    channel, pinned by test_cohort_compact_pack_rebuilds_dense_channels
    and on the GPU by chip_smoke.py's fidelity phase.  Differently-
    partitioned programs can reassociate the field einsum at ~1e-5 —
    see __graft_entry__ section 5.)"""
    from ventjax.io.nifti import load as nifti_load
    from ventjax.io.synthetic import write_study
    from ventjax.pipeline.cohort import run_cohort

    shape = (32, 32, 8)
    cfg = DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=512, ci_rmax=16, n4_fitting_levels=2,
        n4_max_iters=5,
    )
    # Two geometries: the flagship voxel size (pairwise CI engine) and
    # (3.125, 3.125, 15) — a geometry whose float32 exactness proof fails
    # at this rmax, forcing the gather-ladder engine — so the compact pack
    # is validated on BOTH engine paths through the real driver.
    from ventjax.ops.ci_pairwise import CIPairwiseGeometry
    from ventjax.pipeline.analyze import build_geometry

    assert isinstance(
        build_geometry((1.5, 1.5, 10.0), shape, cfg), CIPairwiseGeometry)
    assert not isinstance(
        build_geometry((3.125, 3.125, 15.0), shape, cfg),
        CIPairwiseGeometry), "ladder-forcing geometry stopped forcing"
    manifest = []
    for i, vox in ((0, (1.5, 1.5, 10.0)), (1, (3.125, 3.125, 15.0))):
        root = str(tmp_path / f"s{i}")
        write_study(root, shape=shape, vox=vox, seed=40 + i,
                    with_proton=False)
        manifest.append({"id": f"s{i}", "xenon": f"{root}/xenon.dcm",
                         "mask": f"{root}/mask"})
    rc = run_cohort(manifest, str(tmp_path / "compact"), config=cfg,
                    use_mesh=False, compact_export=True)
    rd = run_cohort(manifest, str(tmp_path / "dense"), config=cfg,
                    use_mesh=False, compact_export=False)
    assert len(rc) == len(rd) == 2
    for mc, md in zip(sorted(rc, key=lambda r: r["id"]),
                      sorted(rd, key=lambda r: r["id"])):
        assert set(mc) == set(md)
        for k in mc:  # identical metrics (NaN-aware: NaN == NaN here)
            a, b = mc[k], md[k]
            if isinstance(a, float) and np.isnan(a):
                assert np.isnan(b), k
            else:
                assert a == b, k
        sid = mc["id"]
        ac, _ = nifti_load(str(tmp_path / "compact" / sid /
                               f"{sid}_dataArray.nii"))
        ad, _ = nifti_load(str(tmp_path / "dense" / sid /
                               f"{sid}_dataArray.nii"))
        # channels: 0 proton, 1 hp, 2 mask, 3 n4, 4 defect, 5 ci
        for ch in (0, 1, 2, 4, 5):
            np.testing.assert_array_equal(ac[..., ch], ad[..., ch])
        m = ad[..., 2] > 0
        np.testing.assert_array_equal(ac[..., 3][m], ad[..., 3][m])
        assert np.allclose(ac[..., 3], ad[..., 3], rtol=1e-5, atol=1e-5)


def test_densify_ci_truncates_overflow_lane_like_device():
    """A lane whose defect count exceeds the pad rebuilds exactly the
    device's own first-K truncation (flagged upstream, never silent)."""
    from ventjax.pipeline.cohort import _densify_ci

    defect = np.zeros((4, 4, 4), np.uint8)
    defect.reshape(-1)[:10] = 1  # 10 defect voxels
    cv = np.arange(1, 7, dtype=np.float32)  # pad K=6 < 10
    ci = _densify_ci({"defect": defect, "ci_cv": cv, "n_def": 10})
    flat = ci.reshape(-1)
    assert np.array_equal(flat[:6], cv)
    assert not flat[6:].any()
