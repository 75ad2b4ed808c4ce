"""Distributed tests on the fake 8-device CPU mesh (SURVEY.md §4 item 3)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ventjax.config import DEFAULT_CONFIG
from ventjax.dist import make_batch_mesh, shard_cohort_fn
from ventjax.io.phantom import make_cohort
from ventjax.pipeline import analyze_cohort
from ventjax.pipeline.analyze import build_geometry

CFG = DEFAULT_CONFIG.replace(
    ci_max_defect_voxels=256, ci_rmax=12, n4_fitting_levels=2, n4_max_iters=5
)
SHAPE = (32, 32, 8)
VOX = (1.5, 1.5, 10.0)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 fake devices")
def test_sharded_cohort_bit_identical_to_unsharded():
    geom = build_geometry(VOX, SHAPE, CFG)
    mesh = make_batch_mesh(8)
    cohort_fn = lambda h, m: analyze_cohort(h, m, geom, CFG)
    sharded = jax.jit(shard_cohort_fn(cohort_fn, mesh))
    hp, mask, _ = make_cohort(16, shape=SHAPE, vox=VOX, seed=0)
    rs = sharded(jnp.asarray(hp), jnp.asarray(mask))
    ru = jax.jit(cohort_fn)(jnp.asarray(hp), jnp.asarray(mask))
    assert np.array_equal(np.asarray(rs.ci_map), np.asarray(ru.ci_map))
    assert np.array_equal(np.asarray(rs.metrics.vdp), np.asarray(ru.metrics.vdp))
    # outputs actually sharded over the batch axis
    shard_devs = {s.device for s in rs.ci_map.addressable_shards}
    assert len(shard_devs) == 8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 fake devices")
def test_mesh_subset():
    mesh = make_batch_mesh(4)
    assert mesh.devices.shape == (4,)
    assert mesh.axis_names == ("batch",)


def test_spatial_sharded_pipeline_matches_unsharded():
    """The analysis pipeline under a ("batch","space") mesh with the volume
    H axis spatially sharded (sharding annotations; XLA inserts the
    collectives) matches the unsharded run (SURVEY §2.3 TP row)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ventjax.config import DEFAULT_CONFIG
    from ventjax.dist import make_batch_space_mesh, spatial_shard_fn
    from ventjax.io.phantom import make_cohort
    from ventjax.pipeline import analyze_cohort
    from ventjax.pipeline.analyze import build_geometry

    shape = (32, 32, 8)
    vox = (1.5, 1.5, 10.0)
    cfg = DEFAULT_CONFIG.replace(
        ci_max_defect_voxels=256, ci_rmax=12,
        n4_fitting_levels=2, n4_max_iters=10,
    )
    geom = build_geometry(vox, shape, cfg)
    hp, mask, _ = make_cohort(4, shape=shape, vox=vox, seed=12)
    hp = jnp.asarray(hp)
    mask = jnp.asarray(mask)

    fn = lambda h, m: analyze_cohort(h, m, geom, cfg)
    mesh = make_batch_space_mesh(2, 4)
    sharded = spatial_shard_fn(fn, mesh)
    res_s = sharded(hp, mask)
    res_u = jax.jit(fn)(hp, mask)
    np.testing.assert_allclose(
        np.asarray(res_s.metrics.vdp), np.asarray(res_u.metrics.vdp),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(res_s.ci_map), np.asarray(res_u.ci_map), atol=1e-6,
    )
    assert np.all(np.isfinite(np.asarray(res_s.metrics.vdp)))


# ---- Productized slice-sharded CI (ventjax.dist.halo product surface) ------

@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs fake devices")
def test_calculate_ci_sharded_pads_nondivisible_depth(rng):
    """D=28 over 8 shards (not divisible): the product surface pads the
    slice axis and stays bit-identical to the unsharded engine."""
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise,
    )

    H, W, D = 40, 36, 28
    defect = (rng.random((H, W, D)) > 0.985).astype(np.float32)
    defect[0:3, 0:3, 25:28] = 1   # cluster at the (padded) depth border
    defect[0, 0, 0] = 1
    # rmax 16 -> halo 3 slices: 8 shards of the padded 32-slice volume give
    # 4-slice shards, legal; rmax 50's 8-slice halo would need <=4 shards.
    geom = build_ci_pairwise_geometry(VOX, (H, W, D), 16, "wrap")
    ci_s, nsat_s, ovf_s = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=8, max_defect_voxels=2048,
    )
    ci_u, nsat_u, _ = calculate_ci_pairwise(jnp.asarray(defect), geom, 2048)
    assert not bool(ovf_s)
    assert ci_s.shape == (H, W, D)
    assert np.array_equal(np.asarray(ci_s), np.asarray(ci_u))
    assert int(nsat_s) == int(nsat_u)


def test_calculate_ci_sharded_rejects_ladder_geometry():
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci import build_ci_geometry

    geom = build_ci_geometry(VOX, (32, 32, 8), 12, "wrap")
    with pytest.raises(ValueError, match="pairwise engine"):
        calculate_ci_sharded(jnp.zeros((32, 32, 8)), geom, n_shards=2)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs fake devices")
def test_calculate_ci_sharded_rejects_too_many_shards():
    """Halo wider than a shard: the error must tell the user the usable
    shard count instead of asserting."""
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import build_ci_pairwise_geometry

    # vox (1.5,1.5,10): reach = floor(49.99/6.67)+1 = 8 slices of halo; 8
    # shards of an 8-slice volume give 1-slice shards -> reject.
    geom = build_ci_pairwise_geometry(VOX, (32, 32, 8), 50, "wrap")
    with pytest.raises(ValueError, match="too thin|at most"):
        calculate_ci_sharded(jnp.zeros((32, 32, 8)), geom, n_shards=8)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs fake devices")
def test_ci_module_shard_slices_config(rng):
    """compat CI.calculate_CI honors config.ci_shard_slices and matches the
    single-device result bit for bit."""
    from ventjax.compat import ci_module

    defect = np.zeros((40, 36, 16), np.float64)
    defect[5:12, 6:13, 2:5] = 1
    defect[20:28, 18:28, 9:13] = 1
    defect[0, 0, 0] = 1
    single = ci_module.calculate_CI(defect, vox=VOX, Rmax=16)
    sharded = ci_module.calculate_CI(
        defect, vox=VOX, Rmax=16,
        config=DEFAULT_CONFIG.replace(ci_shard_slices=4),
    )
    assert np.array_equal(sharded, single)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs fake devices")
def test_sharded_ci_two_phase_pallas_head_bit_equal(rng):
    """The per-shard two-phase engine with the head kernel forced
    (interpreted on CPU) stays bit-identical to the unsharded engine —
    the oversize-volume latency path exercises the same kernel as the
    single-chip severe-disease path."""
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise,
    )

    H, W, D = 40, 36, 28
    defect = (rng.random((H, W, D)) > 0.985).astype(np.float32)
    defect[10:16, 8:14, 10:16] = 1   # a cluster spanning a shard boundary
    defect[0, 0, 0] = 1
    geom = build_ci_pairwise_geometry(VOX, (H, W, D), 16, "wrap")
    # K=500 centers per shard and halo_pad=250/side: neither is a
    # multiple of the kernel's blocks, so its padding runs per shard.
    ci_s, nsat_s, ovf_s = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=4,
        max_defect_voxels=500, halo_pad=250, use_pallas=True,
        interpret=True,
    )
    ci_u, nsat_u, _ = calculate_ci_pairwise(jnp.asarray(defect), geom, 2048)
    assert not bool(ovf_s)
    assert np.array_equal(np.asarray(ci_s), np.asarray(ci_u))
    assert int(nsat_s) == int(nsat_u)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs fake devices")
def test_sharded_ci_tail_overflow_flags_not_silent(rng):
    """A tail budget too small for a dense cluster sets the overflow flag
    (saturated values, never silently wrong); an adequate budget restores
    bit-equality with the unsharded engine."""
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise,
    )

    H, W, D = 48, 48, 16
    defect = np.zeros((H, W, D), np.float32)
    # One dense ball: its core voxels stay >=50% defect past the 96 head
    # balls, so they all need tail lanes.
    ii, jj, kk = np.mgrid[:H, :W, :D]
    defect[((ii - 24) ** 2 + (jj - 24) ** 2 + ((kk - 8) * 6.7) ** 2) < 150] = 1
    geom = build_ci_pairwise_geometry(VOX, (H, W, D), 16, "wrap")
    n_def = int(defect.sum())
    assert 512 < n_def < 2048  # fits every center/witness budget below
    _, _, ovf_tiny = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=2,
        max_defect_voxels=4096, tail_k=8,
    )
    assert bool(ovf_tiny)
    ci_ok, _, ovf_ok = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=2,
        max_defect_voxels=4096, tail_k=4096,
    )
    assert not bool(ovf_ok)
    ci_u, _, ovf_u = calculate_ci_pairwise(
        jnp.asarray(defect), geom, 4096, tail_k=4096
    )
    assert not bool(ovf_u)
    assert np.array_equal(np.asarray(ci_ok), np.asarray(ci_u))


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs fake devices")
def test_ci_module_severe_disease_exactness_retry():
    """compat calculate_CI silently saturates nothing: when the default
    tail budget overflows on a severe-disease volume it retries with the
    full-width tail, sharded and unsharded alike, and both match the
    gather-ladder engine (which has no tail to overflow)."""
    from ventjax.compat import ci_module
    from ventjax.ops.ci import build_ci_geometry, calculate_ci

    H, W, D = 48, 48, 16
    defect = np.zeros((H, W, D), np.float64)
    ii, jj, kk = np.mgrid[:H, :W, :D]
    defect[((ii - 24) ** 2 + (jj - 24) ** 2 + ((kk - 8) * 6.7) ** 2) < 150] = 1
    single = ci_module.calculate_CI(defect, vox=VOX, Rmax=16)
    sharded = ci_module.calculate_CI(
        defect, vox=VOX, Rmax=16,
        config=DEFAULT_CONFIG.replace(ci_shard_slices=4),
    )
    ladder_geom = build_ci_geometry(VOX, (H, W, D), 16, "wrap")
    ladder, _, _ = calculate_ci(
        jnp.asarray(defect.astype(np.float32)), ladder_geom,
        max_defect_voxels=2048,
    )
    assert np.array_equal(sharded, single)
    np.testing.assert_allclose(single, np.asarray(ladder), atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs fake devices")
def test_sharded_ci_halo_buffer_overflow_flags(rng):
    """Boundary defects beyond the sparse-exchange halo_pad buffer are
    never silently dropped: the overflow flag fires; an adequate buffer
    restores bit-equality with the unsharded engine."""
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise,
    )

    H, W, D = 40, 36, 16
    defect = np.zeros((H, W, D), np.float32)
    defect[4:20, 4:20, 7:9] = 1   # 512 voxels straddling the 2-shard cut
    geom = build_ci_pairwise_geometry(VOX, (H, W, D), 16, "wrap")
    _, _, ovf_tiny = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=2,
        max_defect_voxels=1024, halo_pad=16,
    )
    assert bool(ovf_tiny)
    ci_ok, _, ovf_ok = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=2,
        max_defect_voxels=1024, halo_pad=512, tail_k=1024,
    )
    assert not bool(ovf_ok)
    ci_u, _, ovf_u = calculate_ci_pairwise(
        jnp.asarray(defect), geom, 1024, tail_k=1024
    )
    assert not bool(ovf_u)
    assert np.array_equal(np.asarray(ci_ok), np.asarray(ci_u))


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs fake devices")
def test_sharded_ci_edge_face_clusters_do_not_flag(rng):
    """Boundary buffers nobody receives must not flag: the last shard's
    top buffer and shard 0's bottom buffer have no ppermute destination,
    so defects clustered on the volume's global z-faces — however many —
    are not an overflow, and results stay bit-equal."""
    from ventjax.dist import calculate_ci_sharded
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise,
    )

    H, W, D = 40, 36, 16
    defect = np.zeros((H, W, D), np.float32)
    defect[4:24, 4:24, 0:2] = 1     # 800 voxels on the global bottom face
    defect[10:26, 10:26, 14:16] = 1  # 512 voxels on the global top face
    geom = build_ci_pairwise_geometry(VOX, (H, W, D), 16, "wrap")
    # halo_pad=64 << either face cluster; hz=3 so the bands sit inside the
    # unsent buffers (bottom of shard 0, top of shard 1) only.
    ci_s, _, ovf = calculate_ci_sharded(
        jnp.asarray(defect), geom, n_shards=2,
        max_defect_voxels=2048, halo_pad=64, tail_k=2048,
    )
    assert not bool(ovf)
    ci_u, _, _ = calculate_ci_pairwise(
        jnp.asarray(defect), geom, 2048, tail_k=2048
    )
    assert np.array_equal(np.asarray(ci_s), np.asarray(ci_u))


@pytest.mark.skipif(len(jax.devices()) < 2, reason="needs fake devices")
def test_ci_module_sharded_halo_overflow_retry(rng):
    """compat calculate_CI's exactness retry must also grow the halo
    buffer: a defect band hugging the shard cut overflows the default
    halo_pad (k//2), and the sharded facade result must still equal the
    single-device facade result bit for bit."""
    from ventjax.compat import ci_module

    H, W, D = 40, 36, 16
    defect = np.zeros((H, W, D), np.float64)
    # dl=8, hz=3 at Rmax 16: k in {5,6,7} is shard 0's SENT top band.
    defect[2:34, 2:22, 5:8] = 1   # 1920 voxels; bucket k=2048, HP=1024
    single = ci_module.calculate_CI(defect, vox=VOX, Rmax=16)
    sharded = ci_module.calculate_CI(
        defect, vox=VOX, Rmax=16,
        config=DEFAULT_CONFIG.replace(ci_shard_slices=2),
    )
    assert np.array_equal(sharded, single)
