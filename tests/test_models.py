"""Segmentation model, wavelet denoise, halo-sharded CI, profiling utils."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ventjax.io.phantom import make_cohort


def test_unet_train_step_learns():
    from ventjax.models import create_train_state, predict_mask, train_step

    hp, mask, proton = make_cohort(4, shape=(32, 32, 4), seed=0)
    model, tx, state = create_train_state(
        jax.random.PRNGKey(0), shape=(32, 32), base=4, learning_rate=3e-3
    )
    proton_j = jnp.asarray(proton)
    mask_j = jnp.asarray(mask)
    step = jax.jit(lambda s: train_step(model, tx, s, proton_j, mask_j))
    losses = []
    for _ in range(80):
        state, loss = step(state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.3
    pred = predict_mask(model, state.params, jnp.asarray(proton[0]))
    assert pred.shape == proton[0].shape
    # phantom lungs are dark on proton; the net should overfit these quickly
    dice = 2 * (pred * mask[0]).sum() / (pred.sum() + mask[0].sum() + 1)
    assert dice > 0.8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 fake devices")
def test_unet_sharded_train_step():
    from jax.sharding import Mesh
    from ventjax.models import create_train_state
    from ventjax.models.segmentation import make_sharded_train_step

    hp, mask, proton = make_cohort(4, shape=(32, 32, 4), seed=0)
    model, tx, state = create_train_state(
        jax.random.PRNGKey(0), shape=(32, 32), base=4
    )
    mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), ("batch", "space"))
    step = make_sharded_train_step(model, tx, mesh)
    new_state, loss = step(state, jnp.asarray(proton), jnp.asarray(mask))
    assert np.isfinite(float(loss))
    assert int(new_state.step) == 1


def test_haar_roundtrip(rng):
    from ventjax.ops.wavelet import haar_dwt2, haar_idwt2

    x = jnp.asarray(rng.random((3, 16, 16)).astype(np.float32))
    ca, details = haar_dwt2(x)
    back = haar_idwt2(ca, details)
    assert np.allclose(np.asarray(back), np.asarray(x), atol=1e-6)


def test_wavelet_denoise_reduces_noise(rng):
    from ventjax.ops.wavelet import denoise_volume

    clean = np.zeros((32, 32, 2), np.float32)
    clean[8:24, 8:24, :] = 1.0
    noisy = clean + rng.normal(0, 0.1, clean.shape).astype(np.float32)
    den = np.asarray(denoise_volume(jnp.asarray(noisy), threshold=0.25))
    assert np.mean((den - clean) ** 2) < np.mean((noisy - clean) ** 2)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs fake devices")
def test_halo_sliced_ci_matches_unsharded(rng):
    from jax.sharding import Mesh
    from ventjax.dist.halo import make_sliced_ci_fn
    from ventjax.ops.ci_pairwise import (
        build_ci_pairwise_geometry, calculate_ci_pairwise,
    )

    H, W, D = 48, 40, 32
    defect = (rng.random((H, W, D)) > 0.99).astype(np.float32)
    defect[0:4, 0:4, 0:4] = 1  # border cluster exercises wrap aliasing
    geom = build_ci_pairwise_geometry((1.5, 1.5, 10.0), (H, W, D), 50, "wrap")
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("space",))
    fn = make_sliced_ci_fn(geom, mesh, max_defect_per_shard=1024,
                           halo_pad=512)
    ci_s, nsat_s, ovf_s = fn(jnp.asarray(defect))
    ci_u, nsat_u, _ = calculate_ci_pairwise(jnp.asarray(defect), geom, 2048)
    assert not bool(ovf_s)
    assert np.array_equal(np.asarray(ci_s), np.asarray(ci_u))
    assert int(nsat_s) == int(nsat_u)


def test_orbax_checkpoint_roundtrip(tmp_path):
    from ventjax.models import (create_train_state, load_checkpoint,
                                save_checkpoint)

    _, _, state = create_train_state(jax.random.PRNGKey(0), shape=(16, 16),
                                     base=2)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, state)
    back = load_checkpoint(path)
    flat_a = jax.tree_util.tree_leaves(state.params)
    flat_b = jax.tree_util.tree_leaves(back.params)
    assert all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(flat_a, flat_b))
    assert int(back.step) == int(state.step)


def test_profiling_utils():
    from ventjax.utils.profiling import stage, timed

    out = []
    with timed("x", sink=out.append):
        with stage("stage1"):
            y = jnp.ones((8, 8)) * 2
        jax.block_until_ready(y)
    assert len(out) == 1 and "x:" in out[0]
