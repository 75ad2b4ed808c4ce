"""Device N4 vs the NumPy oracle and bias-recovery behavior."""
import numpy as np
import pytest
import jax.numpy as jnp

from ventjax import oracle
from ventjax.ops import n4_bias_correction, vdp_mean_anchored, vdp_linear_binning


@pytest.fixture(scope="module")
def n4_both(phantom_small):
    ph = phantom_small
    dev = np.asarray(n4_bias_correction(jnp.asarray(ph.hp), jnp.asarray(ph.mask)))
    orc = oracle.n4_bias_correction_oracle(ph.hp, ph.mask)
    return dev, orc, ph


def test_n4_close_to_oracle(n4_both):
    dev, orc, ph = n4_both
    m = ph.mask > 0
    rel = np.abs(dev[m] - orc[m]) / np.abs(orc[m])
    # float32 device vs float64 oracle; convergence paths may differ by an
    # iteration — demand sub-percent agreement inside the mask.
    assert rel.max() < 0.01
    assert rel.mean() < 2e-3


def test_n4_downstream_vdp_within_budget(n4_both):
    """The driver fidelity metric: |dVDP| < 0.1pp end to end."""
    dev, orc, ph = n4_both
    mask = jnp.asarray(ph.mask)
    _, v_dev = vdp_mean_anchored(jnp.asarray(dev), mask)
    _, v_or = oracle.vdp_mean_anchored(orc, ph.mask)
    assert abs(float(v_dev) - v_or) < 0.1

    _, lb_dev = vdp_linear_binning(jnp.asarray(dev), mask)
    _, lb_or = oracle.vdp_linear_binning(orc, ph.mask)
    assert abs(float(lb_dev) - lb_or) < 0.1


def test_n4_removes_planted_bias_device(phantom_small):
    ph = phantom_small
    corrected, field = n4_bias_correction(
        jnp.asarray(ph.hp), jnp.asarray(ph.mask), return_field=True
    )
    field = np.asarray(field)
    m = ph.mask > 0
    tb = np.log(ph.true_bias)[m]
    tb = tb - tb.mean()
    eb = field[m] - field[m].mean()
    assert np.corrcoef(tb, eb)[0, 1] > 0.85


def test_n4_mask_pad_overflow_flagged(phantom_small):
    ph = phantom_small
    _, ovf = n4_bias_correction(
        jnp.asarray(ph.hp), jnp.asarray(ph.mask),
        mask_pad=64, return_overflow=True,
    )
    assert bool(ovf)
    _, ok = n4_bias_correction(
        jnp.asarray(ph.hp), jnp.asarray(ph.mask),
        mask_pad=16384, return_overflow=True,
    )
    assert not bool(ok)


def test_n4_identity_on_unbiased_flat_image(rng):
    """A flat image has no bias: the field should be ~constant."""
    img = np.full((32, 32, 4), 100.0, np.float32)
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    mask = np.zeros_like(img)
    mask[8:24, 8:24, 1:3] = 1
    _, field = n4_bias_correction(jnp.asarray(img), jnp.asarray(mask), return_field=True)
    field = np.asarray(field)
    m = mask > 0
    assert field[m].std() < 1e-3
