"""CI head kernel (ventjax/ops/ci_pallas.py): bit-equality with the XLA head.

The kernel computes the same f32 expressions as ci_pairwise's head blocks
and counts exact integers, so results must be BIT-equal, wrap and pad
border modes alike.  On the CPU the kernel runs in the Pallas interpreter
(``interpret=True``); on the GPU it is compiled through Triton and checked
by chip_smoke.py.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ventjax.ops import ci_pairwise as cp
from ventjax.ops.ci_pairwise import (
    build_ci_pairwise_geometry, calculate_ci_pairwise,
)

SHAPE = (32, 32, 8)


def _defect(kind):
    d = np.zeros(SHAPE, np.float32)
    if kind == "clustered":
        rng = np.random.default_rng(3)
        d = (rng.random(SHAPE) > 0.985).astype(np.float32)
        d[8:14, 8:14, 2:5] = 1.0
    elif kind == "full":
        d[:] = 1.0
    elif kind == "corner":
        # touches every border, so the wrap aliases carry the counts
        d[:4, :4, :2] = 1.0
        d[-3:, -3:, -2:] = 1.0
        d[0, -1, 0] = d[-1, 0, -1] = 1.0
    return d


@pytest.mark.parametrize("kind", ["clustered", "empty", "full", "corner"])
@pytest.mark.parametrize("K", [256, 250])
@pytest.mark.parametrize("border", ["wrap", "pad"])
def test_head_kernel_bit_equal(border, K, kind):
    """K=250 is not a multiple of the kernel's center or witness blocks;
    "full" overflows the pad, so sentinel and real lanes mix."""
    geom = build_ci_pairwise_geometry((1.5, 1.5, 10.0), SHAPE, 12, border)
    d = jnp.asarray(_defect(kind))
    ci_x, sat_x, ovf_x = calculate_ci_pairwise(d, geom, K, use_pallas=False)
    ci_p, sat_p, ovf_p = calculate_ci_pairwise(
        d, geom, K, use_pallas=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(ci_x), np.asarray(ci_p))
    assert int(sat_x) == int(sat_p)
    assert bool(ovf_x) == bool(ovf_p)
    if kind == "empty":
        assert float(jnp.sum(ci_p)) == 0.0


def test_head_kernel_first_fail_matches_xla_head_rows():
    """The kernel's per-row output (first failing head ball, ns = none)
    against the XLA head's (resolved, argmax) on witness sets that differ
    from the centers, as in the slice-sharded engine."""
    from ventjax.ops.ci_pallas import head_first_fail_pallas

    geom = build_ci_pairwise_geometry((1.5, 1.5, 10.0), SHAPE, 12, "wrap")
    idx = np.flatnonzero(_defect("clustered"))
    H, W, D = SHAPE
    c = tuple(jnp.asarray(a.astype(np.int32)) for a in (
        idx // (W * D), (idx // D) % W, idx % D))
    w = tuple(jnp.concatenate([a, a[:37] + 1]) for a in c)
    ns = min(96, geom.n_balls - 1)
    first = head_first_fail_pallas(
        *c, *w, combos=tuple(cp._alias_combos(geom)), scale=geom.scale,
        r2=tuple(float(r) for r in geom.r2_32[:ns]),
        t_head=tuple(int(t) for t in ((geom.rows_ball + 1) // 2)[:ns]),
        rmax=geom.rmax, interpret=True)
    dmin2 = np.asarray(cp._alias_min_d2(c, w, geom))
    counts = (dmin2[:, :, None] <= geom.r2_32[None, None, :ns]).sum(1)
    fail = counts < ((geom.rows_ball + 1) // 2)[None, :ns]
    want = np.where(fail.any(1), fail.argmax(1), ns)
    np.testing.assert_array_equal(np.asarray(first), want)


def test_auto_mode_never_picks_the_kernel_on_cpu(monkeypatch):
    """Auto mode keys on the GPU backend: on the CPU it takes the XLA head
    even past HEAD_KERNEL_MIN_K, so the kernel (which has no CPU lowering
    outside the interpreter) is never reached."""
    import ventjax.ops.ci_pallas as kernel_mod

    def boom(*a, **k):
        raise AssertionError("kernel selected on the CPU")

    monkeypatch.setattr(kernel_mod, "head_first_fail_pallas", boom)
    monkeypatch.setattr(cp, "HEAD_KERNEL_MIN_K", 0)
    geom = build_ci_pairwise_geometry((1.5, 1.5, 10.0), SHAPE, 12, "wrap")
    ci, _, ovf = calculate_ci_pairwise(jnp.asarray(_defect("clustered")),
                                       geom, 256)
    assert jax.default_backend() == "cpu"
    assert not bool(ovf) and float(jnp.sum(ci)) > 0


def _find_eqns(jaxpr, name):
    found = []
    for e in jaxpr.eqns:
        if e.primitive.name == name:
            found.append(e)
        for v in e.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                found += _find_eqns(sub, name)
    return found


def test_kernel_wrapper_pads_to_its_blocks():
    """Centers pad to the center block and witnesses to the witness block
    with far sentinels; outputs come back at the caller's length."""
    from ventjax.ops import ci_pallas as k

    geom = build_ci_pairwise_geometry((1.5, 1.5, 10.0), SHAPE, 12, "pad")
    ns = min(96, geom.n_balls - 1)
    n = k._RB + 3
    c = tuple(jnp.arange(n, dtype=jnp.int32) % m for m in SHAPE)
    w = tuple(x[: k._WB + 1] for x in c)
    args = dict(combos=((0, 0, 0),), scale=geom.scale,
                r2=tuple(float(r) for r in geom.r2_32[:ns]),
                t_head=tuple(int(t) for t in ((geom.rows_ball + 1) // 2)[:ns]),
                rmax=geom.rmax)
    jaxpr = jax.make_jaxpr(
        lambda *a: k.head_first_fail_pallas(*a, **args))(*c, *w)
    (pc,) = _find_eqns(jaxpr.jaxpr, "pallas_call")
    in_shapes = [v.aval.shape for v in pc.invars]
    assert in_shapes[:3] == [(2 * k._RB,)] * 3
    assert in_shapes[3:6] == [(2 * k._WB,)] * 3
    assert in_shapes[6:] == [(2,)] * 4
    out = k.head_first_fail_pallas(*c, *w, interpret=True, **args)
    assert out.shape == (n,) and out.dtype == jnp.int32
