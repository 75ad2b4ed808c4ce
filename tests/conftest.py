"""Test configuration: force an 8-device CPU mesh before JAX initializes.

Per SURVEY.md §4 item 3, distributed logic (shard_map batching, halo exchange,
mesh plumbing) is tested without accelerators by faking 8 host devices; op
tests run on the same CPU backend so results are deterministic in CI.
Kernels run here in the Pallas interpreter (explicit ``interpret=True``);
their compiled GPU form is checked by chip_smoke.py on the card.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the platform through the config API as well, so a machine with an
# accelerator plugin installed still runs the suite on the CPU.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ventjax.io.phantom import make_phantom  # noqa: E402


@pytest.fixture(scope="session")
def phantom_small():
    """A small phantom with defects touching nothing exotic — fast tests."""
    return make_phantom(shape=(64, 64, 8), vox=(1.5, 1.5, 10.0), seed=0)


@pytest.fixture(scope="session")
def phantom_128():
    """Full-size 128x128x16 phantom (the reference's typical geometry)."""
    return make_phantom(shape=(128, 128, 16), vox=(1.5, 1.5, 10.0), seed=3)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
