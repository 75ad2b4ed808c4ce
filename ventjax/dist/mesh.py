"""Device-mesh plumbing for cohort-scale data parallelism.

The reference has no distributed story (SURVEY.md §2.3): one subject at a
time on one CPU.  Here the primary scaling axis is the cohort batch: a
1-D ("batch",) mesh over the visible devices, shard_map-ing the fused
pipeline so each device analyzes its shard of subjects with zero
cross-device traffic on the hot path (collectives appear only in
cohort-level aggregations).  Multi-host runs initialize through
jax.distributed.initialize.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def make_batch_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_name: str = "batch",
) -> Mesh:
    """A 1-D mesh over the first n devices (default: all local devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_cohort_fn(
    cohort_fn: Callable,
    mesh: Mesh,
    axis_name: str = "batch",
) -> Callable:
    """shard_map a batched pipeline fn (hp[N,...], mask[N,...]) -> pytree.

    Every input/output leaf is sharded along its leading (cohort) axis;
    the per-device body is the unmodified vmapped pipeline, so numerical
    results are bit-identical to the single-device path (tests assert this
    on the fake 8-device CPU mesh).
    """
    spec = P(axis_name)
    return shard_map(
        cohort_fn,
        mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
        check_vma=False,
    )


def make_batch_space_mesh(
    n_batch: int,
    n_space: int,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """A 2-D ("batch", "space") mesh: data-parallel subjects x spatially
    sharded volumes (SURVEY.md §2.3 tensor-parallelism row)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_batch * n_space]).reshape(
        n_batch, n_space
    )
    return Mesh(devices, ("batch", "space"))


def spatial_shard_fn(
    cohort_fn: Callable,
    mesh: Mesh,
    batch_axis: str = "batch",
    space_axis: str = "space",
) -> Callable:
    """jit the batched pipeline with inputs sharded [N@batch, H@space, W, D].

    The TP analog for volumes too large per chip (SURVEY.md §2.3): the H
    axis is sharded over the "space" mesh axis *inside the same pjit
    program* — sharding annotations only, XLA derives every collective
    (gathers for the volume-global sorts/reductions, halo exchanges for the
    stencils).  Results are identical to the unsharded program; this trades
    some collective traffic for fitting oversize volumes, exactly as the
    SURVEY prescribes (mesh axes, not a separate engine)."""
    from jax.sharding import NamedSharding

    in_shard = NamedSharding(mesh, P(batch_axis, space_axis))
    return jax.jit(cohort_fn, in_shardings=(in_shard, in_shard))


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host runtime init (no-op when single-process).

    On a multi-host run, call once before building meshes with the
    coordinator address, process count and this process's id (a GPU host
    has no cluster autodetection).
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
