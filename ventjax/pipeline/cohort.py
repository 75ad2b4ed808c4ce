"""Cohort driver: streaming, batched, sharded, resumable multi-subject runs.

Replaces the reference's one-subject-at-a-time GUI loop
(Vent_Analysis.py:856-864 keeps a single mutable Vent1) with a manifest-based
batch runner (SURVEY.md §5 checkpoint/resume, §2.3 pipeline parallelism):

- a manifest (JSON list of {"id", "xenon", "mask", "proton"?}) names the
  cohort;
- subjects are decoded host-side through a BOUNDED prefetch window that
  overlaps the device compute (memory is O(batch), not O(cohort));
- subjects are grouped by geometry (shape, voxel size) and analyzed in
  per-geometry sub-batches by the fused pipeline sharded over the device
  mesh — mixed-geometry manifests just work;
- the CI defect pad and N4 mask pad are sized adaptively per batch
  (power-of-two buckets, sticky per geometry) and bumped + re-run on
  overflow, so results are never silently truncated: the configured
  values act as hard ceilings, beyond which the overflow flags stand;
- per-subject outputs (6-channel NIfTI + metrics JSON) are written by a
  small thread pool off the device critical path, with done-markers so a
  rerun skips completed subjects;
- a corrupt subject poisons only its own lane (valid=False in its metrics).

Failure model under multi-host (jax.distributed): fail-stop + resume.  When
a process dies mid-cohort the JAX coordination service tears the remaining
processes down (collectives cannot proceed without every rank), and every
batch exported before the death survives — the .done marker is written
last, so a marker implies a complete subject export — letting a fresh run
resume past it without rewriting anything (exactly-once, asserted by
tests/test_multihost.py failure-injection test): no in-job peer recovery,
durable checkpoints + restart.
"""
from __future__ import annotations

import json
import logging
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("ventjax.cohort")

import numpy as np
import jax
import jax.numpy as jnp

import dataclasses as _dataclasses

from ventjax.config import DEFAULT_CONFIG, VentConfig
from ventjax.dist import make_batch_mesh, shard_cohort_fn
from ventjax.io import dicom as dcm
from ventjax.pipeline.analyze import analyze_cohort, build_geometry
from ventjax.pipeline.result import StudyMetrics as _StudyMetrics
from ventjax.report import export as rexport


def load_manifest(path: str) -> List[Dict]:
    with open(path) as f:
        subjects = json.load(f)
    if not isinstance(subjects, list):
        raise ValueError("manifest must be a JSON list of subject dicts")
    for i, e in enumerate(subjects):
        if not isinstance(e, dict):
            raise ValueError(f"manifest entry {i} is not a dict")
        missing = [k for k in ("id", "xenon", "mask") if k not in e]
        if missing:
            raise ValueError(
                f"manifest entry {i} is missing required key(s) "
                f"{missing}; each entry needs "
                '{"id", "xenon", "mask"} (optional "proton")')
        if not isinstance(e["id"], str) or not e["id"]:
            raise ValueError(
                f"manifest entry {i}: \"id\" must be a non-empty string "
                f"(got {e['id']!r}); it names the subject's output "
                "directory")
    ids = [e["id"] for e in subjects]
    if len(set(ids)) != len(ids):
        dupes = sorted({s for s in ids if ids.count(s) > 1})
        raise ValueError(
            f"manifest has duplicate subject id(s) {dupes}; ids name the "
            "per-subject output directories and must be unique")
    return subjects


def _decode_mask_folder_fast(folder: str) -> Optional[np.ndarray]:
    """Native per-slice decode of the mask folder (the reference's ingest hot
    loop, SURVEY.md §3.1); None -> fall back to the Python codec."""
    from ventjax.io import native

    if not native.available():
        return None
    files = [f for f in sorted(os.listdir(folder)) if f.endswith(".dcm")]
    if not files:
        return None
    slices = []
    for fname in files:
        r = native.decode_pixels(os.path.join(folder, fname))
        if r is None:
            return None
        slices.append(r[0])
    return np.stack(slices, axis=-1).astype(np.float64)


def _decode_subject(entry: Dict) -> Tuple[Optional[np.ndarray], ...]:
    """Host-side DICOM decode for one subject; None signals a decode error.

    Returns (hp, mask, vox, ds, proton); proton is None unless the manifest
    entry names one (it feeds the NIfTI channel-0 export, not the analysis —
    same as the reference's optional proton_path, Vent_Analysis.py:148)."""
    try:
        ds, hp = dcm.open_single_dicom(entry["xenon"])
        mask = _decode_mask_folder_fast(entry["mask"])
        if mask is None:
            _, mask = dcm.open_dicom_folder(entry["mask"])
        proton = None
        if entry.get("proton"):
            _, proton = dcm.open_single_dicom(entry["proton"])
            proton = proton.astype(np.float32)
        vox = None
        for k in range(100):
            try:
                vox = list(ds[(0x5200, 0x9230)][k]["PixelMeasuresSequence"][0]
                           .PixelSpacing)
                break
            except Exception:
                continue
        if vox is None and "PixelSpacing" in ds:
            vox = list(ds.PixelSpacing)
        vox = [float(vox[0]), float(vox[1]), float(ds.SpacingBetweenSlices)]
        # Narrow the host->device upload when EXACT: DICOM pixel data is
        # integral, so hp is almost always uint16-representable and the
        # mask uint8 (3x fewer bytes than two f32 volumes); the device
        # casts back to f32 in-graph, bit-identical.
        # The check runs here in the decode thread pool, off the dispatch
        # critical path; any non-representable volume stays f32.
        hp = hp.astype(np.float32)
        u16 = hp.astype(np.uint16)
        if np.array_equal(u16.astype(np.float32), hp):
            hp = u16
        mask = mask.astype(np.float32)
        m8 = mask.astype(np.uint8)
        if np.array_equal(m8.astype(np.float32), mask):
            mask = m8
        return hp, mask, tuple(vox), ds, proton
    except Exception:
        return None, None, None, None, None


def _pow2_at_least(n: int, floor: int = 256) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(n, 1)))))


# StudyMetrics fields in mvec column order — derived from the dataclass so
# adding a field cannot silently desync the vector.  Every field is exactly
# f32-representable (floats are f32 already; counts < 2^24; bools 0/1), so
# the [B, n_fields] vector round-trips losslessly.
_METRIC_FIELDS = tuple(f.name for f in _dataclasses.fields(_StudyMetrics))
_METRIC_INT_FIELDS = ("ci_saturated",)
_METRIC_BOOL_FIELDS = ("ci_overflow", "n4_overflow", "valid")


def _pack_metrics_vec(metrics):
    """In-graph: StudyMetrics -> [B, n_fields] (or [n_fields]) f32."""
    return jnp.stack(
        [getattr(metrics, f).astype(jnp.float32) for f in _METRIC_FIELDS],
        axis=-1)


def _metrics_from_vec(v):
    """Host: mvec -> StudyMetrics of numpy columns (batch or single)."""
    v = np.asarray(v)
    kw = {}
    for i, f in enumerate(_METRIC_FIELDS):
        col = v[..., i]
        if f in _METRIC_INT_FIELDS:
            col = col.astype(np.int32)
        elif f in _METRIC_BOOL_FIELDS:
            col = col.astype(bool)
        kw[f] = col
    return _StudyMetrics(**kw)


def _decode_host_pack(host: Dict, schema) -> Dict:
    """Host-side pack decode: split the single-transfer blob back into its
    fields (bitcasting the int32 lanes), and mvec back into StudyMetrics.
    Accepts batch-level ([B, ...]) or lane-level arrays."""
    out = {k: np.asarray(v) for k, v in host.items()
           if k not in ("blob", "mvec")}
    if "mvec" in host:  # dense pack: metrics travel as their own array
        out["metrics"] = _metrics_from_vec(host["mvec"])
    if "blob" in host:
        blob = np.asarray(host["blob"])
        off = 0
        for name, size, dt in schema:
            seg = blob[..., off:off + size]
            off += size
            if dt == "i32":
                seg = np.ascontiguousarray(seg).view(np.int32)
            out[name] = seg
        if off != blob.shape[-1]:
            raise ValueError(
                f"blob width {blob.shape[-1]} != schema width {off}")
        out["metrics"] = _metrics_from_vec(out.pop("mvec"))
        out["n_def"] = out["n_def"][..., 0]
    return out


class _GeometryRunner:
    """Per-(shape, vox) batcher: jit cache + sticky adaptive pads."""

    def __init__(self, shape, vox, config: VentConfig, mesh, batch_size: int,
                 compact_export: bool = True, adaptive_pad: bool = False):
        self.shape = shape
        self.vox = vox
        self.config = config
        self.mesh = mesh
        self.bs = batch_size
        # adaptive_pad (the serving path): pad a partial batch to the next
        # power of two >= its size (bounded by bs and mesh divisibility)
        # instead of always to the full batch.  A single-subject scan then
        # uploads/pulls 1 lane, not bs zero-padded lanes — the dominant
        # term of warm single-study latency (benchmarks/latency.py).  The
        # jitted callables in _fns are shape-polymorphic (jax retraces per
        # batch shape under one jit object), so warm-program identity is
        # preserved; each new size pays one retrace+compile, and sizes are
        # bounded to the {1,2,4,...,bs} set.  Offline cohort runs keep the
        # fixed pad: their tail flush would otherwise compile an extra
        # program mid-cohort for a one-off partial batch.
        self.adaptive = adaptive_pad
        # Compact device->host transfer: ship n4 as
        # its <=P masked values + the B-spline lattice vector and defect as
        # its <=K compaction indices instead of two dense volumes.  Falls
        # back to the dense pack per batch when a mask outgrows the n4 pad
        # ceiling (the compact rebuild needs every masked voxel shipped).
        self.compact = compact_export
        self.items: List[Tuple[Dict, Tuple]] = []
        # Sticky buckets: start small, grow on overflow, never shrink
        # within a run (keeps recompiles to a handful per geometry).
        self.ci_bucket = min(512, config.ci_max_defect_voxels)
        self.n4_bucket = min(8192, config.n4_mask_pad)
        # Sticky tail escalation: set when a CI overflow persists at the
        # pad ceiling (tail-budget overflow, not defect-count overflow);
        # config.ci_tail_k (a user-set budget) applies until then.
        self.ci_tail_full = False
        # Final escalation: a CI overflow that survives every budget means
        # the compact pack would export a TRUNCATED defect channel (only
        # the first K indices travel); re-dispatch such batches with the
        # dense pack, whose uint8 defect volume is always complete —
        # metrics and the defect/NIfTI channels then match the round-4
        # dense behavior exactly, with only the CI map carrying the
        # flagged first-K truncation.
        self.ci_force_dense = False
        self._fns: Dict[Tuple[int, int], Callable] = {}
        # Buckets are read by the dispatch thread and grown by export
        # workers (overflow discovery happens off the critical path).
        self._bucket_lock = threading.Lock()

    def _fn(self, ci_pad: int, n4_pad: int, tail_full: bool = False,
            compact: bool = False):
        key = (ci_pad, n4_pad, tail_full, compact)
        if key not in self._fns:
            cfg = self.config.replace(
                ci_max_defect_voxels=ci_pad, n4_mask_pad=n4_pad,
                # Escalated batches run the CI tail at full width (= the
                # defect pad) instead of the K//8 default — the fix for
                # dense single-cluster loads whose uncrossed rows exceed
                # the tail budget even at the pad ceiling (same policy as
                # compat.ci_module's exactness retry).
                ci_tail_k=ci_pad if tail_full else self.config.ci_tail_k,
            )
            geom = build_geometry(self.vox, self.shape, cfg)
            # engine selection is pad-independent: record it for the
            # escalation gate instead of rebuilding a geometry later
            from ventjax.ops.ci_pairwise import CIPairwiseGeometry
            self._pairwise_cached = isinstance(geom, CIPairwiseGeometry)

            ci_pad_k = ci_pad

            def f(h, m):
                # Narrow the export payload IN-GRAPH, inside the one jitted
                # program of the batch.  Both pack flavors ship the dense f32 ci_map as its <=K
                # values gathered at the engines' own ascending-flat defect
                # compaction -> the host rebuilds the dense map bit-exactly
                # (_densify_ci), including the first-K truncation an
                # overflowed lane has on device.
                #
                # Dense pack (fallback): n4 dense f32 + defect dense uint8
                # (2.36 MB -> 1.33 MB per subject, round 4).
                # Compact pack (default): n4 as its <=P masked values + the
                # B-spline lattice vector (host rebuilds the off-mask
                # background from its own hp, _rebuild_compact_pack) and
                # defect as the SAME <=K compaction indices ci_cv already
                # uses (1.33 MB -> ~0.16 MB per subject, round 5).
                from ventjax.ops.basic import compact_mask_indices

                res = analyze_cohort(h, m, geom, cfg, export_compact=compact)

                def lane_cv(defect, ci_map):
                    cidx, n_def = compact_mask_indices(
                        defect.reshape(-1) != 0, ci_pad_k)
                    return cidx, ci_map.reshape(-1)[cidx], n_def

                cidx, ci_cv, n_def = jax.vmap(lane_cv)(res.defect, res.ci_map)
                # Metrics travel as ONE [B, n_fields] f32 vector, not 11
                # scalar leaves: one transfer instead of eleven.  All
                # fields are exactly f32-representable (ints < 2^24,
                # bools 0/1).
                mvec = _pack_metrics_vec(res.metrics)
                if compact:
                    # ... and the compact pack travels as ONE f32 blob —
                    # metrics vector FIRST (so multihost shard_export can
                    # allgather just blob[:, :n_fields]), then the data
                    # lanes; int32 index lanes are bitcast (not cast), so
                    # the transfer is bit-transparent end to end (most are
                    # f32 subnormal patterns: the path only copies bits,
                    # and chip_smoke.py checks it on the GPU).
                    bits = lambda x: jax.lax.bitcast_convert_type(
                        x, jnp.float32)
                    blob = jnp.concatenate([
                        mvec,
                        res.export["n4_cv"],
                        res.export["phi"],
                        ci_cv,
                        bits(cidx),
                        bits(n_def[:, None]),
                    ], axis=1)
                    return {"blob": blob}
                return {
                    "n4": res.n4,
                    "defect": res.defect.astype(jnp.uint8),
                    "ci_cv": ci_cv,
                    "n_def": n_def,
                    "mvec": mvec,
                }

            if self.mesh is not None:
                f = shard_cohort_fn(f, self.mesh)
            self._fns[key] = jax.jit(f)
        return self._fns[key]

    def _to_global(self, arr_np: np.ndarray):
        """Multi-host: feed this process's batch-axis slice and assemble
        the global [bs, ...] array over the global mesh."""
        from jax.experimental import multihost_utils
        from jax.sharding import PartitionSpec as P

        per = arr_np.shape[0] // jax.process_count()
        pid = jax.process_index()
        return multihost_utils.host_local_array_to_global_array(
            arr_np[pid * per:(pid + 1) * per], self.mesh, P("batch")
        )

    def add(self, entry: Dict, decoded: Tuple) -> bool:
        self.items.append((entry, decoded))
        return len(self.items) >= self.bs

    def take_batch(self) -> List[Tuple[Dict, Tuple]]:
        batch, self.items = self.items[:self.bs], self.items[self.bs:]
        return batch

    @property
    def _n4_cap(self) -> int:
        return min(int(np.prod(self.shape)), self.config.n4_mask_pad)

    def blob_schema(self, ci_pad: int, n4_pad: int):
        """(name, width, dtype) layout of the compact pack's blob."""
        from ventjax.ops.n4 import n4_phi_sizes

        V = int(np.prod(self.shape))
        P = min(int(n4_pad), V)
        L = sum(n4_phi_sizes(self.config.n4_fitting_levels,
                             self.config.n4_control_points))
        return (("mvec", len(_METRIC_FIELDS), "f32"),
                ("n4_cv", P, "f32"), ("phi", L, "f32"),
                ("ci_cv", ci_pad, "f32"), ("cidx", ci_pad, "i32"),
                ("n_def", 1, "i32"))

    def _eff_bs(self, n: int) -> int:
        """Padded size for an n-subject batch (see adaptive_pad above)."""
        if not self.adaptive:
            return self.bs
        n_dev = int(self.mesh.devices.size) if self.mesh is not None else 1
        eff = _pow2_at_least(n, floor=1)
        eff = min(max(eff, n_dev), self.bs)
        return -(-eff // n_dev) * n_dev

    def dispatch(self, batch):
        """Dispatch one padded batch at the current sticky buckets.

        Returns (device VentResult, (ci_pad, n4_pad)) WITHOUT any host
        sync: the overflow flags are read by the export worker when it
        pulls the results to host, so device compute for the next batch
        overlaps this batch's flag check (round-2 VERDICT weak #3 — the
        old run() blocked the dispatch thread on every batch).  Overflowed
        batches come back through bump_for_retry + a retry queue.
        """
        n = len(batch)
        eff_bs = self._eff_bs(n)
        pad = eff_bs - n

        def _stack(lanes, narrow):
            # All lanes narrow (decode-time exactness check) -> upload the
            # narrow dtype and let the device cast back to f32 in-graph
            # (exact); any wide lane upcasts the whole batch.
            dt = narrow if all(l.dtype == narrow for l in lanes) \
                else np.float32
            return np.stack([l.astype(dt, copy=False) for l in lanes]
                            + [np.zeros(self.shape, dt)] * pad)

        hp_np = _stack([d[0] for _, d in batch], np.uint16)
        mask_np = _stack([d[1] for _, d in batch], np.uint8)

        max_mask = int((mask_np > 0).sum(axis=(1, 2, 3)).max())
        with self._bucket_lock:
            self.n4_bucket = min(
                max(self.n4_bucket, _pow2_at_least(max_mask, 8192)),
                self._n4_cap,
            )
            pads = (self.ci_bucket, self.n4_bucket, self.ci_tail_full)
        if jax.process_count() > 1 and self.mesh is not None:
            # Multi-host: every process decoded the same subjects (the
            # manifest is broadcast-consistent, see run_cohort); each feeds
            # its batch-axis slice into a global array.  Build straight
            # from the host arrays — routing through jnp.asarray first
            # would add a device round-trip on the dispatch thread.
            hp = self._to_global(hp_np)
            mask = self._to_global(mask_np)
        else:
            hp = jnp.asarray(hp_np)
            mask = jnp.asarray(mask_np)
        # Compact transfer requires every masked voxel in the n4 pad (the
        # host rebuild overwrites exactly the shipped voxels); a batch whose
        # largest mask exceeds the pad ceiling falls back to the dense pack
        # (n4_overflow will flag it in the metrics regardless).
        compact = (self.compact and pads[1] >= max_mask
                   and not self.ci_force_dense)
        res = self._fn(*pads, compact=compact)(hp, mask)
        return res, pads

    @property
    def _ci_cap(self) -> int:
        return self.config.ci_max_defect_voxels

    @property
    def _engine_pairwise(self) -> bool:
        """Whether this geometry resolves to the pairwise CI engine (the
        tail-budget escalation only exists there; the staged-ladder
        fallback ignores ci_tail_k, so escalating would be a guaranteed
        no-op recompile)."""
        if not hasattr(self, "_pairwise_cached"):
            # only reachable if bump_for_retry ever ran before any _fn
            # (which records the engine from the geometry it builds anyway)
            from ventjax.ops.ci_pairwise import CIPairwiseGeometry

            self._pairwise_cached = isinstance(
                build_geometry(self.vox, self.shape, self.config),
                CIPairwiseGeometry)
        return self._pairwise_cached

    def bump_for_retry(self, ci_ovf: bool, n4_ovf: bool, pads,
                       compact_pack: bool = False) -> bool:
        """Grow the sticky buckets after an observed overflow at `pads`.

        Returns True if a retry at larger budgets is warranted; False when
        every escalation is exhausted (the overflow flags then stand in
        the exported metrics — never silent).  Growth is idempotent per
        level so concurrent export workers observing the same overflow
        bump once, not once each.

        The CI overflow flag covers two causes the driver cannot tell
        apart: defect count > pad, and head-uncrossed rows > the tail
        budget (dense single-cluster loads).  Pad doubling fixes both in
        most cases (the default tail scales as K//8); when the flag still
        stands at the pad ceiling, one final escalation re-runs with a
        FULL-WIDTH tail (tail_k = K) — the same exactness retry
        compat.ci_module performs — after which a standing flag is a true
        defect-count overflow.
        """
        ci_pad, n4_pad, tail_full = pads
        with self._bucket_lock:
            retry = False
            if ci_ovf:
                if self.ci_bucket <= ci_pad:
                    if self.ci_bucket < self._ci_cap:
                        self.ci_bucket = min(ci_pad * 2, self._ci_cap)
                    elif not self.ci_tail_full and self._engine_pairwise:
                        self.ci_tail_full = True
                    elif compact_pack and not self.ci_force_dense:
                        # every CI budget is exhausted: the flag will
                        # stand — make sure the EXPORT is not also
                        # truncated (see ci_force_dense above)
                        self.ci_force_dense = True
                retry = (self.ci_bucket > ci_pad
                         or (self.ci_tail_full and not tail_full)
                         or (self.ci_force_dense and compact_pack))
            if n4_ovf:
                if self.n4_bucket <= n4_pad:
                    self.n4_bucket = min(n4_pad * 2, self._n4_cap)
                retry = retry or self.n4_bucket > n4_pad
            return retry


def run_cohort(
    manifest: List[Dict],
    out_dir: str,
    config: VentConfig = DEFAULT_CONFIG,
    batch_size: Optional[int] = None,
    use_mesh: bool = True,
    resume: bool = True,
    decode_workers: int = 8,
    export_workers: int = 4,
    progress: Optional[Callable[[str, int, int], None]] = None,
    runners: Optional[Dict[Tuple, "_GeometryRunner"]] = None,
    export_npz: bool = False,
    shard_export: bool = False,
    compact_export: bool = True,
    adaptive_pad: bool = False,
) -> List[Dict]:
    """Analyze every subject in the manifest; returns per-subject metrics.

    Streaming: decode prefetch is bounded at 2 batches ahead, exports run in
    background threads, so host memory stays O(batch_size x geometries) on
    arbitrarily large cohorts.  `progress(stage, done, total)` is called as
    subjects decode ("decode"), as device batches complete ("analyze"),
    and as exports land per subject ("export" — also emitted with an
    unchanged count when an overflowed batch re-queues, as a keep-alive
    for stall watchdogs; the export count ends below `total` when
    subjects failed decode/analysis).  Callbacks fire from decode/export
    worker threads as well as the dispatch thread.

    `runners` lets a long-lived caller (the watch-folder service,
    pipeline/serve.py) pass a persistent per-geometry runner dict so jitted
    programs and sticky pad buckets survive across calls — repeat calls with
    a known geometry skip straight to device dispatch instead of re-tracing.
    The caller must then hold config/batch_size/use_mesh fixed across calls
    (runners bake them in at construction).

    `shard_export` (multi-host only): instead of allgathering the full
    result volumes to every host and having process 0 write every file,
    each process pulls ONLY its addressable batch-axis shards to host and
    exports its own lanes — the per-host file-sharding fan-out of SURVEY.md
    §5's comm-backend row.  Device→host traffic and file I/O both divide by
    process_count.  Requires a filesystem shared across processes (resume
    broadcasts process 0's view of the done-markers, and the cohort's
    outputs are expected in one place); with per-host local disks keep the
    default process-0 export instead.  Only active when the batch really is
    sharded (use_mesh with >1 device): without a mesh every process holds a
    full replicated result, each shard would claim every lane, and N
    processes would race-write the same files — mesh-less multihost runs
    fall back to process-0 export.

    `compact_export` (default True): ship the n4 channel as its <=P masked
    values + the B-spline lattice vector and defect as its <=K compaction
    indices instead of two dense volumes (~0.16 MB vs 1.33 MB per subject
    over the device->host link).  Masked
    voxels, defect, and CI channels rebuild bit-identically to the dense
    transfer; the out-of-mask n4 background (never analyzed) is
    regenerated host-side to ~1e-6 relative.  False restores the fully
    dense device->host transfer.

    `adaptive_pad` (default False; the serve daemon passes True): partial
    batches pad to the next power of two >= their size instead of to the
    full batch_size, trading one retrace+compile per new size for not
    uploading/pulling bs-n zero lanes — see _GeometryRunner.adaptive.
    Callers passing a persistent `runners` dict bake the choice in at
    runner construction, like config/batch_size/use_mesh.
    """
    multihost = jax.process_count() > 1
    os.makedirs(out_dir, exist_ok=True)
    done_flags = np.array(
        [1 if resume and os.path.exists(os.path.join(out_dir, e["id"],
                                                     ".done")) else 0
         for e in manifest], np.int32)
    if multihost:
        # Process 0 owns the done-markers: its view of what is already
        # exported is broadcast so every process runs the same dispatch
        # sequence even without a shared filesystem (collectives are
        # collective — divergent todo lists would deadlock the mesh).
        from jax.experimental import multihost_utils

        done_flags = np.asarray(
            multihost_utils.broadcast_one_to_all(done_flags))
    todo: List[Dict] = []
    results: List[Dict] = []
    for entry, done in zip(manifest, done_flags):
        if done:
            try:
                with open(os.path.join(out_dir, entry["id"],
                                       "metrics.json")) as f:
                    results.append(json.load(f))
            except OSError:
                # non-owning process without the shared filesystem
                results.append({"id": entry["id"], "resumed": True})
            continue
        todo.append(entry)
    if not todo:
        return results

    n_dev = len(jax.devices()) if use_mesh else 1
    bs = batch_size or max(n_dev, 8)
    bs = -(-bs // n_dev) * n_dev  # divisible by mesh size
    mesh = make_batch_mesh() if use_mesh and n_dev > 1 else None

    if runners is None:
        runners = {}
    results_lock = threading.Lock()
    n_done = 0
    total = len(todo)

    export_pool = ThreadPoolExecutor(max_workers=export_workers)
    export_futures = []
    # Backpressure: at most 2 batches of results may be queued for export,
    # so host memory stays O(batch) even when export I/O (or the slow
    # device->host link) lags behind compute.
    export_slots = threading.BoundedSemaphore(2)
    # Batches whose overflow flags fired come back here for re-dispatch at
    # grown pads (the dispatch thread drains this queue); the flag check
    # itself happens in the export workers so dispatch never syncs.
    retry_lock = threading.Lock()
    retry_queue: deque = deque()

    def _export_batch(runner, batch, pack, pads):
        try:
            # One batched device->host transfer per array (the compact
            # pack is a single blob).  This is also the first host sync
            # of the batch — the overflow check lives here, off the
            # dispatch thread.  The pack itself was assembled on the
            # dispatch thread; this thread only pulls results.
            host = _decode_host_pack(
                jax.tree_util.tree_map(np.asarray, pack),
                runner.blob_schema(*pads[:2]))
            n = len(batch)
            # Overflow on a VALID lane only: an empty-mask subject's
            # safe-ones-mask garbage always overflows the CI pad, and
            # letting it drive the ladder would burn the whole recompile
            # sequence and stick ci_force_dense for the geometry.  Its
            # flags still export (valid=False tells the reader why).
            m = host["metrics"]
            ci_ovf = bool((m.ci_overflow & m.valid)[:n].any())
            n4_ovf = bool((m.n4_overflow & m.valid)[:n].any())
            if (ci_ovf or n4_ovf) and runner.bump_for_retry(
                ci_ovf, n4_ovf, pads, compact_pack="blob" in pack
            ):
                log.info("geometry %s: overflow at ci=%d n4=%d "
                         "tail_full=%s, queueing batch for re-run",
                         runner.shape, *pads)
                with retry_lock:
                    retry_queue.append((runner, batch))
                _touch_export(0)  # keep-alive: the retry is progress too
                return
            for lane, (entry, decoded) in enumerate(batch):
                lane_pack = jax.tree_util.tree_map(lambda x: x[lane], host)
                _write_subject(out_dir, entry, decoded, lane_pack,
                               results, results_lock,
                               npz=export_npz, config=config)
                _touch_export()
        finally:
            export_slots.release()

    n_exported = 0

    def _touch_export(k=1):
        """Progress event per exported subject (export workers).  Keeps
        the stall watchdog fed through the tail phases (grown-pad retry
        recompiles, final export settle) that emit no analyze events; the
        count can end below `total` when subjects failed decode/analysis."""
        nonlocal n_exported
        with results_lock:
            n_exported += k
            cnt = n_exported
        if progress:
            progress("export", cnt, total)

    def _export_files(batch, host):
        """File I/O only (no device access) — multihost export worker."""
        try:
            for lane, (entry, decoded) in enumerate(batch):
                lane_pack = jax.tree_util.tree_map(lambda x: x[lane], host)
                _write_subject(out_dir, entry, decoded, lane_pack,
                               results, results_lock,
                               npz=export_npz, config=config)
                _touch_export()
        finally:
            export_slots.release()

    def _export_owned_lanes(owned):
        """File I/O for this process's own lanes (shard_export worker).
        Results were already recorded lane-for-lane on the dispatch thread
        (identically on every process), so record=False here."""
        try:
            for entry, decoded, lane_pack in owned:
                _write_subject(out_dir, entry, decoded, lane_pack,
                               results, results_lock,
                               npz=export_npz, config=config,
                               record=False, exporter=jax.process_index())
                _touch_export()
        finally:
            export_slots.release()

    def submit_export(runner, batch, res, pads, is_retry=False):
        nonlocal n_done
        # `res` is already the narrowed export pack built in-graph by the
        # runner's jitted fn (compact: one data blob + one metrics vector;
        # dense fallback: n4 f32 + defect uint8 + ci_cv/n_def + mvec) —
        # everything else of VentResult never leaves the device.
        pack = res
        schema = runner.blob_schema(*pads[:2])
        if multihost and shard_export and runner.mesh is not None:
            # Allgather ONLY the small per-lane metrics vector (the
            # overflow/retry decision must be identical on every process);
            # the big result data is never gathered — each process reads
            # just its own addressable batch-axis shards and exports those
            # lanes.
            from jax.experimental import multihost_utils

            mv = (pack["blob"][:, :len(_METRIC_FIELDS)]
                  if "blob" in pack else pack["mvec"])
            host_metrics = _metrics_from_vec(np.asarray(
                multihost_utils.process_allgather(mv, tiled=True)))
            n = len(batch)
            # valid-lane overflows only — see the single-process comment
            ci_ovf = bool((host_metrics.ci_overflow
                           & host_metrics.valid)[:n].any())
            n4_ovf = bool((host_metrics.n4_overflow
                           & host_metrics.valid)[:n].any())
            if (ci_ovf or n4_ovf) and runner.bump_for_retry(
                ci_ovf, n4_ovf, pads, compact_pack="blob" in pack
            ):
                with retry_lock:
                    retry_queue.append((runner, batch))
                _touch_export(0)  # keep-alive: matches single-process path
            else:
                # Every process records every lane's metrics (identical
                # results lists everywhere) ...
                with results_lock:
                    for lane, (entry, _) in enumerate(batch):
                        results.append({
                            "id": entry["id"],
                            **jax.tree_util.tree_map(
                                lambda x: x[lane],
                                host_metrics).as_dict(),
                        })
                # ... then assembles host packs for the lanes whose device
                # shards live on THIS process (shard.index names the global
                # batch slice, so no device-order assumption).  The
                # np.asarray shard reads stay on the dispatch thread like
                # every other device touch.
                local: Dict[int, Dict] = {}
                for k in (k for k in pack if k != "mvec"):
                    for s in pack[k].addressable_shards:
                        lo = s.index[0].start or 0
                        data = np.asarray(s.data)
                        for off in range(data.shape[0]):
                            if lo + off < n:
                                local.setdefault(lo + off, {})[k] = data[off]
                owned = [
                    (batch[lane][0], batch[lane][1],
                     {**_decode_host_pack(local[lane], schema),
                      "metrics": jax.tree_util.tree_map(
                          lambda x, lane=lane: x[lane], host_metrics)})
                    for lane in sorted(local)
                ]
                if owned:
                    export_slots.acquire()
                    export_futures.append(
                        export_pool.submit(_export_owned_lanes, owned))
        elif multihost:
            # Collectives must issue in the same order on every process, so
            # the global->host gather (and the overflow check) stays on the
            # dispatch thread; only process 0 writes files, in workers.
            from jax.experimental import multihost_utils

            host = _decode_host_pack(
                jax.tree_util.tree_map(
                    lambda x: np.asarray(
                        multihost_utils.process_allgather(x, tiled=True)),
                    pack,
                ),
                schema,
            )
            n = len(batch)
            # Overflow on a VALID lane only: an empty-mask subject's
            # safe-ones-mask garbage always overflows the CI pad, and
            # letting it drive the ladder would burn the whole recompile
            # sequence and stick ci_force_dense for the geometry.  Its
            # flags still export (valid=False tells the reader why).
            m = host["metrics"]
            ci_ovf = bool((m.ci_overflow & m.valid)[:n].any())
            n4_ovf = bool((m.n4_overflow & m.valid)[:n].any())
            if (ci_ovf or n4_ovf) and runner.bump_for_retry(
                ci_ovf, n4_ovf, pads, compact_pack="blob" in pack
            ):
                with retry_lock:
                    retry_queue.append((runner, batch))
                _touch_export(0)  # keep-alive: matches single-process path
            elif jax.process_index() == 0:
                export_slots.acquire()
                export_futures.append(
                    export_pool.submit(_export_files, batch, host))
            else:
                with results_lock:
                    for lane, (entry, _) in enumerate(batch):
                        results.append({
                            "id": entry["id"],
                            **jax.tree_util.tree_map(
                                lambda x: x[lane], host)["metrics"].as_dict(),
                        })
                # Non-exporting processes: recording metrics IS this
                # process's completion of the batch — feed the watchdog.
                _touch_export(len(batch))
        else:
            # The pack is exported as the jitted program produced it: any
            # narrowing cast already happened in-graph.
            export_slots.acquire()
            export_futures.append(
                export_pool.submit(_export_batch, runner, batch, pack, pads)
            )
        if not is_retry:
            n_done += len(batch)
            if progress:
                progress("analyze", n_done, total)
            log.info("analyzed %d/%d subjects", n_done, total)

    def drain_retries():
        """Re-dispatch overflowed batches at their grown pads (dispatch
        thread only).  A retry can overflow again; it then re-queues until
        the ceilings stop bump_for_retry."""
        while True:
            with retry_lock:
                if not retry_queue:
                    return
                runner, batch = retry_queue.popleft()
            res, pads = runner.dispatch(batch)
            submit_export(runner, batch, res, pads, is_retry=True)

    def handle(entry, decoded):
        nonlocal n_done
        if decoded[0] is None:
            metrics = {"id": entry["id"], "valid": False,
                       "error": "decode_failed"}
            sdir = os.path.join(out_dir, entry["id"])
            os.makedirs(sdir, exist_ok=True)
            with open(os.path.join(sdir, "metrics.json"), "w") as f:
                json.dump(metrics, f, indent=2)
            with results_lock:
                results.append(metrics)
            n_done += 1
            return
        geo = (decoded[0].shape, decoded[2])
        if geo not in runners:
            runners[geo] = _GeometryRunner(geo[0], geo[1], config, mesh, bs,
                                           compact_export=compact_export,
                                           adaptive_pad=adaptive_pad)
        runner = runners[geo]
        if runner.add(entry, decoded):
            batch = runner.take_batch()
            res, pads = runner.dispatch(batch)
            submit_export(runner, batch, res, pads)
        drain_retries()

    # Streaming decode: a bounded window of in-flight decode futures
    # (2 batches ahead) overlapping device compute and export I/O.
    prefetch = max(2 * bs, decode_workers)
    with ThreadPoolExecutor(max_workers=decode_workers) as dpool:
        pending = deque()
        it = iter(todo)
        for entry in todo[:prefetch]:
            next(it)
            pending.append((entry, dpool.submit(_decode_subject, entry)))
        n_decoded = 0
        while pending:
            entry, fut = pending.popleft()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, dpool.submit(_decode_subject, nxt)))
            decoded = fut.result()
            n_decoded += 1
            if progress:
                progress("decode", n_decoded, total)
            handle(entry, decoded)

    # Flush partial batches per geometry.
    for runner in runners.values():
        while runner.items:
            batch = runner.take_batch()
            res, pads = runner.dispatch(batch)
            submit_export(runner, batch, res, pads)

    # Settle: exports may queue retries, whose exports may queue more —
    # alternate waiting and draining until both are empty.
    while True:
        pending_exports, export_futures = export_futures, []
        for f in pending_exports:
            f.result()  # surface export exceptions
        drain_retries()
        if not export_futures:
            break
    export_pool.shutdown(wait=True)
    return results


def _densify_ci(pack: Dict, shape=None) -> np.ndarray:
    """Rebuild the dense CI map from the compacted transfer.

    The engines write CI values only at defect voxels, in ascending flat
    (C-order) position — the same compaction order `ci_cv` was gathered
    in — so scattering the first n_def values back over the defect indices
    reproduces the device's dense map bit-for-bit, including the first-K
    truncation an overflowed lane has on device (metrics.ci_overflow flags
    those; the cohort driver retries them at grown pads before they ever
    reach export).  Dense packs carry the defect volume (host takes
    flatnonzero); compact packs carry the device's own compaction indices
    (`cidx`) directly, plus `shape` for the output volume."""
    cv = np.asarray(pack["ci_cv"])
    n = min(int(pack["n_def"]), cv.shape[0])
    if "defect" in pack:
        defect = np.asarray(pack["defect"])
        shape = defect.shape
        idx = np.flatnonzero(defect.reshape(-1))[:n]
    else:
        idx = np.asarray(pack["cidx"][:n], np.int64)
    ci = np.zeros(int(np.prod(shape)), np.float32)
    ci[idx] = cv[:len(idx)]
    return ci.reshape(shape)


def _rebuild_compact_pack(pack: Dict, hp: np.ndarray, mask: np.ndarray,
                          config: VentConfig) -> Dict:
    """Rebuild dense n4 (f32) + defect (uint8) channels for ONE subject from
    the compact transfer pack (see _GeometryRunner._fn).

    - defect: scatter 1 at the device's own `cidx[:n_def]` compaction
      indices — bit-exact (truncated only when n_def exceeded the pad
      ceiling, which metrics.ci_overflow flags).
    - n4: the host regenerates `hp * exp(-field)` from the shipped B-spline
      lattice vector (float64 numpy, ops.n4.n4_field_from_phi_np), then
      overwrites every masked voxel with the device-exact shipped value.
      Masked voxels — the only voxels any metric, VDP, or CI computation
      ever reads — are therefore bit-identical to the dense transfer; the
      out-of-mask background (raw noise, analyzed by nothing) agrees with
      the device to ~1e-6 relative (the HIGH-precision device einsum vs the
      float64 host einsum; pinned by tests/test_pipeline.py).
    An analysis-invalid subject (empty mask) has no masked voxels to
    overwrite: its n4 channel is purely host-regenerated and its defect
    channel is empty — its metrics carry valid=False either way.
    """
    from ventjax.ops.n4 import n4_field_from_phi_np

    shape = hp.shape
    n4_cv = np.asarray(pack["n4_cv"])
    midx = np.flatnonzero(np.asarray(mask).reshape(-1) > 0)[:n4_cv.shape[0]]
    field = n4_field_from_phi_np(
        np.asarray(pack["phi"]), shape,
        fitting_levels=config.n4_fitting_levels,
        control_points=config.n4_control_points,
    )
    n4 = (np.asarray(hp, np.float64) * np.exp(-field)).astype(np.float32)
    n4.reshape(-1)[midx] = n4_cv[:len(midx)]

    defect = np.zeros(int(np.prod(shape)), np.uint8)
    n = min(int(pack["n_def"]), np.asarray(pack["cidx"]).shape[0])
    defect[np.asarray(pack["cidx"][:n], np.int64)] = 1
    out = dict(pack)
    out["n4"] = n4
    out["defect"] = defect.reshape(shape)
    return out


def _write_subject(out_dir, entry, decoded, pack, results, lock,
                   npz=False, config=None, record=True,
                   exporter=None) -> None:
    """pack: host-side dict for ONE subject — either the dense flavor
    (n4 f32 + defect uint8) or the compact flavor (n4_cv/phi/cidx, see
    _rebuild_compact_pack) — plus compacted ci_cv/n_def (see _densify_ci)
    and metrics (StudyMetrics).  record=False skips the results append
    (shard_export records metrics on the dispatch thread); exporter stamps
    which process wrote the files into metrics.json."""
    hp, mask, vox, ds, proton = decoded
    # decode may have narrowed hp/mask for the device upload (uint16/uint8,
    # exact); exports keep the f32 convention of the reference artifacts.
    hp = np.asarray(hp, np.float32)
    mask = np.asarray(mask, np.float32)
    pack = dict(pack)
    if "n4_cv" in pack:
        pack = _rebuild_compact_pack(
            pack, hp, mask, config or DEFAULT_CONFIG)
    pack["ci_map"] = _densify_ci(pack)
    sid = entry["id"]
    sdir = os.path.join(out_dir, sid)
    os.makedirs(sdir, exist_ok=True)
    metrics = {"id": sid, **pack["metrics"].as_dict()}
    if exporter is not None:
        metrics["export_process"] = int(exporter)
    rexport.export_nifti(
        sdir, sid, hp, mask,
        proton=proton,
        n4=np.asarray(pack["n4"]),
        defect=np.asarray(pack["defect"], dtype=np.float32),
        ci=np.asarray(pack["ci_map"]),
    )
    with open(os.path.join(sdir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    if ds is not None:
        rexport.dicom_to_json(ds, os.path.join(sdir, f"{sid}.json"))
    if npz:
        # the versioned NPZ study artifact, ctor-resumable via
        # Vent_Analysis(npz_path=...); written BEFORE the .done marker so
        # resume never trusts a torn artifact (same crash-consistency rule
        # as every other export here)
        state = {
            "HPvent": hp, "mask": mask,
            "N4HPvent": np.asarray(pack["n4"]),
            "defectArray": np.asarray(pack["defect"], np.float64),
            "CIarray": np.asarray(pack["ci_map"]),
            "vox": [float(v) for v in vox],
            "metadata": metrics,
        }
        if proton is not None:
            state["proton"] = proton
        if config is not None:
            state["config"] = config
        rexport.save_npz(state, os.path.join(sdir, f"{sid}.npz"))
    with open(os.path.join(sdir, ".done"), "w") as f:
        f.write("ok\n")
    if record:
        with lock:
            results.append(metrics)
