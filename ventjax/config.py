"""Frozen configuration for the ventjax pipeline.

Every numeric constant that is hard-coded inline in the reference implementation
(see /root/reference/Vent_Analysis.py and /root/reference/CI.py) is lifted into a
single frozen, hashable dataclass so that it is jit-static, sweepable, and
documented.  Reference provenance of each constant is cited next to it.

The dataclass is hashable (all fields are immutables/tuples) so a VentConfig can
be passed as a `static_argnums` argument to `jax.jit`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VERSION = "0.1.0"
# Reference pipeline version string this build tracks for parity
# (/root/reference/Vent_Analysis.py:67  -> self.version = '241007_vent').
REFERENCE_VERSION = "241007_vent"


@dataclasses.dataclass(frozen=True)
class VentConfig:
    """All pipeline constants. Defaults replicate the reference behavior."""

    # ---- Mean-anchored VDP (Thomen 2015) ------------------------------------
    # Defect threshold on mean-normalized N4 signal
    # (Vent_Analysis.py:239 `calculate_VDP(self, thresh=0.6)`).
    vdp_thresh: float = 0.6
    # Median filter kernel applied per-slice to the defect mask
    # (Vent_Analysis.py:249 scipy.signal.medfilt2d default kernel_size=3).
    median_kernel: int = 3

    # ---- Linear-binning VDP (Mu He 2016) ------------------------------------
    # Normalization percentile: sorted masked signal at index int(len*.99)
    # (Vent_Analysis.py:255 — variable is misnamed `norm95th_vent` in the
    # reference but the math is the 99th percentile; we keep the math).
    lb_percentile: float = 0.99
    # Bin edges for the 6-way linear binning (Vent_Analysis.py:256).
    lb_edges: Tuple[float, ...] = (0.16, 0.34, 0.52, 0.70, 0.88)
    # Bins counted as defect for VDP_lb (bins 1 and 2, Vent_Analysis.py:257).
    lb_defect_bins: Tuple[int, ...] = (1, 2)

    # ---- SNR (Vent_Analysis.py:337-357) -------------------------------------
    # Rows zeroed at top/bottom of the noise mask.  NOTE the reference quirk:
    # calculate_SNR is called as calculate_SNR(HPvent, mask) at line 241 so the
    # mask binds to FOVbuffer, which line 343 immediately overwrites to 20.
    snr_fov_buffer: int = 20

    # ---- K-means VDP (Kirby 2012; reference stub at Vent_Analysis.py:259-261)
    kmeans_clusters: int = 4
    kmeans_iters: int = 30
    # Number of lowest-mean clusters counted as defect.
    kmeans_defect_clusters: int = 1

    # ---- Cluster Index (CI.py) -----------------------------------------------
    # Maximum sphere radius in scaled-voxel units (CI.py:107 `Rmax=50`).
    ci_rmax: int = 50
    # Defect fraction threshold for sphere growing (CI.py:97 `C < 0.5`).
    ci_defect_frac: float = 0.5
    # Radius grid step for shell growing (CI.py:55 `np.arange(0, radius, 0.01)`).
    ci_shell_step: float = 0.01
    # Subject CI = this percentile of the CI map over defect voxels
    # (Vent_Analysis.py:269 `index95 = int(0.95*len(CVlist))`).
    ci_percentile: float = 0.95
    # Static upper bound on the number of defect voxels per volume (pads the
    # jit-static defect list; volumes with more defect voxels raise).
    ci_max_defect_voxels: int = 8192
    # Tail budget of the pairwise engine's two-phase resolve: rows with no
    # head-ball crossing are compacted to this many lanes for the sort
    # tail.  None = the engine default max(256, K//8) — right for sparse
    # loads; dense single-cluster loads can exceed it (flagged, never
    # silent).  The cohort driver retries flagged batches with a
    # full-width tail (= K) once the pad ceiling is reached, mirroring
    # compat.ci_module's exactness retry.
    ci_tail_k: Optional[int] = None
    # Index-space behavior at volume borders.  "wrap" replicates the
    # reference's linear-index aliasing (CI.py:65-68 px2vec has no bounds
    # clamp, so out-of-bounds sphere voxels alias in index space); "pad" is the
    # geometrically correct zero-padded behavior.  "wrap" is the default so the
    # pipeline bit-matches the CPU oracle.
    ci_border_mode: str = "wrap"
    # Saturate CV at Rmax instead of raising (reference raises ValueError at
    # CI.py:101-104); saturation count is surfaced in StudyMetrics.
    ci_saturate_rmax: bool = True
    # CI engine: "pairwise" (order-statistics over pairwise defect-voxel
    # distances; the default, exactness guarded at geometry build),
    # "ladder" (stage-laddered indicator gathers), or "full" (flat gather
    # scan).  All three are exact; they differ only in speed.
    ci_engine: str = "pairwise"
    # Slice-axis sharding for oversize volumes: 0/1 = single device, N > 1 =
    # shard the CI slice axis over the first N devices via halo exchange
    # (ventjax.dist.halo; bit-identical to unsharded).  Requires the
    # pairwise engine; CLI `analyze --shard-slices N|auto`.
    ci_shard_slices: int = 0

    # ---- N4 bias-field correction (ITK defaults; Vent_Analysis.py:316-334) ---
    # The reference calls SimpleITK's N4BiasFieldCorrectionImageFilter with all
    # default parameters (Tustison et al. 2010).  These are the ITK defaults.
    n4_fitting_levels: int = 4
    n4_max_iters: int = 50
    n4_convergence_threshold: float = 0.001
    n4_histogram_bins: int = 200
    n4_bias_fwhm: float = 0.15
    n4_wiener_noise: float = 0.01
    n4_spline_order: int = 3
    # Control points per dimension at the coarsest level (ITK default is 4,
    # i.e. a single cubic B-spline mesh element).
    n4_control_points: int = 4
    # Static bound on masked-voxel count for the compacted N4 iteration
    # (lungs at 128x128x16/1.5mm reach ~50k voxels); overflow is flagged in
    # StudyMetrics.n4_overflow and means excess voxels were ignored by the
    # fit — raise the pad if it ever fires.
    n4_mask_pad: int = 65536

    # ---- Report / screenshot (Vent_Analysis.py:458-520) ----------------------
    # Parula LUT index = int(CI * parula_scale_num / parula_scale_den)
    # (Vent_Analysis.py:482-484 `parula[int(CI*64/40)]`).
    parula_scale_num: int = 64
    parula_scale_den: int = 40
    # Crop border for the montage (Vent_Analysis.py:467 `border=5`).
    screenshot_crop_border: int = 5
    montage_rows: int = 7

    # ---- Volume geometry / batching ------------------------------------------
    # Voxel dims [row, col, slice] in mm; per-study value normally read from
    # the DICOM header (Vent_Analysis.py:208-221).
    default_vox: Tuple[float, float, float] = (1.5, 1.5, 10.0)

    # ---- Numerics -------------------------------------------------------------
    compute_dtype: str = "float32"

    def replace(self, **kw) -> "VentConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = VentConfig()


@dataclasses.dataclass(frozen=True)
class StudyPreset:
    """One IRB study type: the reference GUI's GenXe / Mepo / Clinical
    columns (Vent_Analysis.py:655-676) as data.

    Carries the per-study metadata schema (which ID key the study uses,
    which treatment arms are valid, which extra metadata fields the GUI
    collected) plus the scientific VentConfig.  The CLI uses this to
    validate --treatment/--visit against the study's arms and to stamp
    study provenance into exported metadata; the filename grammar
    (ventjax.report.export.export_filename) consumes the same `irb` key.
    """

    irb: str                      # grammar key ('genxe'|'mepo'|'clinical')
    id_field: str                 # metadata key for the subject ID
    id_label: str                 # GUI label (provenance)
    treatments: Tuple[str, ...]   # valid treatment/timepoint arms
    visits: Tuple[str, ...]       # valid visit choices ('' = free-form #)
    extra_fields: Tuple[str, ...]  # additional per-study metadata keys
    config: VentConfig = DEFAULT_CONFIG

    def validate(self, treatment: str = None, visit: str = None) -> None:
        if treatment and self.treatments and treatment not in self.treatments:
            raise ValueError(
                f"{self.irb}: treatment {treatment!r} not in "
                f"{self.treatments}"
            )
        if visit and self.visits and visit not in self.visits:
            raise ValueError(
                f"{self.irb}: visit {visit!r} not in {self.visits}"
            )


# Study schemas transcribed from the reference GUI columns
# (Vent_Analysis.py:659-672) and its export filename grammar (961-984).
STUDY_PRESETS = {
    "genxe": StudyPreset(
        irb="genxe",
        id_field="genxe_id",
        id_label="General Xenon ID",
        # metadata['treatment'] values the GUI sets (Vent_Analysis.py:969-972)
        treatments=("preAlbuterol", "postAlbuterol",
                    "preSildenafil", "postSildenafil"),
        visits=(),
        extra_fields=("Disease",),  # Healthy/Asthma/CF/COPD/Other radio
    ),
    "mepo": StudyPreset(
        irb="mepo",
        id_field="mepo_id",
        id_label="Mepo ID",
        treatments=("preAlb", "postAlb"),
        visits=("1", "2", "3"),     # Baseline / 4-week / 12-week radios
        extra_fields=("mepo_subject_number",),
    ),
    "clinical": StudyPreset(
        irb="clinical",
        id_field="clinical_id",
        id_label="Clinical Subject Initials",
        # metadata['treatment'] is 'none' or 'Albuterol' in the reference
        # (Vent_Analysis.py:982-983); the filename grammar keys off
        # 'Albuterol' vs anything else ('baseline').
        treatments=("baseline", "Albuterol"),
        visits=(),                  # free-form visit number
        extra_fields=(),
    ),
}


def preset(name: str) -> StudyPreset:
    try:
        return STUDY_PRESETS[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown study preset {name!r}; available: {sorted(STUDY_PRESETS)}"
        ) from None
