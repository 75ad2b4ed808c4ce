"""Vendored CPU oracle: NumPy/SciPy re-statements of the reference formulas.

These functions replicate the *behavior* of /root/reference (including its
quirks, each documented at the definition site) and serve as the ground truth
for the device pipeline's unit tests (SURVEY.md §4).  They are deliberately
simple, slow, host-side code — the device path lives in ventjax.ops.
"""
from ventjax.oracle.reference import (
    normalize,
    calculate_border,
    crop_to_data,
    calculate_snr,
    vdp_mean_anchored,
    vdp_linear_binning,
    vdp_kmeans,
    build_4d_array,
)
from ventjax.oracle.ci_oracle import (
    sphere_pixels,
    calculate_ci_oracle,
)
from ventjax.oracle.n4_oracle import n4_bias_correction_oracle

__all__ = [
    "normalize",
    "calculate_border",
    "crop_to_data",
    "calculate_snr",
    "vdp_mean_anchored",
    "vdp_linear_binning",
    "vdp_kmeans",
    "build_4d_array",
    "sphere_pixels",
    "calculate_ci_oracle",
    "n4_bias_correction_oracle",
]
