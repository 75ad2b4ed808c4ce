"""Deployment self-check (`python -m ventjax doctor`).

The reference is a desktop script whose only health feedback is colored
prints inside the GUI loop (SURVEY.md §5 metrics/logging row:
Vent_Analysis.py:108-161, 714); a framework deployed unattended — cohort
batch runs, the watch-folder serve daemon — needs a machine-checkable
preflight instead.  `run_doctor` executes a battery of isolated checks
(one failure never masks the rest) and returns one JSON-serializable
report; the CLI exits 0 iff every REQUIRED check passed.

Required checks: versions, backend, device_probe, compile_cache,
codec_roundtrip, pipeline_selftest.  Optional (reported, never fatal):
native_scanner (the Python codec is a complete fallback), seg_checkpoint
(only `--auto-mask` needs it).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

#: |device VDP - oracle VDP| budget for the self-test, in percentage
#: points — the BASELINE.json fidelity envelope.
VDP_TOLERANCE_PP = 0.1


def _check(name: str, required: bool, fn: Callable[[], Dict]) -> Dict:
    t0 = time.perf_counter()
    try:
        info = fn() or {}
        ok = bool(info.pop("__ok__", True))
    except Exception as e:  # isolation: a crash is a failed check, not a crash
        info = {"error": f"{type(e).__name__}: {e}"}
        ok = False
    return {"name": name, "ok": ok, "required": required,
            "ms": round((time.perf_counter() - t0) * 1e3, 1), **info}


def _versions() -> Dict:
    import jax
    import numpy as np

    import ventjax

    return {"ventjax": ventjax.__version__, "jax": jax.__version__,
            "numpy": np.__version__}


def _backend() -> Dict:
    import jax

    return {"backend": jax.default_backend(),
            "devices": [str(d) for d in jax.devices()],
            "device_count": jax.device_count(),
            "process_count": jax.process_count()}


def _device_probe() -> Dict:
    """A trivial computation must round-trip the default device.  A runtime
    call blocked in native code would hang here with no error — run doctor
    under `timeout(1)` in watchdogs."""
    import jax.numpy as jnp
    import numpy as np

    got = int(np.asarray(jnp.arange(8).sum()))
    return {"__ok__": got == 28, "result": got}


def _compile_cache() -> Dict:
    from ventjax.utils.profiling import compile_cache_dir

    cache = compile_cache_dir()
    if cache is None:
        return {"dir": None, "disabled": True}
    os.makedirs(cache, exist_ok=True)
    # unique probe name: concurrent doctor runs (watchdogs overlap) must
    # not race on a shared create/remove
    fd, probe = tempfile.mkstemp(prefix=".doctor_probe", dir=cache)
    os.write(fd, b"ok")
    os.close(fd)
    os.remove(probe)
    return {"dir": cache, "writable": True,
            "entries": len(os.listdir(cache))}


def _native_scanner() -> Dict:
    from ventjax.io import native

    return {"available": native.available()}


def _seg_checkpoint() -> Dict:
    from ventjax.models.segmentation import default_checkpoint_path

    path = default_checkpoint_path()
    return {"path": path, "present": os.path.isdir(path)}


def _codec_roundtrip(tmp_dir: str) -> Dict:
    """DICOM write → read bit-equality through the Python codec (and the
    native scanner when present, via the cohort fast path's own parity
    tests — here just the codec the pipeline always has)."""
    import numpy as np

    from ventjax.io import synthetic
    from ventjax.io.dicom import open_single_dicom

    rng = np.random.default_rng(0)
    want = rng.integers(0, 4096, (16, 16, 8)).astype(np.float64)  # [H,W,D]
    path = os.path.join(tmp_dir, "doctor.dcm")
    synthetic.write_multiframe(path, want, vox=(1.5, 1.5, 10.0))
    _, vol = open_single_dicom(path)
    return {"__ok__": vol.shape == want.shape and (vol == want).all(),
            "shape": list(vol.shape)}


def _pipeline_selftest(full: bool) -> Dict:
    """Device pipeline vs the vendored CPU oracle on a phantom:
    |ΔVDP| < 0.1pp (the BASELINE fidelity budget).  `full` uses the
    flagship 128x128x16 geometry and includes CI; the quick form is a
    32x32x8 VDP-only pass."""
    import numpy as np

    from ventjax.compat import Vent_Analysis
    from ventjax.io.phantom import make_phantom
    from ventjax.oracle import reference as oracle
    from ventjax.oracle.n4_oracle import n4_bias_correction_oracle

    shape = (128, 128, 16) if full else (32, 32, 8)
    ph = make_phantom(shape=shape, vox=(1.5, 1.5, 10.0), seed=7)
    v = Vent_Analysis(xenon_array=ph.hp, mask_array=ph.mask)
    v.vox = [1.5, 1.5, 10.0]
    v.calculate_VDP()
    n4_o = n4_bias_correction_oracle(ph.hp, ph.mask)
    _, vdp_o = oracle.vdp_mean_anchored(n4_o, ph.mask)
    dvdp = abs(float(v.metadata["VDP"]) - float(vdp_o))
    out = {"__ok__": dvdp < VDP_TOLERANCE_PP,
           "shape": list(shape),
           "vdp": float(v.metadata["VDP"]), "vdp_oracle": float(vdp_o),
           "dvdp_pp": dvdp}
    if full:
        t0 = time.perf_counter()
        v.calculate_CI()
        out["ci"] = float(v.metadata["CI"])
        out["ci_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    return out


def run_doctor(full: bool = False, tmp_dir: Optional[str] = None) -> Dict:
    """Run every check; returns {"ok", "checks": [...]} (JSON-ready).

    `ok` covers only required checks — a missing native scanner or seg
    checkpoint degrades features but does not fail the install.
    """
    own_tmp = tmp_dir is None
    if own_tmp:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="ventjax_doctor_")
        tmp_dir = tmp_ctx.name
    try:
        checks: List[Dict] = [
            _check("versions", True, _versions),
            _check("backend", True, _backend),
            _check("device_probe", True, _device_probe),
            _check("compile_cache", True, _compile_cache),
            _check("native_scanner", False, _native_scanner),
            _check("seg_checkpoint", False, _seg_checkpoint),
            _check("codec_roundtrip", True,
                   lambda: _codec_roundtrip(tmp_dir)),
            _check("pipeline_selftest", True,
                   lambda: _pipeline_selftest(full)),
        ]
    finally:
        if own_tmp:
            tmp_ctx.cleanup()
    ok = all(c["ok"] for c in checks if c["required"])
    return {"ok": ok, "full": full, "checks": checks}


def format_report(report: Dict) -> str:
    return json.dumps(report, indent=2)
